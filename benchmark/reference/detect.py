"""Decode, candidate selection and greedy NMS in plain float32.

YOLOv5's validation post-processing as ``configs/model/yv5.yaml`` states it
and the measured program computes it: boxes ``(2 sigmoid(xy) - 0.5 +
cell) stride`` and ``(2 sigmoid(wh))^2 anchor``; every (box, class) pair
with ``obj * cls > conf`` and ``obj > conf`` is a candidate; the top
``max_nms`` by score (ties to the lower index); greedy NMS per class at
``iou``; the first ``max_det`` kept.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from reference.train import ANCHORS, STRIDES


class Decoded(NamedTuple):
    boxes: torch.Tensor  # (B, N, 4) xyxy pixels, N anchors over the levels
    obj: torch.Tensor  # (B, N)
    cls: torch.Tensor  # (B, N, nc)


def decode(heads: Sequence[torch.Tensor], nc: int, A: int = 3) -> Decoded:
    boxes, objs, clss = [], [], []
    for raw, anc, stride in zip(heads, ANCHORS, STRIDES):
        B, H, W, _ = raw.shape
        raw = raw.float()
        box = raw[..., :A * 4].reshape(B, H, W, A, 4)
        gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=raw.device),
                                torch.arange(W, dtype=torch.float32, device=raw.device), indexing="ij")
        grid = torch.stack([gx, gy], -1)[None, :, :, None, :]
        xy = (torch.sigmoid(box[..., 0:2]) * 2.0 - 0.5 + grid) * stride
        wh = (torch.sigmoid(box[..., 2:4]) * 2.0) ** 2 * torch.tensor(anc, dtype=torch.float32, device=raw.device)
        boxes.append(torch.cat([xy - wh / 2, xy + wh / 2], -1).reshape(B, -1, 4))
        objs.append(torch.sigmoid(raw[..., A * 4:A * 5]).reshape(B, -1))
        clss.append(torch.sigmoid(raw[..., A * 5:]).reshape(B, H * W * A, nc))
    return Decoded(torch.cat(boxes, 1), torch.cat(objs, 1), torch.cat(clss, 1))


def pair_iou(b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """(..., K, 4) -> (..., K, K) IoU."""
    x1, y1, x2, y2 = (b[..., i] for i in range(4))
    iw = (torch.minimum(x2[..., :, None], x2[..., None, :]) - torch.maximum(x1[..., :, None], x1[..., None, :])).clamp(min=0)
    ih = (torch.minimum(y2[..., :, None], y2[..., None, :]) - torch.maximum(y1[..., :, None], y1[..., None, :])).clamp(min=0)
    inter = iw * ih
    area = (x2 - x1) * (y2 - y1)
    return inter / (area[..., :, None] + area[..., None, :] - inter + eps)


class Detections(NamedTuple):
    boxes: torch.Tensor  # (B, max_det, 4)
    scores: torch.Tensor  # (B, max_det)
    classes: torch.Tensor  # (B, max_det), -1 where empty
    num: torch.Tensor  # (B,)


def nms(d: Decoded, conf: float, iou: float, max_det: int, max_nms: int) -> Detections:
    B, N, nc = d.cls.shape
    scores = d.cls * d.obj[..., None]
    cand = (scores > conf) & (d.obj > conf)[..., None]
    flat = torch.where(cand, scores, torch.full((), -1.0, device=scores.device)).reshape(B, N * nc)
    k = min(max_nms, flat.shape[1])
    top, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    cls = idx % nc
    boxes = torch.gather(d.boxes, 1, (idx // nc)[..., None].expand(B, k, 4))
    live = top > 0.0
    over = pair_iou(boxes + (cls.float() * 4096.0)[..., None]) > iou
    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    suppress = over & later
    keep = live
    for _ in range(k + 1):  # the greedy result is this iteration's fixpoint
        new = live & ~(suppress & keep[..., :, None]).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    kept = torch.where(keep, top, torch.full_like(top, -1.0))
    order = torch.argsort(-kept, dim=1, stable=True)[:, :max_det]
    s = torch.gather(kept, 1, order)
    valid = s > 0.0
    return Detections(torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)) * valid[..., None],
                      torch.where(valid, s, torch.zeros_like(s)),
                      torch.where(valid, torch.gather(cls, 1, order), torch.full_like(order, -1)), valid.sum(1))
