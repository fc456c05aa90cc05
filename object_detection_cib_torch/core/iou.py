"""Elementwise IoU / GIoU / DIoU / CIoU on aligned box pairs + pairwise IoU.

Counterpart of ``object_detection_cib_tpu/core/iou.py`` (parity:
kod/core/bbox/iou.py:77-268), with the same semantics:
  * aligned variants operate on equal-shaped (..., 4) xyxy boxes
  * union uses ``inter`` subtraction, iou = inter / (union + eps)
  * GIoU penalty = |convex_area - union| / |convex_area + eps|
  * DIoU penalty = center_dist^2 / (convex_diag^2 + eps)
  * CIoU adds aspect-ratio term v with alpha = v / ((1-iou) + v + eps),
    detached from the graph (the reference's torch.no_grad, iou.py:241-242)
"""

from __future__ import annotations

import enum
import math
from functools import partial
from typing import Callable

import torch


@enum.unique
class IoUType(str, enum.Enum):
    iou = "iou"
    giou = "giou"
    diou = "diou"
    ciou = "ciou"


def _areas(x1, y1, x2, y2):
    return (x2 - x1) * (y2 - y1)


def _inter_union(b1: torch.Tensor, b2: torch.Tensor):
    x1, y1, x2, y2 = b1.unbind(-1)
    x1g, y1g, x2g, y2g = b2.unbind(-1)
    iw = (torch.minimum(x2, x2g) - torch.maximum(x1, x1g)).clamp(min=0)
    ih = (torch.minimum(y2, y2g) - torch.maximum(y1, y1g)).clamp(min=0)
    inter = iw * ih
    union = _areas(x1, y1, x2, y2) + _areas(x1g, y1g, x2g, y2g) - inter
    return inter, union


def _convex_wh(b1: torch.Tensor, b2: torch.Tensor):
    cw = torch.maximum(b1[..., 2], b2[..., 2]) - torch.minimum(b1[..., 0], b2[..., 0])
    ch = torch.maximum(b1[..., 3], b2[..., 3]) - torch.minimum(b1[..., 1], b2[..., 1])
    return cw, ch


def compute_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-7):
    """Aligned IoU on (..., 4) xyxy pairs -> (...,)."""
    inter, union = _inter_union(boxes1, boxes2)
    return inter / (union + eps)


def compute_giou(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-7):
    inter, union = _inter_union(boxes1, boxes2)
    iou = inter / (union + eps)
    cw, ch = _convex_wh(boxes1, boxes2)
    convex_area = cw * ch
    penalty = (convex_area - union).abs() / (convex_area + eps).abs()
    return iou - penalty


def _center_dist_sq_and_diag_sq(boxes1, boxes2, eps):
    cw, ch = _convex_wh(boxes1, boxes2)
    diag_sq = cw**2 + ch**2
    c1x = (boxes1[..., 0] + boxes1[..., 2]) * 0.5
    c1y = (boxes1[..., 1] + boxes1[..., 3]) * 0.5
    c2x = (boxes2[..., 0] + boxes2[..., 2]) * 0.5
    c2y = (boxes2[..., 1] + boxes2[..., 3]) * 0.5
    dist_sq = (c1x - c2x) ** 2 + (c1y - c2y) ** 2
    return dist_sq / (diag_sq + eps)


def compute_diou(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-7):
    inter, union = _inter_union(boxes1, boxes2)
    iou = inter / (union + eps)
    return iou - _center_dist_sq_and_diag_sq(boxes1, boxes2, eps)


def compute_ciou(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-7):
    inter, union = _inter_union(boxes1, boxes2)
    iou = inter / (union + eps)
    d = _center_dist_sq_and_diag_sq(boxes1, boxes2, eps)
    w1 = boxes1[..., 2] - boxes1[..., 0]
    h1 = boxes1[..., 3] - boxes1[..., 1]
    w2 = boxes2[..., 2] - boxes2[..., 0]
    h2 = boxes2[..., 3] - boxes2[..., 1]
    v = (4.0 / math.pi**2) * (
        torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))
    ) ** 2
    alpha = (v / ((1.0 - iou) + v + eps)).detach()
    return iou - d - alpha * v


def compute_iou_pairwise(
    bboxes1: torch.Tensor, bboxes2: torch.Tensor, eps: float = 1e-7
) -> torch.Tensor:
    """Unaligned pairwise IoU: (..., N, 4) x (..., M, 4) -> (..., N, M).

    Parity: compute_iou_unaligned (kod/core/bbox/iou.py:98-133). The greedy
    NMS mask (``ops/nms.py``) repeats this arithmetic op for op.
    """
    area1 = (bboxes1[..., 2] - bboxes1[..., 0]) * (bboxes1[..., 3] - bboxes1[..., 1])
    area2 = (bboxes2[..., 2] - bboxes2[..., 0]) * (bboxes2[..., 3] - bboxes2[..., 1])
    lt = torch.maximum(bboxes1[..., :, None, :2], bboxes2[..., None, :, :2])
    rb = torch.minimum(bboxes1[..., :, None, 2:], bboxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - overlap
    return overlap / (union + eps)


_IOU_FNS: dict = {
    IoUType.iou: compute_iou,
    IoUType.giou: compute_giou,
    IoUType.diou: compute_diou,
    IoUType.ciou: compute_ciou,
}


def get_iou_fn(iou_type: IoUType | str, eps: float = 1e-7) -> Callable:
    """Dispatcher matching IoUCalculator (kod/core/bbox/iou.py:249-268)."""
    return partial(_IOU_FNS[IoUType(iou_type)], eps=eps)
