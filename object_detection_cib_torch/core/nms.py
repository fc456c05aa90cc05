"""Batched non-max suppression with static shapes, on the device.

Counterpart of ``object_detection_cib_tpu/core/nms.py`` (parity:
kod/core/nms.py:9-75), with the same semantics:

  * conf gate: candidate iff obj_conf > conf_thres           (ref nms.py:37)
  * score:     conf = obj_conf * cls_conf                    (ref nms.py:41)
  * multi-label: when nc > 1 every (box, class) pair with score > conf_thres
    is an independent candidate                              (ref nms.py:46-48)
  * per-class NMS via the +class*4096 box-offset trick       (ref nms.py:66-69)
  * caps: top-`max_nms` pre-NMS, `max_det` post               (ref nms.py:24-26)

Two orderings decide which boxes survive when scores tie (common with bf16
heads), and both follow the JAX package exactly:

  * ``jax.lax.top_k`` puts the lower index first among equal scores;
    ``torch.topk`` promises no order, so the top ``max_nms`` come from a
    stable descending ``torch.sort``.
  * The compaction's ``jnp.argsort`` is stable; so is ``torch.argsort(...,
    stable=True)`` here.

Suppression is ``ops/nms.py:greedy_nms_mask``: the CUDA kernel for CUDA
tensors, its plain version for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from object_detection_cib_torch.ops.nms import greedy_nms_mask

_MAX_WH = 4096.0  # class-offset multiplier (ref nms.py:24)


class NMSResult(NamedTuple):
    boxes: torch.Tensor  # (B, max_det, 4) xyxy
    scores: torch.Tensor  # (B, max_det)
    classes: torch.Tensor  # (B, max_det) int32
    valid: torch.Tensor  # (B, max_det) bool
    num_valid: torch.Tensor  # (B,) int32


class NMSCandidates(NamedTuple):
    """The top ``max_nms`` candidates per image, in descending-score order."""

    scores: torch.Tensor  # (B, K), -1 for non-candidates
    classes: torch.Tensor  # (B, K) int64
    boxes: torch.Tensor  # (B, K, 4) xyxy
    offset_boxes: torch.Tensor  # (B, K, 4) boxes + class * 4096: the mask's input
    live: torch.Tensor  # (B, K) bool


def select_candidates(
    detections: torch.Tensor,
    conf_thres: float,
    classes: Optional[Sequence[int]] = None,
    max_nms: int = 2048,
    multi_label: Optional[bool] = None,
) -> NMSCandidates:
    """Conf gate, scoring, allow-list and top-``max_nms`` of ``non_max_suppression``."""
    B, N, D = detections.shape
    nc = D - 5
    dev = detections.device
    if multi_label is None:
        multi_label = nc > 1

    boxes = detections[..., :4]  # (B, N, 4)
    obj = detections[..., 4]  # (B, N)
    cls = detections[..., 5:]  # (B, N, nc)

    obj_ok = obj > conf_thres  # (B, N) confidence gate
    neg = torch.full((), -1.0, dtype=detections.dtype, device=dev)

    if multi_label:
        # scores (B, N, nc): conf = obj * cls; candidate iff score>thres & obj_ok
        scores = cls * obj[..., None]
        cand = (scores > conf_thres) & obj_ok[..., None]
        flat_scores = torch.where(cand, scores, neg).reshape(B, N * nc)
        class_ids = torch.arange(nc, dtype=torch.int64, device=dev).repeat(N)
        box_ids = torch.arange(N, dtype=torch.int64, device=dev).repeat_interleave(nc)
    else:
        # best class only (ref nms.py:50-51): conf = obj * max cls.
        # torch.argmax, like jnp.argmax, returns the first maximal index.
        best = torch.argmax(cls, dim=-1)  # (B, N)
        best_conf = torch.gather(cls, -1, best[..., None])[..., 0]
        scores = best_conf * obj
        cand = (scores > conf_thres) & obj_ok
        flat_scores = torch.where(cand, scores, neg)
        class_ids = best
        box_ids = torch.arange(N, dtype=torch.int64, device=dev)

    class_ids = class_ids.expand(B, -1)
    box_ids = box_ids.expand(B, -1)
    if classes is not None:
        allow = torch.zeros(nc, dtype=torch.bool, device=dev)
        allow[torch.as_tensor(list(classes), dtype=torch.int64, device=dev)] = True
        flat_scores = torch.where(allow[class_ids], flat_scores, neg)

    k = min(max_nms, flat_scores.shape[1])
    # stable descending sort == lax.top_k's order (lower index first on ties)
    sorted_scores, sorted_idx = torch.sort(flat_scores, dim=1, descending=True, stable=True)
    top_scores, top_idx = sorted_scores[:, :k], sorted_idx[:, :k]  # (B, K)
    top_class = torch.gather(class_ids, 1, top_idx)  # (B, K)
    top_box_id = torch.gather(box_ids, 1, top_idx)  # (B, K)
    top_boxes = torch.gather(boxes, 1, top_box_id[..., None].expand(B, k, 4))  # (B,K,4)

    # per-class offset so cross-class pairs never overlap (ref nms.py:66-69)
    offset_boxes = top_boxes + (top_class.to(torch.float32) * _MAX_WH)[..., None]
    return NMSCandidates(
        scores=top_scores,
        classes=top_class,
        boxes=top_boxes,
        offset_boxes=offset_boxes.contiguous(),
        live=(top_scores > 0.0).contiguous(),
    )


def non_max_suppression(
    detections: torch.Tensor,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    classes: Optional[Sequence[int]] = None,
    max_det: int = 300,
    max_nms: int = 2048,
    multi_label: Optional[bool] = None,
) -> NMSResult:
    """Batched NMS on raw decoded detections.

    Args:
      detections: (B, N, 5 + nc) f32 — xyxy, obj_conf, per-class conf (all
        sigmoided), as produced by ``eval/decode.py``.
      conf_thres / iou_thres: thresholds (ref defaults 0.25 / 0.45; the val
        loop uses 0.001 / 0.6 — kod/.../exp.py:45-46).
      classes: optional allow-list of class ids.
      max_det: max detections kept per image (ref nms.py:25).
      max_nms: candidate capacity fed to suppression: the top ``max_nms`` by
        score, lossless w.r.t. the final top-``max_det`` picks unless more
        than ``max_nms`` candidates beat them pre-NMS.
      multi_label: defaults to nc > 1 (ref nms.py:27).
    """
    cand = select_candidates(detections, conf_thres, classes, max_nms, multi_label)
    keep = greedy_nms_mask(cand.offset_boxes, cand.live, iou_thres)

    # compact kept detections to the front, cap at max_det
    kept_scores = torch.where(keep, cand.scores, torch.full_like(cand.scores, -1.0))
    order = torch.argsort(-kept_scores, dim=1, stable=True)[:, :max_det]  # stable desc
    out_scores = torch.gather(kept_scores, 1, order)
    out_boxes = torch.gather(cand.boxes, 1, order[..., None].expand(-1, -1, 4))
    out_class = torch.gather(cand.classes, 1, order).to(torch.int32)
    out_valid = out_scores > 0.0
    out_scores = torch.where(out_valid, out_scores, torch.zeros_like(out_scores))

    return NMSResult(
        boxes=out_boxes * out_valid[..., None],
        scores=out_scores,
        classes=torch.where(out_valid, out_class, torch.full_like(out_class, -1)),
        valid=out_valid,
        num_valid=out_valid.sum(dim=1).to(torch.int32),
    )
