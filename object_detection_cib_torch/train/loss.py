"""YOLOv5 composite loss (CIoU box + BCE objectness + BCE classification).

Counterpart of ``object_detection_cib_tpu/train/loss.py`` (parity:
kod/lightning/experiments/yv5_baseline/loss.py:25-248), as masked
fixed-shape computation:

  * box decode at matched cells: xy = sigmoid*2-0.5, wh = (sigmoid*2)^2*anchor
  * localization: (1 - CIoU) masked mean over valid slots
  * objectness: BCE mean over the full map with target = detached clamped
    IoU at matched cells, per-level weights 4.0/1.0/0.4, computed by the
    identity mean BCE = [sum softplus(x) - sum_matched t*x] / N (one gather,
    no scatter); duplicate (cell, anchor) matches sum their corrections, as
    the JAX package does (PARITY.md)
  * classification: one-hot BCE with optional per-class pos_weight
  * dynamic lambdas: obj by (img/640)^2, cls by nc/80

Losses are f32 whatever the network's compute dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from object_detection_cib_torch.core.assigner import Assignment, LevelAssignment
from object_detection_cib_torch.core.boxes import cxcywh_to_xyxy
from object_detection_cib_torch.core.iou import IoUType, get_iou_fn
from object_detection_cib_torch.core.types import FeatureShape
from object_detection_cib_torch.models.yolov5 import DetectionHeadResult, Yolov5NetworkResult


class LossParams(NamedTuple):
    """ref Yolov5LossParams defaults (loss.py:34-43)."""

    lambda_classification: float = 0.5
    lambda_localization: float = 0.05
    lambda_objectness: float = 1.0
    lambda_ll_objectness: float = 4.0
    lambda_ml_objectness: float = 1.0
    lambda_hl_objectness: float = 0.4
    iou_type: str = "ciou"
    eps: float = 1e-7


class LossResult(NamedTuple):
    localization: torch.Tensor
    objectness: torch.Tensor
    classification: torch.Tensor

    @property
    def total(self) -> torch.Tensor:
        return self.localization + self.objectness + self.classification


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros_like(x))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Elementwise BCE-with-logits: pw * t * softplus(-x) + (1 - t) * softplus(x)."""
    pos = softplus(-logits)
    neg = softplus(logits)
    if pos_weight is not None:
        pos = pos * pos_weight
    return targets * pos + (1.0 - targets) * neg


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    cnt = mask.sum().clamp(min=1.0)
    return (x * mask).sum() / cnt


def _level_losses(
    head: DetectionHeadResult,
    assign: LevelAssignment,
    iou_fn,
    class_weights: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loc_loss, obj_loss_unweighted, cls_loss) for one level.

    One row-gather of the flat (B, H, W, A*(5+nc)) head map at the matched
    cells in its own dtype; the anchor is picked by an exact one-hot
    multiply-sum over A, and box/obj/cls are sliced from the gathered rows.
    """
    raw = head.raw
    A, nc = head.num_anchors, head.num_classes
    B, H, W, _ = raw.shape
    valid = assign.valid.float()
    K = assign.sample_idx.shape[0]
    rows = raw[assign.sample_idx, assign.grid_y, assign.grid_x]  # (K, A*(5+nc))
    sel = F.one_hot(assign.anchor_idx, A).to(rows.dtype)  # (K, A) exact 0/1

    def pick(x):  # (K, A, C) -> (K, C) f32
        return (x * sel[:, :, None]).sum(1).float()

    # localization (ref loss.py:65-98)
    p = pick(rows[:, : A * 4].reshape(K, A, 4))
    pred_xy = torch.sigmoid(p[:, 0:2]) * 2.0 - 0.5
    pred_wh = (torch.sigmoid(p[:, 2:4]) * 2.0) ** 2 * assign.anchors_wh
    pred_xyxy = cxcywh_to_xyxy(torch.cat([pred_xy, pred_wh], -1))
    gt_xyxy = cxcywh_to_xyxy(assign.txywh)
    iou = iou_fn(pred_xyxy, gt_xyxy)
    loc_loss = _masked_mean(1.0 - iou, valid)

    # objectness (ref loss.py:100-126) by the gather identity
    iou_t = iou.clamp(min=0.0).detach()
    obj_map = raw[..., A * 4 : A * 5]
    matched_x = (rows[:, A * 4 : A * 5] * sel).sum(1).float()
    n_cells = B * H * W * A
    obj_loss = (softplus(obj_map.float()).sum() - (iou_t * matched_x * valid).sum()) / n_cells

    # classification (ref loss.py:128-164)
    pc = pick(rows[:, A * 5 :].reshape(K, A, nc))
    one_hot = F.one_hot(assign.labels, nc).float()
    cls_el = bce_with_logits(pc, one_hot, pos_weight=class_weights)
    cls_loss = (cls_el * valid[:, None]).sum() / (valid.sum() * nc).clamp(min=1.0)
    return loc_loss, obj_loss, cls_loss


def yolov5_loss(
    net_result: Yolov5NetworkResult,
    assignment: Assignment,
    image_shape: FeatureShape,
    params: LossParams = LossParams(),
    class_weights: Optional[torch.Tensor] = None,
) -> LossResult:
    """Three-level loss; ``class_weights`` (nc,) is the per-class BCE
    pos_weight of loss reweighing (ref tasks/trainer.py:54-60)."""
    iou_fn = get_iou_fn(IoUType(params.iou_type), eps=params.eps)
    level_obj_w = (params.lambda_ll_objectness, params.lambda_ml_objectness,
                   params.lambda_hl_objectness)
    loc = obj = cls = 0.0
    for head, assign, w in zip(net_result.levels(), assignment.levels(), level_obj_w):
        lo, ob, cl = _level_losses(head, assign, iou_fn, class_weights)
        loc = loc + lo
        obj = obj + w * ob
        cls = cls + cl
    nc = net_result.ll.num_classes
    lambda_obj = params.lambda_objectness * (image_shape.width / 640.0) ** 2
    lambda_cls = params.lambda_classification * (nc / 80.0)
    return LossResult(
        localization=params.lambda_localization * loc,
        objectness=lambda_obj * obj,
        classification=lambda_cls * cls,
    )
