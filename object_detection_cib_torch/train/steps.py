"""The train step (forward -> assign -> loss -> backward -> SmartSGD) and the
eval step (forward -> decode -> NMS).

Counterpart of ``object_detection_cib_tpu/train/steps.py`` (parity:
kod/lightning/experiments/yv5_baseline/exp.py):
  * training_step (exp.py:104-138): forward(train) -> assign (wh-ratio gate
    ``assign_threshold``, ``assign_offset_capacity`` slots per anchor) ->
    compact the assignment to ``assign_compact_slots * B`` slots per level
    (``None`` or 0: no compaction) -> loss ->
    total = B * (box + obj + cls) -> backward -> SmartSGD; BatchNorm running
    statistics move in the forward;
  * validation_step (exp.py:140-154): forward(eval) -> decode -> NMS
    (conf 0.001 / iou 0.6, exp.py:45-46).
The JAX steps take ``(params, batch_stats, ...)``; here the network module
holds its weights, so the train step takes a batch and the eval step the
images. Not carried: jit/mesh sharding, ``remat_policy`` (XLA
rematerialisation) and ``head_sharding`` (GSPMD), which have no
counterpart in an eager single-card step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from object_detection_cib_torch.core.assigner import (
    THRESHOLD,
    Assignment,
    assign_targets,
    compact_level_assignment,
)
from object_detection_cib_torch.core.nms import NMSResult, non_max_suppression
from object_detection_cib_torch.core.types import FeatureShape, LevelAnchors
from object_detection_cib_torch.eval.decode import decode_predictions
from object_detection_cib_torch.train.loss import LossParams, yolov5_loss
from object_detection_cib_torch.train.optim import SmartSGD


class Batch(NamedTuple):
    """Fixed-shape detection batch: targets padded to capacity T with a mask."""

    images: torch.Tensor  # (B, H, W, 3) in [0, 1], feed dtype
    boxes: torch.Tensor  # (B, T, 4) xyxy pixels
    labels: torch.Tensor  # (B, T) int
    mask: torch.Tensor  # (B, T) bool


class StepMetrics(NamedTuple):
    """One train step's losses and lr (0-d f32 tensors, left on the device).

    The fields are in the JAX package's leaf order, which is the row order
    of the fused epoch's stacked metric matrix."""

    total: torch.Tensor
    box: torch.Tensor
    obj: torch.Tensor
    cls: torch.Tensor
    lr: torch.Tensor  # the step's lr_other
    # valid assignment slots dropped by the compaction (0 = exact)
    assign_drop: torch.Tensor


def make_train_step(
    net: torch.nn.Module,
    anchors: LevelAnchors,
    image_shape: FeatureShape,
    optimizer: SmartSGD,
    loss_params: LossParams = LossParams(),
    class_weights: Optional[torch.Tensor] = None,
    assign_threshold: float = THRESHOLD,
    assign_offset_capacity: int = 3,
    assign_compact_slots: Optional[int] = 128,
):
    """Build ``train_step(batch, hp=None) -> StepMetrics``, which updates
    ``net`` in place with the hyperparameter row ``hp`` (``SmartSGD.step``).

    The assigner knobs and their defaults are the JAX ``make_train_step``'s
    (``model.assign_compact_slots`` and ``configs/assigners/yv5.yaml``).

    The step makes no host-device synchronisation: its losses stay on the
    device, and the anchors are copied to the device once. So it can be
    captured in a CUDA graph (the fused epoch).
    """
    dev = next(net.parameters()).device
    anchor_tensors = [torch.as_tensor(info.as_array()).to(dev) for info in anchors.levels()]

    def train_step(batch: Batch, hp: Optional[torch.Tensor] = None) -> StepMetrics:
        net.train()
        out = net(batch.images)
        assignment = assign_targets(batch.boxes, batch.labels, batch.mask, image_shape,
                                    anchors, anchor_tensors, assign_threshold, assign_offset_capacity)
        assign_drop = torch.zeros((), dtype=torch.int64, device=batch.boxes.device)
        if assign_compact_slots:
            cap = assign_compact_slots * batch.images.shape[0]
            for lv in assignment.levels():
                n_valid = lv.valid.sum()
                assign_drop = assign_drop + (n_valid - min(cap, int(lv.valid.shape[0]))).clamp(min=0)
            assignment = Assignment(*(compact_level_assignment(lv, cap) for lv in assignment.levels()))
        lres = yolov5_loss(out, assignment, image_shape, loss_params, class_weights)
        total = batch.images.shape[0] * lres.total  # ref exp.py:126-130
        optimizer.zero_grad()
        total.backward()
        lr_other = optimizer.step(hp)
        return StepMetrics(
            total=total.detach(),
            box=lres.localization.detach(),
            obj=lres.objectness.detach(),
            cls=lres.classification.detach(),
            lr=lr_other,
            assign_drop=assign_drop,
        )

    return train_step


def make_eval_step(
    net: torch.nn.Module,
    anchors: LevelAnchors,
    conf_thres: float = 0.001,  # ref exp.py:45
    iou_thres: float = 0.6,  # ref exp.py:46
    max_det: int = 300,
    max_nms: int = 2048,
):
    """Build ``eval_step(images) -> NMSResult`` for (B, H, W, 3) images in [0, 1].

    The step runs the network in eval mode (running BN statistics) under
    ``torch.inference_mode`` and restores the module's mode afterwards.
    """

    @torch.inference_mode()
    def eval_step(images: torch.Tensor) -> NMSResult:
        was_training = net.training
        net.eval()
        try:
            out = net(images)
        finally:
            net.train(was_training)
        det = decode_predictions(out, anchors)
        return non_max_suppression(
            det,
            conf_thres=conf_thres,
            iou_thres=iou_thres,
            max_det=max_det,
            max_nms=max_nms,
        )

    return eval_step
