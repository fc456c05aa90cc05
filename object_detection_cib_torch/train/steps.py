"""The eval step: forward (eval mode) -> decode -> NMS.

Counterpart of ``make_eval_step`` in ``object_detection_cib_tpu/train/steps.py``
(parity: kod/lightning/experiments/yv5_baseline/exp.py:140-154, conf 0.001 /
iou 0.6 at exp.py:45-46). The JAX step takes ``(params, batch_stats,
images)``; here the network module holds its weights, so the step takes the
images alone. ``train_step`` comes with the training slice.
"""

from __future__ import annotations

import torch

from object_detection_cib_torch.core.nms import NMSResult, non_max_suppression
from object_detection_cib_torch.core.types import LevelAnchors
from object_detection_cib_torch.eval.decode import decode_predictions


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
