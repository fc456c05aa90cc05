"""Inference-side prediction decode: head outputs -> (B, N, 4+1+nc).

Counterpart of ``object_detection_cib_tpu/eval/decode.py`` (parity:
kod/lightning/experiments/yv5_baseline/layers.py:15-155). Per level:
            xy = (sigmoid*2 - 0.5 + grid) * stride
            wh = (sigmoid*2)^2 * anchor_px          (ref layers.py:55-63)
then cxcywh -> xyxy, obj/cls sigmoid, flatten and concat all levels. The
flattening order is (H, W, A) per level, as in the JAX package: the top-k
candidate order, and so NMS tie-breaks, depend on it.
"""

from __future__ import annotations

import torch

from object_detection_cib_torch.core.boxes import cxcywh_to_xyxy
from object_detection_cib_torch.core.types import LevelAnchors
from object_detection_cib_torch.models.yolov5 import (
    DetectionHeadResult,
    Yolov5NetworkResult,
)


def _decode_level(
    head: DetectionHeadResult, anchors_px: torch.Tensor, stride: int
) -> torch.Tensor:
    box = head.box.to(torch.float32)
    B, H, W, A, _ = box.shape
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=box.device),
        torch.arange(W, dtype=torch.float32, device=box.device),
        indexing="ij",
    )
    grid = torch.stack([gx, gy], dim=-1)[None, :, :, None, :]  # (1,H,W,1,2)

    xy = (torch.sigmoid(box[..., 0:2]) * 2.0 - 0.5 + grid) * stride
    wh = (torch.sigmoid(box[..., 2:4]) * 2.0) ** 2 * anchors_px
    xyxy = cxcywh_to_xyxy(torch.cat([xy, wh], dim=-1))

    obj = torch.sigmoid(head.obj.to(torch.float32))
    cls = torch.sigmoid(head.cls.to(torch.float32))

    n = H * W * A
    return torch.cat(
        [xyxy.reshape(B, n, 4), obj.reshape(B, n, 1), cls.reshape(B, n, -1)], dim=-1
    )


def decode_predictions(
    net_result: Yolov5NetworkResult, anchors: LevelAnchors
) -> torch.Tensor:
    """(B, sum_l H_l*W_l*A, 4+1+nc) decoded detections in input-image pixels."""
    outs = []
    for head, info in zip(net_result.levels(), anchors.levels()):
        anchors_px = torch.from_numpy(info.as_array())
        if head.raw.is_cuda:
            # pinned + non_blocking: a pageable copy would wait for the stream
            anchors_px = anchors_px.pin_memory()
        anchors_px = anchors_px.to(head.raw.device, non_blocking=True)
        outs.append(_decode_level(head, anchors_px, info.stride))
    return torch.cat(outs, dim=1)
