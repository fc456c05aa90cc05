"""Bounding-box coordinate conversions on tensors of any batch shape.

Counterpart of ``object_detection_cib_tpu/core/boxes.py`` (parity:
kod/core/bbox/boxes.py cxcywh<->xyxy converters and scaling).
"""

from __future__ import annotations

import torch


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) [cx, cy, w, h] -> [x1, y1, x2, y2]."""
    cx, cy, w, h = boxes.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) [x1, y1, x2, y2] -> [cx, cy, w, h]."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], dim=-1)


def scale_boxes(boxes: torch.Tensor, x_factor, y_factor) -> torch.Tensor:
    """Scale x coords by ``x_factor`` and y coords by ``y_factor``.

    Works for both xyxy and cxcywh layouts (both store x at dims 0,2 and y at
    dims 1,3).
    """
    fac = torch.tensor(
        [x_factor, y_factor, x_factor, y_factor], dtype=boxes.dtype, device=boxes.device
    )
    return boxes * fac


def box_area(boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> (...,) area."""
    return (boxes_xyxy[..., 2] - boxes_xyxy[..., 0]) * (
        boxes_xyxy[..., 3] - boxes_xyxy[..., 1]
    )
