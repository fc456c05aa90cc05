"""Core shape / anchor metadata types (numpy only).

Counterpart of ``object_detection_cib_tpu/core/types.py``, kept as a copy so
the port imports nothing of the JAX package. Capability parity:
kod/core/types.py:6-8 (FeatureShape) and kod/core/anchors/info.py:9-11
(AnchorBoxInfo).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np


class FeatureShape(NamedTuple):
    """(width, height) of an image / feature map, in pixels or cells."""

    width: int
    height: int


class AnchorBoxInfo(NamedTuple):
    """Per-pyramid-level anchor spec: stride + list of anchor (w, h) pixels."""

    stride: int
    boxes_wh: Sequence[FeatureShape]

    def as_array(self) -> np.ndarray:
        """(A, 2) float32 array of anchor (w, h) in input-image pixels."""
        return np.asarray([(b.width, b.height) for b in self.boxes_wh], np.float32)


class LevelAnchors(NamedTuple):
    """Static anchor configuration for the three YOLOv5 pyramid levels.

    ``ll``/``ml``/``hl`` = low/mid/high level (strides 8/16/32 by default).
    """

    ll: AnchorBoxInfo
    ml: AnchorBoxInfo
    hl: AnchorBoxInfo

    @property
    def strides(self) -> Tuple[int, int, int]:
        return (self.ll.stride, self.ml.stride, self.hl.stride)

    def levels(self) -> Tuple[AnchorBoxInfo, AnchorBoxInfo, AnchorBoxInfo]:
        return (self.ll, self.ml, self.hl)


def default_anchors() -> LevelAnchors:
    """COCO-default YOLOv5 anchors (kod/configs/anchor_boxes/voc_s{8,16,32}.yaml)."""
    fs = FeatureShape
    return LevelAnchors(
        ll=AnchorBoxInfo(stride=8, boxes_wh=[fs(10, 13), fs(16, 30), fs(33, 23)]),
        ml=AnchorBoxInfo(stride=16, boxes_wh=[fs(30, 61), fs(62, 45), fs(59, 119)]),
        hl=AnchorBoxInfo(stride=32, boxes_wh=[fs(116, 90), fs(156, 198), fs(373, 326)]),
    )
