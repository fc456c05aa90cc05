"""Canned anchor fixtures (parity: kod/test_utils/anchor_boxes.py:6-31, the
COCO-default VOC_BOXES_{LL,ML,HL} constants used across tests)."""

from object_detection_cib_torch.core.types import (
    AnchorBoxInfo,
    FeatureShape,
    LevelAnchors,
)

VOC_BOXES_LL = AnchorBoxInfo(
    stride=8,
    boxes_wh=[FeatureShape(10, 13), FeatureShape(16, 30), FeatureShape(33, 23)],
)
VOC_BOXES_ML = AnchorBoxInfo(
    stride=16,
    boxes_wh=[FeatureShape(30, 61), FeatureShape(62, 45), FeatureShape(59, 119)],
)
VOC_BOXES_HL = AnchorBoxInfo(
    stride=32,
    boxes_wh=[FeatureShape(116, 90), FeatureShape(156, 198), FeatureShape(373, 326)],
)


def voc_anchors() -> LevelAnchors:
    return LevelAnchors(ll=VOC_BOXES_LL, ml=VOC_BOXES_ML, hl=VOC_BOXES_HL)
