"""Fixtures for tests: the VOC anchor constants and a sample and batch from
the fake manifest. The port's copy of ``object_detection_cib_tpu/
test_utils``, over the port's own modules."""

from object_detection_cib_torch.test_utils.anchor_boxes import (
    VOC_BOXES_HL,
    VOC_BOXES_LL,
    VOC_BOXES_ML,
    voc_anchors,
)
from object_detection_cib_torch.test_utils.detection_sample import (
    get_test_batch,
    get_test_sample,
)
