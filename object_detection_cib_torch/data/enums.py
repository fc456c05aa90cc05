"""Dataset-name registry (parity: kod/data/enums.py:7-15)."""

from __future__ import annotations

import enum


@enum.unique
class DatasetName(str, enum.Enum):
    voc_combined = "voc-combined"
    voc_toy = "voc-toy"
    lvis = "lvis"
    coco128 = "coco128"
    coco_2017 = "coco-2017"
    coco_zipf = "coco-zipf"
    oi_zipf = "oi-zipf"
    synthetic_zipf = "synthetic-zipf"
    synthetic_zipf_hard = "synthetic-zipf-hard"
    fake = "fake"
