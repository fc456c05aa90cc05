"""Dataset class filtering helper (parity: kod/data/filter.py:10-46 —
the standalone twin of DatasetInfo.filter)."""

from __future__ import annotations

from typing import List

from object_detection_cib_torch.data.cache import DatasetInfo


def filter_dataset(
    ds_info: DatasetInfo, new_name: str, classes_to_include: List[str]
) -> DatasetInfo:
    """Keep only the listed classes; drop samples left without targets."""
    return ds_info.filter(new_name, classes_to_include)
