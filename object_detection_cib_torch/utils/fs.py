"""Filesystem layout helpers (parity: kod/utils/fs.py:7-56).

Env var KOD_DATA_ROOT_DIR overrides the data root (default: $HOME), so
datasets cached for the reference are found at the same paths.
"""

from __future__ import annotations

import os
from pathlib import Path


def get_root_dir() -> Path:
    root = os.environ.get("KOD_DATA_ROOT_DIR")
    return Path(root) if root else Path.home()


def get_kod_dir() -> Path:
    return get_root_dir() / "kod-data"


def _sub(name: str) -> Path:
    d = get_kod_dir() / name
    d.mkdir(parents=True, exist_ok=True)
    return d


def get_default_dataset_cache_dir() -> Path:
    return _sub("dataset-cache")


def get_default_datasets_dir() -> Path:
    return _sub("datasets")


def get_default_checkpoint_dir() -> Path:
    return _sub("checkpoints")


def get_default_tensorboard_dir() -> Path:
    return _sub("tb_logs")
