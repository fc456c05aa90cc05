"""Shared sample and batch fixtures (parity: kod/test_utils/detection_sample.py:
13-56, get_test_sample / get_batch). As in the JAX package, they come from the
fake manifest and the fake-mode reader, so tests need no image corpus."""

from __future__ import annotations

import torch

from object_detection_cib_torch.data.host_augment import ValidationSampleAugmentor
from object_detection_cib_torch.data.pipeline import DetectionDataset, collate_fixed, upload
from object_detection_cib_torch.data.reader import AugmentedSample, SampleReader
from object_detection_cib_torch.data.synthetic import build_fake_manifest
from object_detection_cib_torch.train.steps import Batch


def _dataset(image_size: int, num_classes: int, n: int, seed: int) -> DetectionDataset:
    info = build_fake_manifest(num_classes=num_classes, num_images=n, image_size=image_size, seed=seed)
    reader = SampleReader(image_size, info.classes, fake_mode=True)
    return DetectionDataset(info, reader, ValidationSampleAugmentor())


def get_test_sample(image_size: int = 416, num_classes: int = 10, seed: int = 0) -> AugmentedSample:
    """One letterboxed sample with targets (get_test_sample analog)."""
    return _dataset(image_size, num_classes, 4, seed)[0]


def get_test_batch(batch_size: int = 2, image_size: int = 416, num_classes: int = 10, max_targets: int = 40,
                   seed: int = 0) -> Batch:
    """A fixed-shape train ``Batch`` on the CPU (get_batch analog): f32
    images in [0, 1], as the JAX package's."""
    ds = _dataset(image_size, num_classes, max(batch_size, 4), seed)
    batch, _ = collate_fixed([ds[i] for i in range(batch_size)], max_targets)
    return upload(batch, torch.device("cpu"), torch.float32)
