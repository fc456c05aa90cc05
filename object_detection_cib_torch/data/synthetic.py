"""Manifest-only fake datasets with a Zipf long tail over classes.

Copies of ``zipf_counts`` and ``build_fake_manifest`` from
``object_detection_cib_tpu/data/synthetic.py``: the same numpy draws from the
same seed give the same manifest. The JPEG-writing synthetic corpus builder
comes with the data slice.
"""

from __future__ import annotations

from datetime import datetime
from typing import List, Optional

import numpy as np

from object_detection_cib_torch.data.cache import (
    DatasetInfo,
    ImageMetadata,
    SampleInfo,
    TargetInfo,
    XYXYBox,
)


def zipf_counts(num_classes: int, n_total: int, a: float = 1.01) -> np.ndarray:
    """Long-tailed per-class instance budget (ref builder.py:110-116)."""
    ranks = np.arange(1, num_classes + 1, dtype=np.float64)
    pmf = ranks**-a
    pmf /= pmf.sum()
    return np.maximum((pmf * n_total).astype(int), 1)


def build_fake_manifest(
    name: str = "fake",
    num_classes: int = 5,
    num_images: int = 64,
    image_size: int = 320,
    max_objects: int = 5,
    seed: int = 0,
    zipf_a: Optional[float] = None,
) -> DatasetInfo:
    """Manifest-only dataset for fake-mode runs (no image files)."""
    rng = np.random.default_rng(seed)
    classes = [f"class_{i}" for i in range(num_classes)]
    if zipf_a is not None:
        pmf = zipf_counts(num_classes, 10_000, zipf_a).astype(np.float64)
        pmf /= pmf.sum()
    else:
        pmf = np.full(num_classes, 1.0 / num_classes)

    samples: List[SampleInfo] = []
    for i in range(num_images):
        w_img = int(rng.integers(image_size // 2, image_size * 2))
        h_img = int(rng.integers(image_size // 2, image_size * 2))
        targets: List[TargetInfo] = []
        for _ in range(int(rng.integers(1, max_objects + 1))):
            cls = int(rng.choice(num_classes, p=pmf))
            w = int(rng.integers(max(w_img // 8, 2), max(w_img // 2, 3)))
            h = int(rng.integers(max(h_img // 8, 2), max(h_img // 2, 3)))
            x1 = int(rng.integers(0, max(w_img - w, 1)))
            y1 = int(rng.integers(0, max(h_img - h, 1)))
            targets.append(
                TargetInfo(
                    bounding_box=XYXYBox(
                        float(x1), float(y1), float(x1 + w), float(y1 + h)
                    ),
                    class_name=classes[cls],
                )
            )
        samples.append(
            SampleInfo(
                id=f"fake-{i}",
                image_path=f"fake/img_{i:05d}.jpg",
                image_metadata=ImageMetadata(
                    width=w_img, height=h_img, num_channels=3,
                    mime_type="image/jpeg", size_bytes=0,
                ),
                targets=targets,
            )
        )
    return DatasetInfo(
        name=name, date=datetime.now(), classes=classes, samples=samples
    )
