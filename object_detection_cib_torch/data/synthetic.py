"""Synthetic dataset builder: colored-shape detection corpora.

A copy of ``object_detection_cib_tpu/data/synthetic.py``: the same numpy
draws from the same seed give the same manifest and, through Pillow, the
same JPEG bytes. Role: the offline dataset-builder capability (parity
target: kod/data/builder.py, which needs FiftyOne+MongoDB+network):

  * `build_synthetic_dataset` — images of colored shapes on noise or
    textured backgrounds, with a Zipf-like long-tailed class distribution
    (the coco-zipf analog, ref builder.py:110-116,233-284) — real JPEGs on
    disk + a manifest, for end-to-end train/eval from files
  * `build_fake_manifest` — manifest-only dataset for fake-mode runs
    (the SampleReader(fake_mode=True) path, ref sample_reader.py:46-55)

Pillow is imported inside `build_synthetic_dataset`.
"""

from __future__ import annotations

from datetime import datetime
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from object_detection_cib_torch.data.cache import (
    DatasetInfo,
    ImageMetadata,
    SampleInfo,
    TargetInfo,
    XYXYBox,
)

_PALETTE = np.asarray(
    [
        (220, 40, 40), (40, 220, 40), (40, 40, 220), (220, 220, 40),
        (220, 40, 220), (40, 220, 220), (250, 130, 20), (130, 20, 250),
        (20, 250, 130), (160, 160, 160),
    ],
    np.uint8,
)


def zipf_counts(num_classes: int, n_total: int, a: float = 1.01) -> np.ndarray:
    """Long-tailed per-class instance budget (ref builder.py:110-116)."""
    ranks = np.arange(1, num_classes + 1, dtype=np.float64)
    pmf = ranks**-a
    pmf /= pmf.sum()
    return np.maximum((pmf * n_total).astype(int), 1)


def _draw_shape(img: np.ndarray, cls: int, box: Sequence[int], rng) -> None:
    x1, y1, x2, y2 = box
    color = _PALETTE[cls % len(_PALETTE)].astype(np.int32)
    jitter = rng.integers(-25, 25, 3)
    color = np.clip(color + jitter, 0, 255).astype(np.uint8)
    if cls % 2 == 0:
        img[y1:y2, x1:x2] = color
    else:  # ellipse
        h, w = y2 - y1, x2 - x1
        yy, xx = np.mgrid[0:h, 0:w]
        m = ((yy - h / 2) / (h / 2 + 1e-6)) ** 2 + (
            (xx - w / 2) / (w / 2 + 1e-6)
        ) ** 2 <= 1.0
        img[y1:y2, x1:x2][m] = color


def _shape_mask(kind: int, h: int, w: int) -> np.ndarray:
    """Boolean mask for one of 5 shape families."""
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ny = (yy - cy) / (h / 2.0 + 1e-6)
    nx = (xx - cx) / (w / 2.0 + 1e-6)
    if kind == 0:  # rectangle
        return np.ones((h, w), bool)
    if kind == 1:  # ellipse
        return ny**2 + nx**2 <= 1.0
    if kind == 2:  # triangle (apex up)
        return (yy >= 0) & (np.abs(nx) <= (yy + 1) / max(h, 1))
    if kind == 3:  # diamond
        return np.abs(ny) + np.abs(nx) <= 1.0
    # ring
    r2 = ny**2 + nx**2
    return (r2 <= 1.0) & (r2 >= 0.45)


def _draw_hard_shape(img: np.ndarray, cls: int, box: Sequence[int], rng) -> None:
    """Class = (shape family x stripe orientation); color is RANDOM per
    instance, so color carries no class signal — the model must learn
    shape+texture. This makes the corpus hard enough for augmentation
    effects (mosaic/mixup) to show in final mAP instead of saturating."""
    x1, y1, x2, y2 = box
    h, w = y2 - y1, x2 - x1
    m = _shape_mask(cls % 5, h, w)
    color = rng.integers(40, 255, 3)
    color2 = np.clip(color + rng.integers(60, 120) * rng.choice((-1, 1)), 0, 255)
    yy, xx = np.mgrid[0:h, 0:w]
    period = max(3, min(h, w) // 4)
    stripes = ((yy if cls % 10 < 5 else xx) // period) % 2 == 0
    region = img[y1:y2, x1:x2]
    region[m & stripes] = color
    region[m & ~stripes] = color2


def build_synthetic_dataset(
    out_dir: Path,
    name: str = "synthetic-zipf",
    num_classes: int = 10,
    num_images: int = 200,
    image_size: int = 320,
    max_objects: int = 6,
    zipf_a: float = 1.01,
    seed: int = 0,
    path_prefix: str = "",
    hard: Optional[bool] = None,
) -> DatasetInfo:
    """Generate JPEGs + manifest with a Zipf long-tail over classes.

    `path_prefix` prepends recorded image paths so manifests resolve from a
    data root different from `out_dir` (e.g. KOD_DATA_ROOT_DIR).

    hard (default: "hard" in `name`): color carries no class signal (class =
    shape family x stripe orientation, random colors), objects are smaller
    with occlusion, and the background is textured clutter; train splits
    draw large objects only, splits whose name holds "val" the full range.
    """
    from PIL import Image

    if hard is None:
        hard = "hard" in name
    out_dir = Path(out_dir)
    img_dir = out_dir / name
    img_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    classes = [f"class_{i}" for i in range(num_classes)]

    # per-instance class distribution ~ zipf
    pmf = zipf_counts(num_classes, 10_000, zipf_a).astype(np.float64)
    pmf /= pmf.sum()

    samples: List[SampleInfo] = []
    for i in range(num_images):
        if hard:
            # textured background: upsampled low-res noise + clutter blobs
            low = rng.integers(60, 190, (8, 8, 3)).astype(np.uint8)
            img = np.asarray(
                Image.fromarray(low).resize((image_size, image_size))
            ).copy()
            for _ in range(int(rng.integers(2, 6))):
                cw = int(rng.integers(image_size // 16, image_size // 6))
                cx = int(rng.integers(0, image_size - cw))
                cy = int(rng.integers(0, image_size - cw))
                img[cy : cy + cw, cx : cx + cw] = rng.integers(40, 255, 3)
        else:
            img = rng.integers(90, 140, (image_size, image_size, 3)).astype(
                np.uint8
            )
        n_obj = int(rng.integers(1, max_objects + 1))
        targets: List[TargetInfo] = []
        for _ in range(n_obj):
            cls = int(rng.choice(num_classes, p=pmf))
            if hard:
                # scale-shifted splits: train draws large objects only, val
                # draws the full scale range
                if "val" in name:
                    lo, hi = image_size // 12, image_size // 2
                else:
                    lo, hi = image_size // 3, image_size // 2
                w = int(rng.integers(lo, hi))
                h = int(rng.integers(lo, hi))
            else:
                w = int(rng.integers(image_size // 8, image_size // 2))
                h = int(rng.integers(image_size // 8, image_size // 2))
            x1 = int(rng.integers(0, image_size - w))
            y1 = int(rng.integers(0, image_size - h))
            box = (x1, y1, x1 + w, y1 + h)
            (_draw_hard_shape if hard else _draw_shape)(img, cls, box, rng)
            targets.append(
                TargetInfo(
                    bounding_box=XYXYBox(*[float(v) for v in box]),
                    class_name=classes[cls],
                )
            )
        rel = f"{name}/img_{i:05d}.jpg"
        Image.fromarray(img).save(out_dir / rel, quality=92)
        if path_prefix:
            rel = f"{path_prefix}/{rel}"
        samples.append(
            SampleInfo(
                id=f"syn-{i}",
                image_path=rel,
                image_metadata=ImageMetadata(
                    width=image_size,
                    height=image_size,
                    num_channels=3,
                    mime_type="image/jpeg",
                    size_bytes=0,
                ),
                targets=targets,
            )
        )
    return DatasetInfo(
        name=name, date=datetime.now(), classes=classes, samples=samples
    )


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
