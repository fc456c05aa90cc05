"""Host-side sample reading: decode + aspect-preserving resize (+letterbox).

A copy of ``object_detection_cib_tpu/data/reader.py`` (parity:
kod/data/sample_reader.py:16-136):
  * LongestMaxSize resize with bilinear interpolation (cv2)
  * optional letterbox PadIfNeeded to square with fill 114 (pad centered,
    albumentations semantics)
  * fake mode: random array of the manifest's recorded shape (lets the whole
    train loop run without the image corpus, ref sample_reader.py:46-55)
  * degenerate boxes (x_max<=x_min or y_max<=y_min) dropped
    (ref sample_reader.py:92-95)

Pillow and cv2 are imported inside the functions that use them, so the
modules that import this one (the device pipeline, the trainer) load on a
machine without them.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, NamedTuple, Sequence

import numpy as np

from object_detection_cib_torch.data.cache import SampleInfo, TargetInfo
from object_detection_cib_torch.utils.fs import get_root_dir


class AugmentedSample(NamedTuple):
    """image uint8 HWC, boxes (N,4) xyxy float32, labels (N,) int64.

    Parity: kod/data/types.py:8-11.
    """

    image: np.ndarray
    bboxes: np.ndarray
    labels: np.ndarray


def read_image(root_dir: Path, sample: SampleInfo, fake_mode: bool = False) -> np.ndarray:
    """The sample's RGB image, HWC uint8.

    In fake mode the pixels are drawn from a generator seeded by
    ``hash(sample.id)``. Python salts the hash of a ``str`` per process
    (``PYTHONHASHSEED``), so fake images agree only within one interpreter,
    as in the JAX package.
    """
    if fake_mode:
        rng = np.random.default_rng(abs(hash(sample.id)) % (2**31))
        return rng.integers(
            0,
            256,
            size=(sample.image_metadata.height, sample.image_metadata.width, 3),
            dtype=np.uint8,
        )
    from PIL import Image

    with Image.open(Path(root_dir) / sample.image_path) as img:
        return np.asarray(img.convert("RGB"))


def longest_max_size(
    image: np.ndarray, bboxes: np.ndarray, max_size: int
) -> tuple[np.ndarray, np.ndarray]:
    """Resize so max(h, w) == max_size, preserving aspect ratio (bilinear)."""
    h, w = image.shape[:2]
    scale = max_size / max(h, w)
    if scale != 1.0:
        import cv2

        new_w, new_h = int(round(w * scale)), int(round(h * scale))
        image = cv2.resize(image, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
        if len(bboxes):
            # albumentations LongestMaxSize scales by the same factor
            bboxes = bboxes * scale
    return image, bboxes


def letterbox_pad(
    image: np.ndarray, bboxes: np.ndarray, target: int, fill: int = 114
) -> tuple[np.ndarray, np.ndarray]:
    """Center-pad to (target, target) with constant fill (PadIfNeeded parity)."""
    h, w = image.shape[:2]
    pad_h, pad_w = target - h, target - w
    top, left = pad_h // 2, pad_w // 2
    out = np.full((target, target, image.shape[2]), fill, image.dtype)
    out[top : top + h, left : left + w] = image
    if len(bboxes):
        bboxes = bboxes + np.asarray([left, top, left, top], bboxes.dtype)
    return out, bboxes


class SampleReader:
    """Decode + resize one manifest sample (ref SampleReader, :63-136)."""

    def __init__(
        self,
        target_image_size: int,
        classes: Sequence[str],
        fake_mode: bool = False,
        root_dir: Path | None = None,
    ):
        self.root_dir = root_dir if root_dir is not None else get_root_dir()
        self.target_image_size = target_image_size
        self.fake_mode = fake_mode
        self.label_to_index = {c: i for i, c in enumerate(classes)}

    def _flatten_targets(
        self, targets: List[TargetInfo]
    ) -> tuple[np.ndarray, np.ndarray]:
        boxes, labels = [], []
        for t in targets:
            bb = t.bounding_box
            if bb.x_max <= bb.x_min or bb.y_max <= bb.y_min:
                continue  # degenerate (ref sample_reader.py:92-95)
            boxes.append([bb.x_min, bb.y_min, bb.x_max, bb.y_max])
            labels.append(self.label_to_index[t.class_name])
        return (
            np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(labels, np.int64),
        )

    def __call__(self, sample: SampleInfo, letter_box: bool = True) -> AugmentedSample:
        img = read_image(self.root_dir, sample, self.fake_mode)
        boxes, labels = self._flatten_targets(sample.targets)
        img, boxes = longest_max_size(img, boxes, self.target_image_size)
        if letter_box:
            img, boxes = letterbox_pad(img, boxes, self.target_image_size)
        return AugmentedSample(img, boxes, labels)
