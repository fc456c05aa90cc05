"""Composable per-augmentation pipeline (the reference's second augmentor).

A copy of ``object_detection_cib_tpu/data/augmentor.py`` (parity:
kod/data/augmentations/albu.py:19-162): an alternative to the monolithic
YOLOv5-style ``host_augment.TrainSampleAugmentor`` where each augmentation
is an object selected/parameterized from config
(``configs/data/augmentations/albu/``) and composed in order.

Each augmentation is a plain callable on ``AugmentedSample`` implemented
with the same cv2 primitives the host pipeline uses (host_augment.py), cv2
imported inside the call. Geometry-changing augs update boxes; color augs
don't. Like the reference's albu pipeline, there is no affine/crop stage —
use it with ``use_mosaic=False`` recipes (the mosaic canvas is 2Sx2S and
only the default augmentor's affine crops it to S).

Probabilities are drawn from a seeded np.random.Generator (rng threaded at
construction, like host_augment.TrainSampleAugmentor's seeded rng).
"""

from __future__ import annotations

from typing import Optional, Protocol, Sequence

import numpy as np

from object_detection_cib_torch.data.host_augment import (
    HSVParams,
    augment_hsv,
    horizontal_flip,
)
from object_detection_cib_torch.data.reader import AugmentedSample


class Augmentation(Protocol):
    """One composable augmentation (ref albu.py:19-21)."""

    def __call__(
        self, sample: AugmentedSample, rng: np.random.Generator
    ) -> AugmentedSample: ...


class BlurAugmentation:
    def __init__(self, p: float = 0.01):
        self.p = p

    def __call__(self, sample, rng):
        if rng.random() >= self.p:
            return sample
        import cv2

        k = int(rng.choice([3, 5, 7]))
        return sample._replace(image=cv2.blur(sample.image, (k, k)))


class MedianBlurAugmentation:
    def __init__(self, p: float = 0.01):
        self.p = p

    def __call__(self, sample, rng):
        if rng.random() >= self.p:
            return sample
        import cv2

        k = int(rng.choice([3, 5]))
        return sample._replace(image=cv2.medianBlur(sample.image, k))


class ToGrayAugmentation:
    def __init__(self, p: float = 0.01):
        self.p = p

    def __call__(self, sample, rng):
        if rng.random() >= self.p:
            return sample
        import cv2

        g = cv2.cvtColor(sample.image, cv2.COLOR_RGB2GRAY)
        return sample._replace(image=cv2.cvtColor(g, cv2.COLOR_GRAY2RGB))


class CLAHEAugmentation:
    def __init__(self, p: float = 0.01):
        self.p = p

    def __call__(self, sample, rng):
        if rng.random() >= self.p:
            return sample
        import cv2

        lab = cv2.cvtColor(sample.image, cv2.COLOR_RGB2LAB)
        clahe = cv2.createCLAHE(clipLimit=4.0, tileGridSize=(8, 8))
        lab[..., 0] = clahe.apply(lab[..., 0])
        return sample._replace(image=cv2.cvtColor(lab, cv2.COLOR_LAB2RGB))


class HSVAugmentation:
    def __init__(
        self,
        hue: float = 0.015,
        saturation: float = 0.7,
        value: float = 0.4,
        p: float = 0.5,
    ):
        self.hue, self.saturation, self.value = hue, saturation, value
        self.p = p

    def __call__(self, sample, rng):
        if rng.random() >= self.p:
            return sample
        img = augment_hsv(
            sample.image,
            HSVParams(hue=self.hue, saturation=self.saturation, value=self.value),
            rng,
        )
        return sample._replace(image=img)


class HorizontalFlipAugmentation:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, sample, rng):
        if rng.random() >= self.p:
            return sample
        return horizontal_flip(sample)


class TrainSampleAugmentor:
    """Composes a configured augmentation list (ref albu.py:122-162).

    Output stays uint8 HWC + pixel xyxy boxes; the collate stage does the
    ToFloat/255 conversion (the reference's ToFloat+ToTensorV2 analog).
    """

    def __init__(
        self,
        augmentations: Optional[Sequence[Augmentation]] = None,
        seed: int = 51,  # same default stream seed as the host augmentor
    ):
        self.augmentations = list(augmentations or [])
        self.rng = np.random.default_rng(seed)

    def __call__(self, sample: AugmentedSample, border=None) -> AugmentedSample:
        del border  # no affine stage in the composable pipeline
        for aug in self.augmentations:
            sample = aug(sample, self.rng)
        if len(sample.bboxes):
            # albumentations' bbox_params clips boxes to the image frame
            h, w = sample.image.shape[:2]
            b = sample.bboxes.copy()
            b[:, 0::2] = np.clip(b[:, 0::2], 0, w)
            b[:, 1::2] = np.clip(b[:, 1::2], 0, h)
            sample = sample._replace(bboxes=b)
        return sample
