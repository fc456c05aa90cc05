"""Augmentation parameters (the recipe the device pipeline reads).

Copies of ``AffineParams``, ``HSVParams`` and ``AugParams`` from
``object_detection_cib_tpu/data/host_augment.py`` (ref
kod/data/augmentations/default.py:31-108). The host cv2/numpy pipeline of
that module waits for ROADMAP item A3.
"""

from __future__ import annotations

from typing import NamedTuple


class AffineParams(NamedTuple):
    """ref default.py:31-56 (+ no_aug constructor)."""

    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    perspective: float = 0.0

    def should_aug(self) -> bool:
        return any(
            v != 0.0
            for v in (self.degrees, self.translate, self.scale, self.shear,
                      self.perspective)
        )

    def axis_aligned(self) -> bool:
        """No rotation, shear or perspective: the warp is separable."""
        return self.degrees == 0.0 and self.shear == 0.0 and self.perspective == 0.0

    @staticmethod
    def no_aug() -> "AffineParams":
        return AffineParams(0.0, 0.0, 0.0, 0.0, 0.0)


class HSVParams(NamedTuple):
    """ref default.py:59-79."""

    hue: float = 0.015
    saturation: float = 0.7
    value: float = 0.4

    def should_aug(self) -> bool:
        return any(v != 0.0 for v in self)

    @staticmethod
    def no_aug() -> "HSVParams":
        return HSVParams(0.0, 0.0, 0.0)


class AugParams(NamedTuple):
    """ref default.py:82-108."""

    affine_params: AffineParams = AffineParams()
    hsv_params: HSVParams = HSVParams()
    flip_lr_prob: float = 0.5
    image_color_transforms: bool = False  # Blur/ToGray/CLAHE p=0.01 extras

    @staticmethod
    def no_aug() -> "AugParams":
        return AugParams(AffineParams.no_aug(), HSVParams.no_aug(), 0.0, False)
