"""Host-side (numpy/cv2) augmentation pipeline, and the augmentation recipe.

A copy of ``object_detection_cib_tpu/data/host_augment.py``; the same seed
gives the same arrays. Capability parity:
  * mosaic          — kod/data/mosaic.py:11-161 (4-image 2Sx2S canvas, fill
    114, random center in [S/2, 3S/2], per-quadrant placement, box clip +
    candidate filter)
  * affine/perspective — kod/data/augmentations/default.py:110-351
    (M = T@S@R@P@C, warp with border 114, 4-corner box transform, clip,
    candidate filter with pre-boxes scaled by `scale`)
  * HSV jitter      — default.py:354-383 (uint8 LUTs: hue mod 180, sat/val
    clipped)
  * horizontal flip — default.py:386-397 (uses width-1 mirror)
  * mixup           — default.py:400-408 (beta(32,32) blend, label concat)
  * TrainSampleAugmentor chain — default.py:411-488

``AffineParams``, ``HSVParams`` and ``AugParams`` are the recipe the device
pipeline reads too (``AffineParams.axis_aligned`` is the port's). The host
functions feed the host pipeline (``data/pipeline.py``); cv2 is imported
inside them, so the device pipeline imports this module on a machine
without cv2.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

from object_detection_cib_torch.data.reader import AugmentedSample

FILL = 114


def box_candidates(
    orig_bboxes: np.ndarray,
    proc_bboxes: np.ndarray,
    wh_threshold: float = 2.0,
    aspect_ratio_threshold: float = 20.0,
    area_thr: float = 0.1,
    eps: float = 1e-16,
) -> np.ndarray:
    """Validity of boxes after a geometric transform (boxes given (4, N))."""
    w1, h1 = orig_bboxes[2] - orig_bboxes[0], orig_bboxes[3] - orig_bboxes[1]
    w2, h2 = proc_bboxes[2] - proc_bboxes[0], proc_bboxes[3] - proc_bboxes[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (
        (w2 > wh_threshold)
        & (h2 > wh_threshold)
        & (w2 * h2 / (w1 * h1 + eps) > area_thr)
        & (ar < aspect_ratio_threshold)
    )


# --------------------------------------------------------------------------
# mosaic
# --------------------------------------------------------------------------

def mosaic4(
    samples: Sequence[AugmentedSample],
    target_size: int,
    rng: np.random.Generator,
    center: Optional[Tuple[int, int]] = None,
) -> Tuple[AugmentedSample, Tuple[int, int]]:
    """4-image mosaic on a 2Sx2S canvas (ref mosaic.py:51-161).

    `center` (xc, yc) overrides the random draw.
    """
    if len(samples) != 4:
        raise ValueError(f"mosaic4 takes 4 samples, got {len(samples)}")
    s = target_size
    border = (-s // 2, -s // 2)
    if center is not None:
        xc, yc = center
    else:
        # center in [s/2, 3s/2] (ref mosaic.py:58-62)
        yc = int(rng.uniform(-border[0], 2 * s + border[0]))
        xc = int(rng.uniform(-border[1], 2 * s + border[1]))

    canvas = np.full((2 * s, 2 * s, samples[0].image.shape[2]), FILL, np.uint8)
    all_boxes, all_labels = [], []
    for i, smp in enumerate(samples):
        img = smp.image
        h, w = img.shape[:2]
        if i == 0:  # top-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
            x2b, y2b = w, h
        elif i == 1:  # top-right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, 2 * s), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(2 * s, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:  # bottom-right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, 2 * s), min(2 * s, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)

        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b
        if len(smp.bboxes):
            b = smp.bboxes.copy()
            b[:, [0, 2]] += padw
            b[:, [1, 3]] += padh
            all_boxes.append(b)
            all_labels.append(smp.labels)

    if all_boxes:
        boxes = np.concatenate(all_boxes, 0)
        labels = np.concatenate(all_labels, 0)
        truncated = np.clip(boxes, 0, 2 * s)
        keep = box_candidates(boxes.T, truncated.T, eps=1e-7)
        boxes = np.clip(boxes[keep], 0, 2 * s - 1)
        labels = labels[keep]
    else:
        boxes = np.zeros((0, 4), np.float32)
        labels = np.zeros((0,), np.int64)

    return AugmentedSample(canvas, boxes, labels), border


# --------------------------------------------------------------------------
# affine / perspective
# --------------------------------------------------------------------------

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


class AffineValues(NamedTuple):
    perspective_x: float
    perspective_y: float
    degrees: float
    scale: float
    shear_x: float
    shear_y: float
    translate_x: float
    translate_y: float


def sample_affine_values(p: AffineParams, rng: np.random.Generator) -> AffineValues:
    """ref get_affine_random_values (default.py:110-141)."""
    return AffineValues(
        perspective_x=rng.uniform(-p.perspective, p.perspective),
        perspective_y=rng.uniform(-p.perspective, p.perspective),
        degrees=rng.uniform(-p.degrees, p.degrees),
        scale=rng.uniform(1 - p.scale, 1 + p.scale),
        shear_x=rng.uniform(-p.shear, p.shear),
        shear_y=rng.uniform(-p.shear, p.shear),
        translate_x=rng.uniform(0.5 - p.translate, 0.5 + p.translate),
        translate_y=rng.uniform(0.5 - p.translate, 0.5 + p.translate),
    )


def affine_matrix(
    v: AffineValues, img_w: int, img_h: int, border: Tuple[int, int] = (0, 0)
) -> Tuple[np.ndarray, int, int]:
    """Combined M = T@S@R@P@C and output size (ref default.py:218-247)."""
    import cv2

    out_w = img_w + border[1] * 2
    out_h = img_h + border[0] * 2

    C = np.eye(3)
    C[0, 2] = -img_w / 2
    C[1, 2] = -img_h / 2

    P = np.eye(3)
    P[2, 0] = v.perspective_x
    P[2, 1] = v.perspective_y

    R = np.eye(3)
    R[:2] = cv2.getRotationMatrix2D(angle=v.degrees, center=(0, 0), scale=v.scale)

    S = np.eye(3)
    S[0, 1] = math.tan(v.shear_x * math.pi / 180)
    S[1, 0] = math.tan(v.shear_y * math.pi / 180)

    T = np.eye(3)
    T[0, 2] = v.translate_x * out_w
    T[1, 2] = v.translate_y * out_h

    return T @ S @ R @ P @ C, out_w, out_h


def transform_boxes(
    bboxes: np.ndarray, M: np.ndarray, out_w: int, out_h: int, perspective: bool
) -> np.ndarray:
    """4-corner transform + axis-aligned hull + clip (ref default.py:250-276)."""
    n = len(bboxes)
    xy = np.ones((n * 4, 3))
    xy[:, :2] = bboxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
    xy = xy @ M.T
    xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
    x = xy[:, [0, 2, 4, 6]]
    y = xy[:, [1, 3, 5, 7]]
    out = np.concatenate((x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, n).T
    out[:, [0, 2]] = out[:, [0, 2]].clip(0, out_w - 1)
    out[:, [1, 3]] = out[:, [1, 3]].clip(0, out_h - 1)
    return out


def random_perspective(
    sample: AugmentedSample,
    values: AffineValues,
    border: Tuple[int, int] = (0, 0),
) -> AugmentedSample:
    """Warp + box transform + candidate filter (ref default.py:279-351)."""
    import cv2

    im, boxes, labels = sample
    M, out_w, out_h = affine_matrix(values, im.shape[1], im.shape[0], border)
    perspective = values.perspective_x != 0.0 or values.perspective_y != 0.0

    img = im
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            img = cv2.warpPerspective(
                im, M, dsize=(out_w, out_h), borderValue=(FILL, FILL, FILL)
            )
        else:
            img = cv2.warpAffine(
                im,
                M[:2],
                dsize=(out_w, out_h),
                borderValue=(FILL, FILL, FILL),
                flags=cv2.INTER_LINEAR,
                borderMode=cv2.BORDER_CONSTANT,
            )
    if len(labels) == 0:
        return AugmentedSample(img, boxes, labels)

    proc = transform_boxes(boxes, M, out_w, out_h, perspective)
    keep = box_candidates(boxes.T * values.scale, proc.T)
    return AugmentedSample(img, proc[keep], labels[keep])


# --------------------------------------------------------------------------
# color / flip / mixup
# --------------------------------------------------------------------------

def augment_hsv(
    img: np.ndarray, p: HSVParams, rng: np.random.Generator
) -> np.ndarray:
    """uint8 LUT HSV jitter (ref default.py:354-383)."""
    if not p.should_aug():
        return img
    import cv2

    r = rng.uniform(-1, 1, 3) * [p.hue, p.saturation, p.value] + 1
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    x = np.arange(0, 256, dtype=np.int16)
    lut_hue = ((x * r[0]) % 180).astype(img.dtype)
    lut_sat = np.clip(x * r[1], 0, 255).astype(img.dtype)
    lut_val = np.clip(x * r[2], 0, 255).astype(img.dtype)
    merged = cv2.merge(
        (cv2.LUT(hue, lut_hue), cv2.LUT(sat, lut_sat), cv2.LUT(val, lut_val))
    ).astype(img.dtype)
    return cv2.cvtColor(merged, cv2.COLOR_HSV2BGR)


def random_color_transforms(
    img: np.ndarray, rng: np.random.Generator, p: float = 0.01
) -> np.ndarray:
    """Blur / MedianBlur / ToGray / CLAHE, each with prob p (parity: the
    reference's albumentations extras, default.py:420-431)."""
    import cv2

    if rng.random() < p:  # Blur: random odd kernel 3..7
        k = int(rng.choice([3, 5, 7]))
        img = cv2.blur(img, (k, k))
    if rng.random() < p:  # MedianBlur
        k = int(rng.choice([3, 5]))
        img = cv2.medianBlur(img, k)
    if rng.random() < p:  # ToGray
        g = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        img = cv2.cvtColor(g, cv2.COLOR_GRAY2RGB)
    if rng.random() < p:  # CLAHE on LAB L channel
        lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
        clahe = cv2.createCLAHE(clipLimit=4.0, tileGridSize=(8, 8))
        lab[..., 0] = clahe.apply(lab[..., 0])
        img = cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)
    return img


def horizontal_flip(sample: AugmentedSample) -> AugmentedSample:
    """(ref default.py:386-397 — mirror at width-1)."""
    image = np.fliplr(sample.image)
    boxes = sample.bboxes.copy()
    if len(boxes):
        w = image.shape[1]
        boxes[:, 2] = w - 1 - sample.bboxes[:, 0]
        boxes[:, 0] = w - 1 - sample.bboxes[:, 2]
    return AugmentedSample(np.ascontiguousarray(image), boxes, sample.labels)


def mixup(
    s1: AugmentedSample, s2: AugmentedSample, rng: np.random.Generator
) -> AugmentedSample:
    """beta(32,32) image blend + label concat (ref default.py:400-408)."""
    r = rng.beta(32.0, 32.0)
    im = (s1.image.astype(np.float32) * r + s2.image.astype(np.float32) * (1 - r))
    return AugmentedSample(
        im.astype(s1.image.dtype),
        np.concatenate((s1.bboxes, s2.bboxes), 0),
        np.concatenate((s1.labels, s2.labels), 0),
    )


class TrainSampleAugmentor:
    """Affine -> HSV -> flip chain (ref TrainSampleAugmentor, default.py:411-488).

    Output stays uint8 HWC; the float conversion happens at batch assembly
    (the reference's ToFloat/ToTensorV2 step).
    """

    def __init__(self, aug_params: AugParams, rng_seed: int = 51):
        self.aug_params = aug_params
        self.rng = np.random.default_rng(rng_seed)  # ref default.py:418

    def __call__(
        self, sample: AugmentedSample, border: Tuple[int, int] = (0, 0)
    ) -> AugmentedSample:
        p = self.aug_params
        if p.affine_params.should_aug():
            values = sample_affine_values(p.affine_params, self.rng)
            sample = random_perspective(sample, values, border)
        img = sample.image
        if p.image_color_transforms:
            img = random_color_transforms(np.ascontiguousarray(img), self.rng)
        img = augment_hsv(img, p.hsv_params, self.rng)
        sample = AugmentedSample(img, sample.bboxes, sample.labels)
        if p.flip_lr_prob > 0.0 and self.rng.random() < p.flip_lr_prob:
            sample = horizontal_flip(sample)
        return sample


class ValidationSampleAugmentor:
    """Identity (ref albu.py ValidationSampleAugmentor = ToFloat+ToTensor)."""

    def __call__(
        self, sample: AugmentedSample, border: Tuple[int, int] = (0, 0)
    ) -> AugmentedSample:
        return sample
