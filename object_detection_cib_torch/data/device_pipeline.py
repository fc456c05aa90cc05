"""The production training feed: a planar uint8 corpus on the card, gathered
and augmented on the card every step.

Counterpart of ``object_detection_cib_tpu/data/device_pipeline.py`` in its
production form (``data.pipeline=device``, ``data.device_cache=True``,
``corpus_layout=planar``, ``warp_precision=fast``). Per step of batch B:

  1. the epoch plan gives 4B corpus rows (each primary image and three
     co-samples, shuffled within their quad);
  2. K2 gathers the 4B planar images (``ops/gather.py``), and their sizes
     and per-image targets are gathered from arrays on the card;
  3. the fused mosaic + affine warp, K5 (``ops/augment.py``), with the
     horizontal flip folded into its taps;
  4. HSV jitter, K4 (``ops/hsv.py``);
  5. flip of the boxes, then ``to_batch``: capacity ``max_targets`` (valid
     targets first), NHWC, ``/255`` in f32, cast to the feed dtype.

The epoch plan uses ``random.Random`` and numpy exactly as the JAX package
does, so the same seed gives the same groups. The per-step ``jax.random``
keys become draws from one ``torch.Generator`` on the card
(``draw_augment``), so augmentation is reproducible within the port only.

Settings outside this path raise ``NotImplementedError`` naming the ROADMAP
item that will port them, never switching path quietly: ``mixup_prob > 0``
(A5), ``use_mosaic=False`` (A4), a non-axis-aligned affine (A4),
``warp_precision="exact"`` (A4), a sampler (A3), real JPEG decode (A3) and
the host-fed pipeline (A3). The flat (N, 8, D/8) corpus layout is a TPU
tiling workaround and is not ported (K3's kernel still exists, in
``ops/gather.py``). Not ported either: ``device_put_row_major`` (a TPU
layout pin) and the multi-host and sharded-corpus modes (A7).
"""

from __future__ import annotations

import random as pyrandom
from typing import Iterator, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from object_detection_cib_torch.data.cache import DatasetInfo
from object_detection_cib_torch.data.host_augment import AugParams
from object_detection_cib_torch.ops.augment import (
    AffineBatchValues,
    DeviceSample,
    draw_affine_values,
    draw_flip,
    draw_mosaic_centers,
    flip_boxes,
    hsv_gains,
    mosaic_affine_batch,
)
from object_detection_cib_torch.ops.gather import gather_rows_planar
from object_detection_cib_torch.ops.hsv import hsv_planar
from object_detection_cib_torch.ops.warp import FILL
from object_detection_cib_torch.train.steps import Batch
from object_detection_cib_torch.utils.device import resolve_device


class AugmentDraws(NamedTuple):
    """One step's random draws for G = B mosaic groups."""

    centers: torch.Tensor  # (G, 2) int32
    values: AffineBatchValues  # (G,) each
    flip: Optional[torch.Tensor]  # (G,) bool, None when flip_lr_prob == 0
    hsv_r: Optional[torch.Tensor]  # (G, 3) f32, None when HSV is off


def draw_augment(gen: torch.Generator, groups: int, target_size: int,
                 aug: AugParams) -> AugmentDraws:
    """Draw one step's randoms from ``gen`` (on the card in training)."""
    ap, hp = aug.affine_params, aug.hsv_params
    centers = draw_mosaic_centers(gen, groups, target_size)
    values = draw_affine_values(gen, groups, degrees=ap.degrees, translate=ap.translate,
                                scale=ap.scale, shear=ap.shear, perspective=ap.perspective)
    r = hsv_gains(gen, groups, hp.hue, hp.saturation, hp.value) if hp.should_aug() else None
    flip = draw_flip(gen, groups, aug.flip_lr_prob) if aug.flip_lr_prob > 0 else None
    return AugmentDraws(centers, values, flip, r)


def _check_supported(aug: AugParams, mixup_prob: float, use_mosaic: bool,
                     warp_precision: str) -> None:
    if mixup_prob > 0.0:
        raise NotImplementedError("mixup (the secondary mosaic group) is ROADMAP item A5")
    if not use_mosaic:
        raise NotImplementedError("the no-mosaic letterbox path is ROADMAP item A4")
    if not aug.affine_params.axis_aligned():
        raise NotImplementedError(
            "a rotating/shearing/perspective affine (the per-pixel gather warp) is ROADMAP item A4")
    if warp_precision != "fast":
        raise NotImplementedError(f"warp_precision={warp_precision!r} is ROADMAP item A4; "
                                  "the port has 'fast'")


def augment_group(sample: DeviceSample, draws: AugmentDraws, target_size: int,
                  aug: AugParams) -> DeviceSample:
    """Fused mosaic + warp (K5, flip folded in), HSV (K4), box flip.

    ``sample.images`` (4G, 3, S, S) uint8 -> (G, 3, S', S') bf16 images:
    the warp's output is integer-valued in [0, 255], so bf16 holds it
    exactly (the JAX package's stage dtype).
    """
    s = mosaic_affine_batch(sample, draws.centers, draws.values, target_size,
                            flip_do=draws.flip, out_dtype=torch.bfloat16)
    if draws.hsv_r is not None:
        s = s._replace(images=hsv_planar(s.images, draws.hsv_r))
    if draws.flip is not None:
        s = s._replace(boxes=flip_boxes(s.boxes, draws.flip, target_size))
    return s


def to_batch(s: DeviceSample, max_targets: int,
             feed_dtype: torch.dtype = torch.bfloat16) -> Tuple[Batch, torch.Tensor]:
    """-> (Batch, int32 count of valid targets dropped by capacity).

    Planar images go to NHWC for the network; the divide by 255 runs in
    f32 whatever the stage dtype, then casts to ``feed_dtype``.
    """
    T = s.boxes.shape[1]
    if T > max_targets:
        # keep valid slots first, then truncate to capacity
        order = torch.argsort((~s.mask).to(torch.int8), dim=1, stable=True)[:, :max_targets]
        boxes = torch.gather(s.boxes, 1, order[..., None].expand(-1, -1, 4))
        labels = torch.gather(s.labels, 1, order)
        mask = torch.gather(s.mask, 1, order)
        overflow = (s.mask.sum() - mask.sum()).to(torch.int32)
    else:
        pad = max_targets - T
        boxes = torch.nn.functional.pad(s.boxes, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(s.labels, (0, pad))
        mask = torch.nn.functional.pad(s.mask, (0, pad))
        overflow = torch.zeros((), dtype=torch.int32, device=s.boxes.device)
    images = s.images.permute(0, 2, 3, 1).contiguous()
    batch = Batch(
        images=(images.float() / 255.0).to(feed_dtype),
        boxes=boxes,
        labels=torch.where(mask, labels, torch.zeros_like(labels)),
        mask=mask,
    )
    return batch, overflow


def build_device_augment_fn(
    target_size: int,
    aug: AugParams,
    mixup_prob: float = 0.0,
    max_targets: int = 120,
    use_mosaic: bool = True,
    warp_precision: str = "fast",
    feed_dtype: torch.dtype = torch.bfloat16,
):
    """``fn(sample, draws) -> (Batch, overflow)`` for planar 4B-image samples."""
    _check_supported(aug, mixup_prob, use_mosaic, warp_precision)

    def fn(primary: DeviceSample, draws: AugmentDraws):
        return to_batch(augment_group(primary, draws, target_size, aug), max_targets, feed_dtype)

    return fn


class DeviceDataPipeline:
    """Train batches from a corpus held on the card (fake mode, planar)."""

    def __init__(
        self,
        dataset_info: DatasetInfo,
        target_size: int,
        batch_size: int,
        aug_params: AugParams,
        max_targets: int = 120,
        mixup_prob: float = 0.0,
        use_mosaic: bool = True,
        warp_precision: str = "fast",
        sampler=None,
        seed: int = 0,
        fake_mode: bool = True,
        device_cache: bool = True,
        corpus_layout: str = "planar",
        feed_dtype: torch.dtype = torch.bfloat16,
        device: Union[str, torch.device] = "cuda",
    ):
        _check_supported(aug_params, mixup_prob, use_mosaic, warp_precision)
        if sampler is not None:
            raise NotImplementedError("samplers (class-aware, repeat-factor) are ROADMAP item A3")
        if not fake_mode:
            raise NotImplementedError("JPEG corpora (native decode into the cache) are ROADMAP item A3")
        if not device_cache:
            raise NotImplementedError("the host-fed pipeline is ROADMAP item A3")
        if corpus_layout != "planar":
            raise NotImplementedError(
                f"corpus_layout={corpus_layout!r}: the flat layout is a TPU tiling "
                "workaround and is not ported")
        self.device = resolve_device(device)
        self.info = dataset_info
        self.S = target_size
        self.B = batch_size
        self.aug = aug_params
        self.max_targets = max_targets
        self.pyrng = pyrandom.Random(seed)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.label_to_index = {c: i for i, c in enumerate(dataset_info.classes)}
        self.src_T = max(max((len(s.targets) for s in dataset_info.samples), default=1), 1)
        self.augment_fn = build_device_augment_fn(
            target_size, aug_params, mixup_prob, max_targets, use_mosaic,
            warp_precision, feed_dtype)
        # valid targets dropped by max_targets: device scalars, summed on read
        self._overflow_done = 0
        self._overflow_pending: list = []
        self._build_device_cache()

    def __len__(self) -> int:
        return len(self.info.samples) // self.B

    @property
    def overflow_total(self) -> int:
        """Total valid targets dropped by max_targets so far (one fetch)."""
        if self._overflow_pending:
            pending, self._overflow_pending = self._overflow_pending, []
            self._overflow_done += int(torch.stack(pending).sum())
        return self._overflow_done

    # -------------------- the corpus on the card --------------------
    def _build_device_cache(self) -> None:
        """Fake corpus (the JAX package's draws, planar) and targets on the card."""
        n, S = len(self.info.samples), self.S
        corpus = np.full((n, 3, S, S), FILL, np.uint8)
        sizes = np.zeros((n, 2), np.int32)
        rng = np.random.default_rng(0)
        for i, s in enumerate(self.info.samples):
            meta = s.image_metadata
            scale = S / max(meta.height, meta.width)
            h = min(max(int(round(meta.height * scale)), 1), S)
            w = min(max(int(round(meta.width * scale)), 1), S)
            corpus[i, :, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8).transpose(2, 0, 1)
            sizes[i] = (h, w)
        tb = np.zeros((n, self.src_T, 4), np.float32)
        tl = np.zeros((n, self.src_T), np.int32)
        tm = np.zeros((n, self.src_T), bool)
        for i in range(n):
            tb[i], tl[i], tm[i] = self._targets_arrays(i)
        dev = self.device
        self.corpus = torch.from_numpy(corpus).to(dev)
        self.sizes = torch.from_numpy(sizes).to(dev)
        self.t_boxes = torch.from_numpy(tb).to(dev)
        self.t_labels = torch.from_numpy(tl).to(dev)
        self.t_mask = torch.from_numpy(tm).to(dev)

    def _targets_arrays(self, idx: int):
        """Per-image targets in resized-content coordinates.

        Boxes use the uniform scale S / max(h, w), the host reader's math
        (albumentations LongestMaxSize), not the per-axis rounded ratios.
        """
        s = self.info.samples[idx]
        boxes = np.zeros((self.src_T, 4), np.float32)
        labels = np.zeros((self.src_T,), np.int32)
        mask = np.zeros((self.src_T,), bool)
        k = 0
        meta = s.image_metadata
        sc = self.S / max(meta.height, meta.width)
        for t in s.targets:
            bb = t.bounding_box
            if bb.x_max <= bb.x_min or bb.y_max <= bb.y_min or k >= self.src_T:
                continue
            boxes[k] = [bb.x_min * sc, bb.y_min * sc, bb.x_max * sc, bb.y_max * sc]
            labels[k] = self.label_to_index[t.class_name]
            mask[k] = True
            k += 1
        return boxes, labels, mask

    # -------------------------- the epoch --------------------------
    def _epoch_plan(self) -> np.ndarray:
        """One epoch's (steps, 4B) corpus rows, drawn as the JAX package draws
        them (``sampler=None``, one process), advancing ``pyrng`` alike."""
        n = len(self.info.samples)
        epoch_idx = np.random.default_rng(self.pyrng.randrange(2**31)).permutation(n)
        epoch_idx = np.asarray(epoch_idx, np.int64)
        n_batches = len(epoch_idx) // self.B
        n_prim = n_batches * self.B
        rng = np.random.default_rng(self.pyrng.randrange(2**31))
        pool = np.arange(n, dtype=np.int64)

        def draw(k):
            if k == 0:
                return np.zeros((0,), np.int64)
            return pool[rng.choice(len(pool), size=k, p=None)]

        # per primary: [primary, co1, co2, co3] shuffled within the quad
        quads = np.concatenate([epoch_idx[:n_prim, None], draw(3 * n_prim).reshape(n_prim, 3)], 1)
        quads = rng.permuted(quads, axis=1)
        return quads.reshape(n_batches, 4 * self.B)

    def gather(self, idx: torch.Tensor) -> DeviceSample:
        """4B corpus rows (one K2 launch) and their sizes and targets."""
        rows = idx.long()
        return DeviceSample(gather_rows_planar(self.corpus, idx), self.sizes[rows],
                            self.t_boxes[rows], self.t_labels[rows], self.t_mask[rows])

    def gather_augment(self, idx: torch.Tensor, draws: AugmentDraws) -> Tuple[Batch, torch.Tensor]:
        """idx (4B,) int32 on the card -> (Batch, overflow)."""
        return self.augment_fn(self.gather(idx), draws)

    def epoch(self, max_steps: Optional[int] = None) -> Iterator[Tuple[Batch, torch.Tensor]]:
        """Yield ``(Batch, overflow)`` per step of one epoch.

        The whole epoch's plan goes to the card in one copy after a range
        check on the host; each step then draws its randoms on the card and
        launches K2, K5 and K4 once each. Overflow counts stay on the card
        until ``overflow_total`` is read.
        """
        groups = self._epoch_plan()
        if max_steps is not None:
            groups = groups[:max_steps]
        n = len(self.info.samples)
        if groups.size and (groups.min() < 0 or groups.max() >= n):
            raise IndexError(f"epoch plan row outside [0, {n})")
        plan = torch.from_numpy(groups.astype(np.int32)).to(self.device)
        G = self.B
        for i in range(plan.shape[0]):
            draws = draw_augment(self.gen, G, self.S, self.aug)
            batch, ovf = self.gather_augment(plan[i], draws)
            self._overflow_pending.append(ovf)
            yield batch, ovf
