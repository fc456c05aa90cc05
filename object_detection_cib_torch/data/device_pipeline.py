"""The production training feed: uint8 images augmented on the card every
step, from a planar corpus held on the card or loaded per step by the host.

Counterpart of ``object_detection_cib_tpu/data/device_pipeline.py``
(``data.pipeline=device``). The images come from fake draws (``fake_mode``)
or from JPEG files (``native_loader``: decoded on the host, letterboxed
where the rows live by ``ops/letterbox.py``, on the card its kernel; a file
that fails to decode raises ``ValueError``), and reach the card one of two
ways:

  * ``device_cache=True``: the whole corpus is decoded once into a
    ``DeviceCorpus`` on the card, ``DECODE_ROWS`` files at a time (their
    decoded bytes copied up from pinned memory, then letterboxed into the
    corpus rows), held in the layout ``corpus_layout`` names (below), and
    each step's rows are gathered from it: K2 on the planar layout, K3 on
    the flat one;
  * ``device_cache=False`` (host-fed, the JAX package's ``_load_group`` and
    iterator): a producer thread loads each step's groups as decoded RGB
    images (``RawImages``) in pinned host memory, up to ``prefetch`` steps
    ahead (with ``enable_ram_cache`` each JPEG is decoded once in all), and
    the consumer copies them up and letterboxes them into planar rows on
    the card (fake content is drawn at its content size, which letterboxes
    to itself). The JAX package augments this
    feed in NHWC; the port augments it planar with the same function as
    the corpus on the card (the two layouts give the same bytes,
    ``tests/test_planar_corpus.py``), so the fused path launches K5 and K4,
    not K2. With the same seed and the same JPEG corpus both ways give the
    same batches, bit for bit.

Per step of batch B:

  1. the epoch plan gives the corpus rows: with mosaic 4B (each primary
     image, from the sampler's epoch stream or a permutation, and three
     co-samples, shuffled within their quad), without mosaic B; under mixup
     4B more for the secondary mosaic group;
  2. the group's images (K2 or K3 on the card, or the host-fed upload), their
     sizes, and their per-image targets gathered from arrays on the card;
  3. ``augment_group``. With mosaic and an axis-aligned affine, the fused
     mosaic + warp (``ops/augment.py``: K5 at ``warp_precision="fast"``,
     two bf16 matrix products under ``warp_pallas=False`` (``"fast_dense"``),
     two f32 ones at ``"exact"``) with the horizontal flip folded
     into its taps, HSV (K4, bf16), flip of the boxes. Otherwise the
     composed path: the 2S x 2S mosaic canvas or the centred letterbox, the
     cast to f32, ``affine_batch`` (per-pixel bilinear sampling for a
     rotating, shearing or perspective affine), HSV (K4, f32), ``flip_batch``;
  4. under mixup both groups go through 3, are blended by a beta(32, 32)
     ratio where the per-image coin says so, and the targets grow to 2 x 4T;
  5. ``to_batch``: capacity ``max_targets`` (valid targets first), NHWC,
     ``/255`` in f32, cast to the feed dtype.

The epoch plan uses the sampler, ``random.Random`` and numpy exactly as the
JAX package does, so the same seed gives the same groups. The per-step
``jax.random`` keys become draws from one ``torch.Generator`` on the card
(``draw_augment``), made in step order by the consumer, so augmentation is
reproducible within the port only.

Two ways through an epoch: ``epoch`` yields the steps' batches to a step
loop; ``build_fused_epoch_fn`` (``FusedEpoch``, the JAX package's fused
epoch over the corpus on the card) runs gather, augment and the train step
of every step itself, on the card as a CUDA graph replayed once per step.
Both give the same batches from the same seed.

Data parallelism (``mesh``, a ``parallel.mesh.DataMesh`` with a process
group; the JAX package's mesh): ``batch_size`` is the batch B of one host
(the JAX package's per-process batch; on one host the global batch), the
global batch is ``hosts * B`` and each rank makes its rows of it. Every
rank draws its plans from identically seeded generators, so every host
advances the sampler, ``pyrng`` and the generator alike and epochs stay in
step:

  * the step loop (``epoch``): host h's plan is the JAX package's
    ``_epoch_plan(shard_for_host=True)`` at ``process_index`` h: its
    interleaved shard of the epoch stream (``samplers.shard_indices``) and
    co-samples from ``default_rng((seed, h))``; on one host the whole plan.
    A rank keeps its columns of its host's plan (the quads of its
    primaries, rows ``[l B/L, (l+1) B/L)`` for local rank l of L, their
    mixup partners);
  * the fused epoch (``epoch_host_arrays``): one global plan at ``hosts *
    B``, the same on every host, of which each rank keeps its columns by
    its global rank (JAX's ``epoch_host_arrays`` with ``P(None, "data")``),
    so a run over H hosts of L ranks trains row for row like one host of
    H L ranks and like one process at the same global batch.

The draws of each step are the global batch's from the one generator, and a
rank keeps its rows by its global rank: one stream advanced alike on every
host, each host's rows its own (the port cannot reproduce the JAX
package's per-host ``fold_in`` of threefry keys, ROADMAP). Each rank then
gathers (K2 or K3), warps (K5) and jitters (K4) its own groups; the JAX package
turns its Pallas gather, HSV and warp off when ``process_count() > 1`` (a
GSPMD workaround), the port keeps its kernels on every rank. Host-fed, a
rank loads only its own groups (JPEG files; in fake mode it draws the
whole group's content, as the content of a fake group is seeded by the
group, and keeps its rows). ``corpus_sharding="sharded"`` (JAX
``make_sharded_corpus_gather``) holds rank r's rows ``[r P, (r+1) P)`` of
the corpus images, P = ceil(N/ranks) (the last shard padded with zero
rows, as the JAX package pads), beside the whole (small) sizes and
targets: for a step's global group (over several hosts in the step loop,
every host's plan side by side, each rank drawing them all) each rank
gathers the rows it holds with K2 (K3 on the flat layout), zeroes the rest, and one
``reduce_scatter`` (a sum, exact in uint8 since one rank holds each row)
deals each rank its own rows, bitwise the replicated corpus's.

The corpus on the card has two layouts, chosen by ``corpus_layout`` (the
config's ``data.corpus_layout``) alone:

  * ``"planar"`` (the default): (N, 3, S, S) uint8, the rows whole planes,
    gathered by K2 straight into the form ``augment_fn`` takes;
  * ``"flat"``: the NHWC rows (N, S, S, 3) the host makes, copied up as
    they are (no transpose at set-up), gathered by K3 on their (N, 8, D/8)
    view (``ops/gather.py:gather_rows_nhwc``, D = 3 S^2, S a multiple of
    32), viewed back as (K, S, S, 3) and made planar by one permute-copy,
    the JAX flat gather's reshape-and-relayout (``_make_row_gather``). On
    every recipe and both loops; under mixup K3 runs twice a step; over a
    sharded corpus K3 gathers the rows a rank holds before the exchange.

The two layouts give the same batches, bit for bit. The JAX package also
switches to its NHWC flow by itself whenever mosaic is off or the affine is
general, because its augment consumes NHWC there; the port's augment
consumes planar images on every recipe, so the port does not copy that
switch: a planar corpus stays planar on those recipes (the JAX package's
two flows give the same bytes, ``tests/test_planar_corpus.py``). With
``device_cache=False`` the layout changes nothing, as in the JAX package.
A pipeline handed a shared corpus of the other layout raises.

Not ported: ``device_put_row_major`` (a TPU layout pin).
"""

from __future__ import annotations

import itertools
import queue
import random as pyrandom
import threading
from collections import deque
from pathlib import Path
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from object_detection_cib_torch.data import native_loader
from object_detection_cib_torch.data.native_loader import RawImages
from object_detection_cib_torch.data.cache import DatasetInfo
from object_detection_cib_torch.data.host_augment import AugParams
from object_detection_cib_torch.data.samplers import shard_indices
from object_detection_cib_torch.ops.augment import (
    WARP_PRECISIONS,
    AffineBatchValues,
    DeviceSample,
    affine_batch,
    draw_affine_values,
    draw_flip,
    draw_mixup,
    draw_mosaic_centers,
    flip_batch,
    flip_boxes,
    hsv_gains,
    mixup_batch,
    mosaic4_batch,
    mosaic_affine_batch,
    take_rows_cols,
)
from object_detection_cib_torch.ops.gather import check_flat_rows, gather_rows_nhwc, gather_rows_planar
from object_detection_cib_torch.ops.graph import CapturedGraph
from object_detection_cib_torch.ops.hsv import hsv_planar
from object_detection_cib_torch.ops.letterbox import letterbox
from object_detection_cib_torch.ops.warp import FILL
from object_detection_cib_torch.parallel.distributed import reduce_scatter_sum
from object_detection_cib_torch.parallel.mesh import DataMesh, batch_sharding, host_batch_sharding, refuse_model_axis
from object_detection_cib_torch.train.steps import Batch
from object_detection_cib_torch.utils.device import resolve_device, to_unit
from object_detection_cib_torch.utils import tracing
from object_detection_cib_torch.utils.fs import get_root_dir
from object_detection_cib_torch.utils.threads import put_unless_stopped


class AugmentDraws(NamedTuple):
    """One step's random draws for one group of G output images.

    Under mixup the primary group's draws also hold the secondary group's,
    the blend ratio and the per-image coin.
    """

    centers: Optional[torch.Tensor]  # (G, 2) int32, None without mosaic
    values: AffineBatchValues  # (G,) each
    flip: Optional[torch.Tensor]  # (G,) bool, None when flip_lr_prob == 0
    hsv_r: Optional[torch.Tensor]  # (G, 3) f32, None when HSV is off
    secondary: Optional["AugmentDraws"] = None  # the mixup partner group's draws
    mix_r: Optional[torch.Tensor] = None  # (G, 1, 1, 1) f32 blend ratio
    mix_do: Optional[torch.Tensor] = None  # (G,) bool: blend this image

    def to(self, device) -> "AugmentDraws":
        """The same draws on another device."""
        def move(t):
            if t is None:
                return None
            if isinstance(t, (torch.Tensor, AugmentDraws)):
                return t.to(device)
            return type(t)(*(v.to(device) for v in t))  # AffineBatchValues

        return AugmentDraws(*(move(t) for t in self))

    def rows(self, sl: slice) -> "AugmentDraws":
        """The draws of output images ``sl`` (every field's leading axis)."""
        def take(t):
            if t is None:
                return None
            if isinstance(t, (torch.Tensor, AugmentDraws)):
                return t.rows(sl) if isinstance(t, AugmentDraws) else t[sl]
            return type(t)(*(v[sl] for v in t))  # AffineBatchValues

        return AugmentDraws(*(take(t) for t in self))


def _draw_group(gen: torch.Generator, groups: int, target_size: int, aug: AugParams,
                use_mosaic: bool) -> AugmentDraws:
    ap, hp = aug.affine_params, aug.hsv_params
    centers = draw_mosaic_centers(gen, groups, target_size) if use_mosaic else None
    values = draw_affine_values(gen, groups, degrees=ap.degrees, translate=ap.translate,
                                scale=ap.scale, shear=ap.shear, perspective=ap.perspective)
    r = hsv_gains(gen, groups, hp.hue, hp.saturation, hp.value) if hp.should_aug() else None
    flip = draw_flip(gen, groups, aug.flip_lr_prob) if aug.flip_lr_prob > 0 else None
    return AugmentDraws(centers, values, flip, r)


def draw_augment(gen: torch.Generator, groups: int, target_size: int, aug: AugParams,
                 use_mosaic: bool = True, mixup_prob: float = 0.0) -> AugmentDraws:
    """Draw one step's randoms from ``gen`` (on the card in training)."""
    draws = _draw_group(gen, groups, target_size, aug, use_mosaic)
    if mixup_prob > 0.0:
        secondary = _draw_group(gen, groups, target_size, aug, use_mosaic)
        mix_r, mix_do = draw_mixup(gen, groups, mixup_prob)
        draws = draws._replace(secondary=secondary, mix_r=mix_r, mix_do=mix_do)
    return draws


def letterbox_center(sample: DeviceSample, target_size: int) -> DeviceSample:
    """Centre each image's top-left (h, w) content on its S x S canvas.

    A per-image roll by ((S - h) // 2, (S - w) // 2), wrap-around included
    (what wraps is FILL), as index arithmetic on the card; boxes shift
    along and sizes become S.
    """
    S = target_size
    top = (S - sample.sizes[:, 0]) // 2
    left = (S - sample.sizes[:, 1]) // 2
    pos = torch.arange(S, dtype=torch.int32, device=sample.images.device)[None]
    rows = torch.remainder(pos - top[:, None], S)  # (B, S) source row of each output row
    cols = torch.remainder(pos - left[:, None], S)
    shift = torch.stack([left, top, left, top], -1).float()
    return sample._replace(images=take_rows_cols(sample.images, rows, cols),
                           boxes=sample.boxes + shift[:, None, :],
                           sizes=torch.full_like(sample.sizes, S))


def augment_group(sample: DeviceSample, draws: AugmentDraws, target_size: int, aug: AugParams,
                  use_mosaic: bool = True, warp_precision: str = "fast") -> DeviceSample:
    """One group's mosaic or letterbox, affine warp, HSV and flip.

    With mosaic and an axis-aligned affine, the fused path:
    ``sample.images`` (4G, 3, S, S) uint8 -> (G, 3, S', S') bf16 images (the
    warp's output is integer-valued in [0, 255], so bf16 holds it exactly:
    the JAX package's stage dtype), the flip folded into the warp. Otherwise
    the composed path in f32: the canvas (or, without mosaic, G = the
    sample's own images, letterboxed), ``affine_batch``, HSV, ``flip_batch``.
    HSV is K4 on the card on both paths. ``warp_precision="fast_dense"``
    takes the dense bf16 warp in place of K5 (``mosaic_affine_batch``).
    """
    axis_aligned = aug.affine_params.axis_aligned()
    if use_mosaic and axis_aligned:
        s = mosaic_affine_batch(sample, draws.centers, draws.values, target_size,
                                flip_do=draws.flip, out_dtype=torch.bfloat16,
                                precision=warp_precision)
        if draws.hsv_r is not None:
            s = s._replace(images=hsv_planar(s.images, draws.hsv_r))
        if draws.flip is not None:
            s = s._replace(boxes=flip_boxes(s.boxes, draws.flip, target_size))
        return s
    if use_mosaic:
        s = mosaic4_batch(sample, draws.centers, target_size)
        border = (-target_size // 2, -target_size // 2)
    else:
        s = letterbox_center(sample, target_size)
        border = (0, 0)
    # placement and roll are exact in uint8; the warp computes in f32
    s = s._replace(images=s.images.float())
    s = affine_batch(s, draws.values, target_size, border=border, axis_aligned=axis_aligned)
    if draws.hsv_r is not None:
        s = s._replace(images=hsv_planar(s.images, draws.hsv_r))
    if draws.flip is not None:
        s = flip_batch(s, draws.flip)
    return s


def mixup_groups(a: DeviceSample, b: DeviceSample, r: torch.Tensor, do: torch.Tensor) -> DeviceSample:
    """Blend the augmented primary ``a`` with the secondary ``b`` where ``do``.

    Target capacity doubles to 2T; where the coin is false the primary's
    targets are padded from T to 2T. The blend and the select promote bf16
    images to f32, as in the JAX package, so ``to_batch`` divides the f32
    blend, never a value rounded to bf16.
    """
    mixed = mixup_batch(a, b, r)
    T = a.boxes.shape[1]
    pad = torch.nn.functional.pad
    return DeviceSample(
        images=torch.where(do[:, None, None, None], mixed.images, a.images),
        sizes=a.sizes,
        boxes=torch.where(do[:, None, None], mixed.boxes, pad(a.boxes, (0, 0, 0, T))),
        labels=torch.where(do[:, None], mixed.labels, pad(a.labels, (0, T))),
        mask=torch.where(do[:, None], mixed.mask, pad(a.mask, (0, T))),
    )


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
        images=to_unit(images).to(feed_dtype),
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
    """``fn(primary, draws, secondary=None) -> (Batch, overflow)`` for planar samples.

    ``primary`` holds 4B images with mosaic and B without; under mixup
    ``secondary`` holds the 4B images of the partner mosaics.
    """
    if warp_precision not in WARP_PRECISIONS:
        raise ValueError(f"warp_precision must be one of {WARP_PRECISIONS}, got {warp_precision!r}")
    if mixup_prob > 0.0 and not use_mosaic:
        raise ValueError("mixup requires mosaic (ref detection.py:58-59)")

    def group(sample: DeviceSample, draws: AugmentDraws) -> DeviceSample:
        return augment_group(sample, draws, target_size, aug, use_mosaic, warp_precision)

    def fn(primary: DeviceSample, draws: AugmentDraws, secondary: Optional[DeviceSample] = None):
        s = group(primary, draws)
        if mixup_prob > 0.0:
            s = mixup_groups(s, group(secondary, draws.secondary), draws.mix_r, draws.mix_do)
        return to_batch(s, max_targets, feed_dtype)

    return fn


def content_size(meta, target_size: int) -> Tuple[int, int]:
    """(h, w) of an image resized to longest side S (the native loader's rounding)."""
    S = target_size
    scale = S / max(meta.height, meta.width)
    return (min(max(int(round(meta.height * scale)), 1), S),
            min(max(int(round(meta.width * scale)), 1), S))


def target_arrays(info: DatasetInfo, target_size: int):
    """Per-image targets in resized-content coordinates, capacity ``src_T``:
    ``(src_T, boxes (N, src_T, 4) f32, labels (N, src_T) int32, mask bool)``.

    Boxes use the uniform scale S / max(h, w), the host reader's math
    (albumentations LongestMaxSize), not the rounded ratios; degenerate
    boxes are dropped (the JAX package's ``_targets_arrays``).
    """
    n, S = len(info.samples), target_size
    src_T = max(max((len(s.targets) for s in info.samples), default=1), 1)
    label_to_index = {c: i for i, c in enumerate(info.classes)}
    tb = np.zeros((n, src_T, 4), np.float32)
    tl = np.zeros((n, src_T), np.int32)
    tm = np.zeros((n, src_T), bool)
    for i, s in enumerate(info.samples):
        meta = s.image_metadata
        scale = S / max(meta.height, meta.width)
        k = 0
        for t in s.targets:
            bb = t.bounding_box
            if bb.x_max <= bb.x_min or bb.y_max <= bb.y_min or k >= src_T:
                continue
            tb[i, k] = [bb.x_min * scale, bb.y_min * scale, bb.x_max * scale, bb.y_max * scale]
            tl[i, k] = label_to_index[t.class_name]
            tm[i, k] = True
            k += 1
    return src_T, tb, tl, tm


def fake_canvases(info: DatasetInfo, target_size: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The fake corpus: (N, S, S, 3) uint8 canvases with random content in the
    top-left (h, w) window and FILL elsewhere, drawn from ``default_rng(seed)``
    in corpus order (seed 0: the JAX package's ``_build_device_cache``), and
    (N, 2) int32 content sizes."""
    n, S = len(info.samples), target_size
    canvases = np.full((n, S, S, 3), int(FILL), np.uint8)
    sizes = np.zeros((n, 2), np.int32)
    rng = np.random.default_rng(seed)
    for i, s in enumerate(info.samples):
        h, w = content_size(s.image_metadata, S)
        canvases[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        sizes[i] = (h, w)
    return canvases, sizes


DECODE_ROWS = 256  # JPEG files decoded and letterboxed at a time: bounds the pinned staging


def read_files(info: DatasetInfo, indices: Sequence[int], root_dir: Path) -> list:
    """The bytes of the image files of samples ``indices``."""
    return [(root_dir / info.samples[int(i)].image_path).read_bytes() for i in indices]


def decode_canvases(info: DatasetInfo, indices: Sequence[int], target_size: int, root_dir: Path,
                    out: torch.Tensor, center: bool = False) -> torch.Tensor:
    """The JPEG files of samples ``indices`` decoded on the host and
    letterboxed (resized to longest side S, packed top-left on FILL, or
    centred with ``center``) into ``out``, an (n, 3, S, S) uint8 view of
    rows on any device, ``DECODE_ROWS`` files at a time
    (``native_loader.pack_rows``: on the card the letterbox kernel, the
    next files decoded while it runs): (n, 2) int32 sizes on ``out``'s
    device. Any decode failure raises ``ValueError``."""
    indices = list(indices)
    sizes = torch.empty((len(indices), 2), dtype=torch.int32, device=out.device)
    fails = 0
    for lo in range(0, len(indices), DECODE_ROWS):
        rows = slice(lo, min(lo + DECODE_ROWS, len(indices)))
        sizes[rows], failed = native_loader.pack_rows(read_files(info, indices[rows], root_dir), out[rows],
                                                      center)
        fails += failed
    if fails:
        raise ValueError(f"{fails} of {len(indices)} JPEG files failed to decode")
    return sizes


LAYOUTS = ("planar", "flat")


def check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"corpus_layout must be one of {LAYOUTS}, got {layout!r}")


class DeviceCorpus:
    """A corpus and its per-image targets as tensors on one device.

    Built once and shared by every pipeline over the same dataset, image
    size, device and layout (``DeviceDataPipeline(corpus=...)``): images
    with the content in the top-left (h, w) window and FILL elsewhere,
    (N, 3, S, S) uint8 under ``layout="planar"`` or the NHWC rows (N, S, S,
    3) under ``"flat"``, sizes (N, 2) int32, and target arrays of capacity
    ``src_T`` in resized-content coordinates. ``from_canvases`` is the one
    constructor from canvases; ``fake`` draws the canvases, ``decode``
    reads the JPEG files. ``gather`` takes rows as planar images whatever
    the layout: K2, or K3 on the flat view and one permute-copy.
    ``sharded`` holds only a rank's rows of the images (the module
    docstring); ``exchange`` gathers a global group's rows from the shards.
    """

    UPLOAD_ROWS = 256  # canvases per host->device copy: bounds the staging

    def __init__(self, info: DatasetInfo, images: torch.Tensor, sizes: torch.Tensor,
                 device: torch.device, mesh: Optional[DataMesh] = None, row0: int = 0,
                 layout: str = "planar"):
        check_layout(layout)
        self.layout = layout
        self.info, self.S, self.device = info, images.shape[-1 if layout == "planar" else 1], device
        if layout == "flat":
            check_flat_rows(self.S)
        self.images, self.sizes = images, sizes
        self.mesh, self.row0 = mesh, row0  # sharded: the mesh, and the first row held
        self.src_T, *targets = target_arrays(info, self.S)
        self.t_boxes, self.t_labels, self.t_mask = (torch.from_numpy(a).to(device) for a in targets)

    @staticmethod
    def _empty(n: int, S: int, device, layout: str, zeros: bool = False) -> torch.Tensor:
        check_layout(layout)
        if layout == "flat":
            check_flat_rows(S)
        shape = (n, 3, S, S) if layout == "planar" else (n, S, S, 3)
        return (torch.zeros if zeros else torch.empty)(shape, dtype=torch.uint8, device=device)

    @staticmethod
    def _upload(canvases: np.ndarray, device: torch.device, layout: str) -> torch.Tensor:
        """(n, S, S, 3) canvases into rows of ``layout`` on ``device``, a
        chunk at a time: the flat rows take the canvases' bytes as they are,
        the planar ones transposed there."""
        n, S = canvases.shape[:2]
        images = DeviceCorpus._empty(n, S, device, layout)
        rows = images if layout == "flat" else images.permute(0, 2, 3, 1)  # an (n, S, S, 3) view
        for i in range(0, n, DeviceCorpus.UPLOAD_ROWS):
            chunk = torch.from_numpy(np.ascontiguousarray(canvases[i:i + DeviceCorpus.UPLOAD_ROWS]))
            rows[i:i + DeviceCorpus.UPLOAD_ROWS].copy_(chunk.to(device) if layout == "planar" else chunk)
        return images

    @classmethod
    def from_canvases(cls, info: DatasetInfo, canvases: np.ndarray, sizes: np.ndarray,
                      device: Union[str, torch.device], layout: str = "planar") -> "DeviceCorpus":
        """(N, S, S, 3) uint8 canvases and (N, 2) sizes (fake content, or
        ``pack_batch``'s) to the device: copied up as they are for
        ``"flat"``, transposed to planar there for ``"planar"``."""
        device = torch.device(device)
        n, S = canvases.shape[:2]
        if canvases.shape != (n, S, S, 3) or canvases.dtype != np.uint8 or n != len(info.samples):
            raise ValueError(f"want ({len(info.samples)}, S, S, 3) uint8 canvases, got "
                             f"{canvases.shape} {canvases.dtype}")
        return cls(info, cls._upload(canvases, device, layout),
                   torch.from_numpy(np.asarray(sizes, np.int32)).to(device), device, layout=layout)

    @classmethod
    def fake(cls, info: DatasetInfo, target_size: int, device, layout: str = "planar") -> "DeviceCorpus":
        return cls.from_canvases(info, *fake_canvases(info, target_size), device, layout)

    @classmethod
    def decode(cls, info: DatasetInfo, target_size: int, device, root_dir: Optional[Path] = None,
               layout: str = "planar") -> "DeviceCorpus":
        """The JPEG files decoded into the corpus rows (``decode_canvases``;
        the letterbox writes the flat layout's NHWC rows through a permuted
        view)."""
        root = Path(root_dir) if root_dir else get_root_dir()
        device, n = torch.device(device), len(info.samples)
        images = cls._empty(n, target_size, device, layout)
        rows = images if layout == "planar" else images.permute(0, 3, 1, 2)
        return cls(info, images, decode_canvases(info, range(n), target_size, root, rows), device, layout=layout)

    @classmethod
    def sharded(cls, info: DatasetInfo, target_size: int, mesh: DataMesh, fake_mode: bool,
                root_dir: Optional[Path] = None, layout: str = "planar") -> "DeviceCorpus":
        """Rank ``mesh.rank``'s shard of the corpus images on ``mesh.device``,
        rows ``[r P, (r+1) P)`` with P = ceil(N / ranks), zero rows past N,
        in ``layout``; the sizes and targets of every row. Fake canvases are
        drawn whole and sliced (the same bytes as the replicated corpus);
        JPEG files are decoded for the rank's rows only, and the sizes
        all-gathered."""
        import torch.distributed as dist

        n, S, dev = len(info.samples), target_size, mesh.device
        per = -(-n // mesh.size)
        lo, hi = min(mesh.rank * per, n), min((mesh.rank + 1) * per, n)
        if fake_mode:
            canvases, sizes = fake_canvases(info, S)
            canvases = np.concatenate([canvases[lo:hi], np.zeros((per - (hi - lo), S, S, 3), np.uint8)])
            images, sizes = cls._upload(canvases, dev, layout), torch.from_numpy(sizes).to(dev)
        else:
            root = Path(root_dir) if root_dir else get_root_dir()
            images = cls._empty(per, S, dev, layout, zeros=True)
            rows = images if layout == "planar" else images.permute(0, 3, 1, 2)
            padded = torch.zeros((per, 2), dtype=torch.int32, device=dev)
            padded[:hi - lo] = decode_canvases(info, range(lo, hi), S, root, rows[:hi - lo])
            parts = [torch.empty_like(padded) for _ in range(mesh.size)]
            dist.all_gather(parts, padded, group=mesh.group)
            sizes = torch.cat(parts)[:n]
        return cls(info, images, sizes, dev, mesh, mesh.rank * per, layout)

    def _rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Held rows ``idx`` in the layout's own form: K2 on the planar
        corpus, K3 on the flat view of the NHWC one."""
        if self.layout == "planar":
            return gather_rows_planar(self.images, idx)
        return gather_rows_nhwc(self.images, idx)

    def _planar(self, rows: torch.Tensor) -> torch.Tensor:
        """Rows of ``_rows`` as the planar (K, 3, S, S) ``augment_fn`` takes:
        on the flat layout one permute-copy, the JAX flat gather's
        reshape-and-relayout."""
        return rows if self.layout == "planar" else rows.permute(0, 3, 1, 2).contiguous()

    def gather(self, idx: torch.Tensor) -> torch.Tensor:
        """Corpus rows ``idx`` (int32 on the device) as planar (K, 3, S, S)
        uint8 images: one K2 launch, or one K3 launch and a permute-copy."""
        return self._planar(self._rows(idx))

    def exchange(self, idx: torch.Tensor) -> torch.Tensor:
        """The planar images of this rank's part (``batch_sharding``) of the
        global group ``idx`` (int32 corpus rows on the card), from the
        shards: K2 (K3 on the flat layout) gathers the rows held here, the
        others become zeros, and one ``reduce_scatter`` sums the ranks'
        groups and deals each its part."""
        held = self.images.shape[0]
        loc = idx - self.row0
        own = (loc >= 0) & (loc < held)
        part = self._rows(loc.clamp(0, held - 1))
        part = torch.where(own[:, None, None, None], part, torch.zeros((), dtype=part.dtype, device=part.device))
        out = torch.empty((idx.shape[0] // self.mesh.size,) + tuple(part.shape[1:]), dtype=part.dtype,
                          device=part.device)
        return self._planar(reduce_scatter_sum(out, part, self.mesh.group))


class DeviceDataPipeline:
    """Train batches augmented on the card, from a corpus held there
    (``device_cache=True``) or loaded per step by a host thread
    (``device_cache=False``); fake draws or JPEG files (``fake_mode``)."""

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
        corpus: Optional[DeviceCorpus] = None,
        root_dir: Optional[Path] = None,
        enable_ram_cache: bool = False,
        prefetch: int = 2,
        mesh: Optional[DataMesh] = None,
        corpus_sharding: str = "replicated",
        warp_pallas: Union[bool, str] = "auto",
    ):
        check_layout(corpus_layout)
        refuse_model_axis(mesh)
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.group is not None else None
        self.sharded = corpus_sharding == "sharded"
        if corpus_sharding not in ("replicated", "sharded"):
            raise ValueError(f"corpus_sharding must be 'replicated' or 'sharded', got {corpus_sharding!r}")
        if self.sharded and not (device_cache and self.mesh is not None):
            raise ValueError("corpus_sharding='sharded' spreads the corpus on the card over the ranks of a "
                             "mesh: it needs device_cache=True and a mesh with a process group")
        if self.sharded and self.device.type == "cuda" and self.mesh.backend != "nccl":
            raise ValueError(f"the sharded corpus's exchange on the card needs NCCL, not {self.mesh.backend}")
        self.info = dataset_info
        self.S = target_size
        self.B = batch_size  # the batch of one host
        self.hosts, self.host = (self.mesh.hosts, self.mesh.host) if self.mesh is not None else (1, 0)
        self.rows = batch_sharding(self.mesh, batch_size * self.hosts)  # this rank's rows of the global batch
        self.aug = aug_params
        self.max_targets = max_targets
        self.mixup_prob = mixup_prob
        self.use_mosaic = use_mosaic
        self.sampler = sampler
        self.fake_mode = fake_mode
        self.device_cache = device_cache
        self.corpus_layout = corpus_layout  # the corpus on the card's; host-fed, it changes nothing
        self.root_dir = Path(root_dir) if root_dir else get_root_dir()
        self.enable_ram_cache = enable_ram_cache
        self.prefetch = prefetch
        self.image_repeat_factors = getattr(sampler, "image_repeat_factors", None)
        self.pyrng = pyrandom.Random(seed)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        # the fast warp's kernel, resolved as the JAX package resolves its
        # Pallas warp: "auto" or True take K5, False (or "false") pins the
        # dense bf16 products; the exact warp has no kernel
        if warp_precision not in ("fast", "exact"):
            raise ValueError(f"warp_precision must be 'fast' or 'exact', got {warp_precision!r}")
        if warp_precision == "fast" and str(warp_pallas).lower() == "false":
            warp_precision = "fast_dense"
        self.warp_precision = warp_precision
        self.augment_fn = build_device_augment_fn(
            target_size, aug_params, mixup_prob, max_targets, use_mosaic,
            warp_precision, feed_dtype)
        # valid targets dropped by max_targets: device scalars, summed on read
        self._overflow_done = 0
        self._overflow_pending: list = []
        # every epoch plan drawn, rows per step (FIFO): the trainer counts
        # the instances of the epoch it trained without drawing the sampler
        self.consumed_plan_log: deque = deque(maxlen=8)
        # host-fed JPEG images decoded so far (one decode per image in all)
        self._image_cache: dict = {}
        if not device_cache:
            if corpus is not None:
                raise ValueError("corpus is the card-resident corpus of device_cache=True")
            self.device_corpus = self.corpus = self.sizes = None
            self.src_T, *targets = target_arrays(dataset_info, target_size)
            self.t_boxes, self.t_labels, self.t_mask = (
                torch.from_numpy(a).to(self.device) for a in targets)
            return
        if corpus is None and self.sharded:
            corpus = DeviceCorpus.sharded(dataset_info, target_size, self.mesh, fake_mode, self.root_dir,
                                          corpus_layout)
        elif corpus is None:
            corpus = (DeviceCorpus.fake(dataset_info, target_size, self.device, corpus_layout) if fake_mode
                      else DeviceCorpus.decode(dataset_info, target_size, self.device, self.root_dir,
                                               corpus_layout))
        elif (corpus.info is not dataset_info or corpus.S != target_size
              or corpus.device != self.device or (corpus.mesh is not None) != self.sharded):
            raise ValueError("corpus was built for another dataset, image size, device or sharding")
        elif corpus.layout != corpus_layout:
            raise ValueError(f"corpus holds the {corpus.layout!r} layout and this pipeline asks for "
                             f"corpus_layout={corpus_layout!r}: build or share a corpus of that layout")
        self.device_corpus = corpus
        self.src_T = corpus.src_T
        self.corpus, self.sizes = corpus.images, corpus.sizes
        self.t_boxes, self.t_labels, self.t_mask = corpus.t_boxes, corpus.t_labels, corpus.t_mask

    def __len__(self) -> int:
        return len(self.info.samples) // self.B

    @property
    def overflow_total(self) -> int:
        """Total valid targets dropped by max_targets so far (one fetch)."""
        if self._overflow_pending:
            pending, self._overflow_pending = self._overflow_pending, []
            self._overflow_done += int(torch.stack(pending).sum())
        return self._overflow_done

    def add_overflow(self, n: int) -> None:
        """Count ``n`` dropped targets of steps run with ``track_overflow=False``,
        fetched by the caller (the trainer, with its per-epoch metrics)."""
        self._overflow_done += int(n)

    # -------------------------- the epoch --------------------------
    def _epoch_plan(self, B: Optional[int] = None, shard_for_host: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """One epoch's corpus rows per step, ``(groups, secs)``, drawn as the
        JAX package's ``_epoch_plan(B, shard_for_host)`` draws them in the
        process of this host (``process_index`` = host, ``process_count`` =
        hosts), advancing the sampler and ``pyrng`` alike on every host:
        ``groups`` (steps, 4B) with mosaic or (steps, B) without, ``secs``
        (steps, 4B) under mixup, else (steps, 0); ``B`` by default the
        host's batch."""
        return self._draw_plans(self.B if B is None else B, shard_for_host, [self.host])[0]

    def _draw_plans(self, B: int, shard_for_host: bool, hosts: Sequence[int]) -> list:
        """``_epoch_plan`` for each host of ``hosts`` from one advance of the
        sampler and ``pyrng``: their ``(groups, secs)``. This host's plan is
        logged, and ``_plan_steps`` set to the steps every host's plan has."""
        n = len(self.info.samples)
        if self.sampler is not None:
            epoch_idx = np.asarray(self.sampler.epoch_indices())
        else:
            epoch_idx = np.random.default_rng(self.pyrng.randrange(2**31)).permutation(n)
        sharded_host = shard_for_host and self.hosts > 1
        seed = self.pyrng.randrange(2**31)
        # read after epoch_indices(): the class-aware sampler replaces its
        # pool every epoch
        pool = getattr(self.sampler, "sampler_indices", None)
        pool = np.asarray(pool if pool is not None else np.arange(n), np.int64)
        p = None
        if self.image_repeat_factors is not None:
            p = np.asarray(self.image_repeat_factors, np.float64)
            p = p / p.sum()
        plans = []
        for h in hosts:
            idx = np.asarray(shard_indices(epoch_idx, h, self.hosts) if sharded_host else epoch_idx, np.int64)
            # per-host co-samples, from one pyrng advance shared by the hosts
            rng = np.random.default_rng((seed, h) if sharded_host else seed)

            def draw(k):
                if k == 0:
                    return np.zeros((0,), np.int64)
                return pool[rng.choice(len(pool), size=k, p=p)]

            n_batches = len(idx) // B
            n_prim = n_batches * B
            if self.use_mosaic:
                # per primary: [primary, co1, co2, co3] shuffled within the quad
                quads = np.concatenate([idx[:n_prim, None], draw(3 * n_prim).reshape(n_prim, 3)], 1)
                quads = rng.permuted(quads, axis=1)
                groups = quads.reshape(n_batches, 4 * B)
            else:
                groups = idx[:n_prim].reshape(n_batches, B)
            if self.mixup_prob > 0.0:
                secs = draw(4 * n_prim).reshape(n_batches, 4 * B)
            else:
                secs = np.zeros((n_batches, 0), np.int64)
            if h == self.host:
                # mixup co-mosaics are counted whatever the per-image coin,
                # which is drawn on the card
                self.consumed_plan_log.append(np.concatenate([groups, secs], 1) if secs.size else groups)
            plans.append((groups, secs))
        # the smallest host's shard: every host runs as many steps
        self._plan_steps = (len(epoch_idx) // self.hosts if sharded_host else len(epoch_idx)) // B
        return plans

    def _planned(self, max_steps: Optional[int], fused: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """The plan this rank's gathers read from: the fused epoch's one
        global plan at ``hosts * B``; the step loop's host plan or, over a
        sharded corpus on several hosts, every host's plan side by side in
        host order (each row a global group). Cut to the steps every host
        has, then to ``max_steps`` (the whole plan is logged); its rows
        checked on the host to lie in the corpus."""
        if fused:
            plans = [self._epoch_plan(self.B * self.hosts, shard_for_host=False)]
        elif self.sharded and self.hosts > 1:
            plans = self._draw_plans(self.B, True, range(self.hosts))
        else:
            plans = [self._epoch_plan()]
        steps = self._plan_steps if max_steps is None else min(self._plan_steps, int(max_steps))
        groups = np.concatenate([g[:steps] for g, _ in plans], 1)
        secs = np.concatenate([s[:steps] for _, s in plans], 1)
        n = len(self.info.samples)
        for rows in (groups, secs):
            if rows.size and (rows.min() < 0 or rows.max() >= n):
                raise IndexError(f"epoch plan row outside [0, {n})")
        return groups, secs

    def _columns(self, rows: np.ndarray, fused: bool = False) -> slice:
        """This rank's columns of a plan's rows (the quads of its
        primaries): of the fused epoch's global plan by its global rank, of
        its host's plan by its rank on the host."""
        return (batch_sharding if fused else host_batch_sharding)(self.mesh, rows.shape[1])

    def _rank_plan(self, groups: np.ndarray, secs: np.ndarray,
                   fused: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """The plan this rank's gathers read: its columns, or the whole
        global plan over a sharded corpus (every rank takes part in every
        row's exchange)."""
        if self.mesh is None or self.sharded:
            return groups, secs
        return (groups[:, self._columns(groups, fused)],
                secs[:, self._columns(secs, fused)] if secs.size else secs)

    def gather(self, idx: torch.Tensor) -> DeviceSample:
        """Corpus rows ``idx`` as planar images (one K2 launch; on the flat
        layout one K3 launch and a permute-copy) and their sizes and
        targets. Over a sharded corpus ``idx`` is a global group and the
        sample is this rank's part of it (``DeviceCorpus.exchange``)."""
        if self.corpus is None:
            raise RuntimeError("gather reads the corpus on the card: device_cache=True")
        rows = idx.long()
        if self.sharded:
            images = self.device_corpus.exchange(idx)
            rows = rows[batch_sharding(self.mesh, idx.shape[0])]
        else:
            images = self.device_corpus.gather(idx)
        return DeviceSample(images, self.sizes[rows], self.t_boxes[rows], self.t_labels[rows], self.t_mask[rows])

    def _load_group(self, indices, keep: slice = slice(None)) -> RawImages:
        """The images of corpus rows ``indices`` on the host, decoded but not
        yet letterboxed, in pinned memory on a card machine (the JAX
        package's ``_load_group``, which letterboxes too; targets stay on the
        device). Fake mode draws each row's content, at its content size,
        from a generator seeded by ``hash(tuple(indices))``, which is
        deterministic for integers; JPEG mode decodes the files
        (``native_loader.decode_images``) or, with ``enable_ram_cache``,
        decodes each image once and takes it from the cache after that. Only
        the rows ``keep`` of the group are returned and, from JPEG files,
        read; fake mode draws every row's content in order, as the stream is
        the group's. A file that fails to decode raises ``ValueError``."""
        start, stop, _ = keep.indices(len(indices))
        kept = indices[keep]
        pin = self.device.type == "cuda"
        if self.fake_mode:
            rng = np.random.default_rng(abs(hash(tuple(indices))) % (2**31))
            images = []
            for i, idx in enumerate(indices):
                h, w = content_size(self.info.samples[idx].image_metadata, self.S)
                content = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                if start <= i < stop:
                    images.append(content)
            return RawImages.from_arrays(images, pin)
        if self.enable_ram_cache:
            missing = [i for i in dict.fromkeys(int(i) for i in kept) if i not in self._image_cache]
            decoded = native_loader.decode_images(read_files(self.info, missing, self.root_dir))
            self._image_cache.update(zip(missing, decoded))
            images = [self._image_cache[int(i)] for i in kept]
        else:
            images = native_loader.decode_images(read_files(self.info, kept, self.root_dir))
        raw = RawImages.from_arrays(images, pin)
        if raw.failures:
            raise ValueError(f"{raw.failures} of {len(images)} JPEG files failed to decode")
        return raw

    def ram_cache_held(self) -> Tuple[int, int]:
        """(images, bytes) the RAM cache holds: decoded RGB images, before the letterbox."""
        return len(self._image_cache), sum(a.nbytes for a in self._image_cache.values() if a is not None)

    def upload(self, group: RawImages, rows: torch.Tensor) -> DeviceSample:
        """A loaded group on the device: its decoded images copied up and
        letterboxed into planar rows there (``ops/letterbox.py``), with the
        targets of corpus rows ``rows`` gathered from the arrays on the
        device. The copy from pinned memory does not block the host; torch's
        pinned allocator does not hand the buffer out again before the copy
        ends."""
        images = torch.empty((group.hw.shape[0], 3, self.S, self.S), dtype=torch.uint8, device=self.device)
        sizes = letterbox(*group.to(self.device)[:3], images)
        r = rows.long()
        return DeviceSample(images, sizes, self.t_boxes[r], self.t_labels[r], self.t_mask[r])

    def draw(self) -> AugmentDraws:
        """One step's draws from the pipeline's generator: under a mesh the
        global batch's (``hosts * B``), of which this rank keeps its rows."""
        draws = draw_augment(self.gen, self.B * self.hosts, self.S, self.aug, self.use_mosaic, self.mixup_prob)
        return draws if self.mesh is None else draws.rows(self.rows)

    def gather_augment(self, idx: torch.Tensor, draws: AugmentDraws,
                       idx2: Optional[torch.Tensor] = None) -> Tuple[Batch, torch.Tensor]:
        """idx (4B,) or, without mosaic, (B,) int32 on the card -> (Batch, overflow).

        Under mixup ``idx2`` (4B,) names the secondary group's rows, gathered
        by a second gather (K2, or K3 on the flat layout).
        """
        self._check_secondary(idx2)
        secondary = self.gather(idx2) if idx2 is not None else None
        return self.augment_fn(self.gather(idx), draws, secondary)

    def load_augment(self, group: np.ndarray, draws: AugmentDraws,
                     group2: Optional[np.ndarray] = None) -> Tuple[Batch, torch.Tensor]:
        """The host-fed form of ``gather_augment``: corpus rows ``group`` (and
        ``group2`` under mixup), a numpy int array, loaded on the host,
        uploaded, augmented."""
        self._check_secondary(group2)

        def sample(rows):
            idx = torch.from_numpy(np.asarray(rows, np.int64)).to(self.device)
            return self.upload(self._load_group(rows), idx)

        return self.augment_fn(sample(group), draws, None if group2 is None else sample(group2))

    def _check_secondary(self, second) -> None:
        if (second is not None) != (self.mixup_prob > 0.0):
            raise ValueError("idx2 is given exactly when mixup_prob > 0")

    def _host_fed(self, groups: np.ndarray, secs: np.ndarray, plan: torch.Tensor,
                  plan2: Optional[torch.Tensor]) -> Iterator[Tuple[DeviceSample, Optional[DeviceSample]]]:
        """Per step, the (primary, secondary) samples on the device: a producer
        thread loads the step's groups (this rank's columns of its host's
        ``groups`` and ``secs``) on the host up to ``prefetch`` steps ahead;
        this generator uploads them in step order. A producer's exception is
        raised here."""
        q: queue.Queue = queue.Queue(maxsize=max(self.prefetch, 1))
        stop = threading.Event()
        cols, cols2 = self._columns(groups), self._columns(secs) if secs.size else None

        def producer():
            try:
                for i in range(len(groups)):
                    item = (self._load_group(groups[i], cols),
                            self._load_group(secs[i], cols2) if secs.size else None)
                    if not put_unless_stopped(q, item, stop):
                        return
            except Exception as e:  # handed to the consumer, which raises it
                put_unless_stopped(q, e, stop)
            finally:
                put_unless_stopped(q, None, stop)

        threading.Thread(target=producer, daemon=True, name="host-fed-loader").start()
        try:
            for i in itertools.count():
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                prim, sec = item
                yield self.upload(prim, plan[i]), None if sec is None else self.upload(sec, plan2[i])
        finally:
            stop.set()

    def epoch(self, max_steps: Optional[int] = None,
              track_overflow: bool = True) -> Iterator[Tuple[Batch, torch.Tensor]]:
        """Yield ``(Batch, overflow)`` per step of one epoch.

        The whole epoch's plan goes to the card in one copy after a range
        check on the host. Each step draws its randoms on the card, in step
        order, and augments its groups (two under mixup): with the corpus on
        the card K2 (K3 on the flat layout) gathers each group; host-fed, a
        thread loads the groups (``_host_fed``) and each is copied up. Then K5 (on the fused fast
        path) and K4 once per group. Overflow counts stay on the card until
        ``overflow_total`` is read; with ``track_overflow=False`` they are
        only yielded, and the caller adds them (``add_overflow``).
        """
        groups, secs = self._planned(max_steps)
        mine, mine2 = self._rank_plan(groups, secs)
        plan = torch.from_numpy(mine.astype(np.int32)).to(self.device)
        plan2 = torch.from_numpy(mine2.astype(np.int32)).to(self.device) if mine2.size else None
        if self.device_cache:
            steps = ((self.gather(plan[i]), None if plan2 is None else self.gather(plan2[i]))
                     for i in range(plan.shape[0]))
        else:
            steps = self._host_fed(groups, secs, plan, plan2)
        for primary, secondary in steps:
            batch, ovf = self.augment_fn(primary, self.draw(), secondary)
            if track_overflow:
                self._overflow_pending.append(ovf)
            yield batch, ovf

    # ------------------------- the fused epoch -------------------------
    @property
    def device_arrays(self) -> Tuple[torch.Tensor, ...]:
        """What the fused epoch gathers from: the corpus, its sizes and its
        per-image targets, ``(images, sizes, boxes, labels, mask)``."""
        if self.corpus is None:
            raise RuntimeError("the fused epoch reads the corpus on the card: device_cache=True")
        return self.corpus, self.sizes, self.t_boxes, self.t_labels, self.t_mask

    def epoch_host_arrays(self, max_steps: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
        """One epoch's plan for the fused epoch, a row per step: ``(groups,)``
        or, under mixup, ``(groups, secs)``, int32 tensors on the host
        (pinned on a card machine). Drawn through ``_epoch_plan``, so the
        sampler, ``pyrng`` and ``consumed_plan_log`` advance exactly as
        iterating ``epoch`` advances them; ``max_steps`` cuts the plan. The
        JAX package's version also returns a key per step; here the draws
        come from the pipeline's generator, in step order. Under a mesh the
        plan is one global plan at ``hosts * B`` (JAX's multi-host fused
        plan; on one host the step loop's), of which this rank takes its
        columns, or the whole of it over a sharded corpus."""
        groups, secs = self._rank_plan(*self._planned(max_steps, fused=True), fused=True)
        xs = (groups, secs) if self.mixup_prob > 0.0 else (groups,)
        pin = self.device.type == "cuda"
        return tuple(torch.from_numpy(x.astype(np.int32)).pin_memory() if pin
                     else torch.from_numpy(x.astype(np.int32)) for x in xs)

    def build_fused_epoch_fn(self, train_step, pipelined: bool = False, stack_metrics: bool = False,
                             graph: Optional[bool] = None) -> "FusedEpoch":
        """``epoch_fn(xs, *tables)``: every step of one epoch as gather ->
        augment -> ``train_step`` (the JAX package's ``build_fused_epoch_fn``,
        a scan in one program). See ``FusedEpoch``."""
        return FusedEpoch(self, train_step, pipelined, stack_metrics, graph)


def _leaves(tree) -> list:
    """The leaves of a metrics tree in the JAX package's order (fields in
    order, dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(template, leaves: Iterator):
    """``template``'s structure with its leaves taken from ``leaves``."""
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(t, leaves) for t in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(t, leaves) for t in template)
    return next(leaves)


def metric_column(metrics, overflow: torch.Tensor) -> torch.Tensor:
    """A step's metrics (a tensor, a float, or a tuple or dict of them;
    leaves in the JAX package's order) and its overflow, as one f32
    column on the overflow's device."""
    dev = overflow.device
    return torch.stack([x.float() if isinstance(x, torch.Tensor) else torch.full((), float(x), device=dev)
                        for x in _leaves(metrics)] + [overflow.float()])


def _copy_into(dst, src) -> None:
    for d, s in zip(_leaves(dst), _leaves(src)):
        d.copy_(s)


class FusedEpoch:
    """One epoch of gather -> augment -> train step per step, as the JAX
    package's fused epoch (``build_fused_epoch_fn``, one program a scan),
    from the corpus on the card.

    ``epoch_fn(xs, *tables)`` takes ``xs`` from ``epoch_host_arrays`` and
    any per-step tables (a leading dimension of steps; the trainer passes
    SmartSGD's hyperparameter table). Step i gathers plan row i (K2, or K3
    on the flat layout; twice under mixup), draws from the pipeline's generator, augments (K5, K4)
    and calls ``train_step(batch, *rows)`` with row i of each table; its
    metrics (a tensor, a float, or a tuple or dict of them) and the step's
    overflow go to column i of one ``f32[n_leaves + 1, steps]`` matrix,
    leaves in the JAX package's order, overflow last. The call returns that
    matrix with ``stack_metrics``, else ``(metrics tree of f32 rows,
    overflow)``. The batches are those of ``DeviceDataPipeline.epoch`` in
    the same order with the same draws. With ``pipelined`` batch i+1 is
    made before step i trains, into a second buffer, so the draws keep the
    batch order.

    Each step stamps its stage boundaries on the card's clock
    (``utils/tracing.py:mark``) into an int64 ``(len(MARKS), cap)`` stamp
    matrix, at the step counter's column: ``augment_begin`` and
    ``augment_end`` around the making of batch i (column i; on the forked
    stream when pipelined), the train step's own marks, and
    ``optimizer_end`` after the metric column. ``stamps`` holds the last
    call's stamps, ``(len(MARKS), steps)`` on the device, copied at the
    epoch's end.

    The step is one function on tensors: it reads its plan and table rows
    and writes its metric column by a step counter on the device. On the
    CPU (or with ``graph=False``) it runs eagerly. On the card it is
    captured as a CUDA graph (``ops/graph.py``) and replayed once per step:
    the first time, after ``WARMUP_STEPS`` steps run eagerly on a side
    stream (real steps of the epoch), and again only if an epoch outgrows
    the static buffers. Each later epoch copies its plan and tables into
    the static buffers (stream-ordered, so the call may be enqueued behind
    an epoch still running), resets the counter and replays. Pipelined, the
    next batch is made on a forked stream inside the graph, beside the
    train step; the last step replays a second graph that only trains, so
    the generator draws nothing past the epoch. A capture that fails
    raises; nothing runs eagerly in its place.

    The caller puts right what a capture leaves on the host: the capture
    runs ``train_step``'s Python once (``SmartSGD.step_count``), while the
    launch counts are counted by replay. The graph holds the addresses of
    the parameters, buffers and gradients: state is loaded in place
    (``load_state_dict`` copies), never rebound.
    """

    WARMUP_STEPS = 2

    def __init__(self, pipe: DeviceDataPipeline, train_step, pipelined: bool = False,
                 stack_metrics: bool = False, graph: Optional[bool] = None):
        if pipe.corpus is None:
            raise RuntimeError("the fused epoch gathers from the corpus on the card: device_cache=True")
        on_card = pipe.device.type == "cuda"
        self.graph = on_card if graph is None else bool(graph)
        if self.graph and not on_card:
            raise ValueError("a CUDA graph needs the pipeline on the card")
        if self.graph and pipe.mesh is not None and pipe.mesh.backend != "nccl":
            raise ValueError(f"the fused epoch on the card captures its collectives in a CUDA graph, which the "
                             f"{pipe.mesh.backend} backend cannot be captured in: use NCCL, the step loop "
                             "(data.fused_epoch=False) or an eager fused epoch (graph=False)")
        self.pipe, self.train_step = pipe, train_step
        self.pipelined, self.stack_metrics = bool(pipelined), bool(stack_metrics)
        self.graphs: dict = {}  # "body" (and "last" when pipelined): CapturedGraph
        self._cap = 0  # steps the static buffers hold
        self._plans: list = []
        self._tables: list = []
        self._i: Optional[torch.Tensor] = None  # the step counter, int64 on the device
        self._out: Optional[torch.Tensor] = None  # f32[n_leaves + 1, cap]
        self._stamps: Optional[torch.Tensor] = None  # int64[len(MARKS), cap]
        self.stamps: Optional[torch.Tensor] = None  # the last call's, (len(MARKS), steps)
        self._cur = None  # pipelined: (Batch, overflow) of the step that trains next
        self._template = None  # the structure of train_step's metrics
        self._stream = self._side = None  # capture stream; the fork's stream

    # ----- static buffers
    def _load(self, xs, tables) -> int:
        xs = [torch.as_tensor(x) for x in xs]
        tables = [torch.as_tensor(t) for t in tables]
        n = int(xs[0].shape[0])
        if n == 0:
            raise ValueError("an epoch of no steps")
        dev = self.pipe.device
        if n > self._cap or len(tables) != len(self._tables):
            cap = max(n, len(self.pipe))
            self._plans = [torch.empty((cap,) + tuple(x.shape[1:]), dtype=torch.int32, device=dev) for x in xs]
            self._tables = [torch.empty((cap,) + tuple(t.shape[1:]), dtype=t.dtype, device=dev) for t in tables]
            self._i = torch.zeros((), dtype=torch.int64, device=dev)
            self._stamps = tracing.stamp_matrix(cap, dev)
            self._out, self._cap, self.graphs = None, cap, {}
        for buf, x in zip(self._plans + self._tables, xs + tables):
            buf[:n].copy_(x, non_blocking=True)
        self._i.zero_()
        self._stamps.zero_()
        return n

    # ----- one step, as tensors
    def _make(self, i: torch.Tensor):
        """(Batch, overflow) of plan row ``i`` with the next draws."""
        tracing.mark("augment_begin", i)
        rows = [p.index_select(0, i.view(1))[0] for p in self._plans]
        made = self.pipe.gather_augment(rows[0], self.pipe.draw(), rows[1] if len(rows) > 1 else None)
        tracing.mark("augment_end", i)
        return made

    def _train(self, batch: Batch, overflow: torch.Tensor, i: torch.Tensor) -> None:
        rows = [t.index_select(0, i.view(1))[0] for t in self._tables]
        m = self.train_step(batch, *rows)
        self._template = _rebuild(m, iter([None] * len(_leaves(m))))
        col = metric_column(m, overflow)
        if self._out is None:
            self._out = torch.zeros((col.shape[0], self._cap), dtype=torch.float32, device=col.device)
        self._out.index_copy_(1, i.view(1), col[:, None])
        tracing.mark("optimizer_end")

    def _step(self) -> None:
        self._train(*self._make(self._i), self._i)
        self._i.add_(1)

    def _step_ahead(self) -> None:
        """Train the current batch while the next one is made (on the
        forked stream when there is one), then make the next one current."""
        if self._side is None:
            nxt = self._make(self._i + 1)
            self._train(*self._cur, self._i)
        else:
            main = torch.cuda.current_stream(self.pipe.device)
            self._side.wait_stream(main)
            with torch.cuda.stream(self._side):
                nxt = self._make(self._i + 1)
            self._train(*self._cur, self._i)
            main.wait_stream(self._side)
            if not torch.cuda.is_current_stream_capturing():  # in a graph the join orders its memory
                for t in _leaves(nxt):
                    t.record_stream(main)
        _copy_into(self._cur, nxt)
        self._i.add_(1)

    def _step_last(self) -> None:
        self._train(*self._cur, self._i)
        self._i.add_(1)

    # ----- the epoch
    def _warm_up(self, body, steps: int) -> None:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.pipe.device)
            if self.pipelined:
                self._side = torch.cuda.Stream(self.pipe.device)
        main = torch.cuda.current_stream(self.pipe.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            for _ in range(steps):
                body()
        main.wait_stream(self._stream)

    def _capture(self, body) -> None:
        gens = [self.pipe.gen]
        first = CapturedGraph(body, self._stream, "a fused-epoch step (gather, augment, train step)",
                              generators=gens)
        self.graphs = {"body": first}
        if self.pipelined:
            self.graphs["last"] = CapturedGraph(self._step_last, self._stream,
                                                "the fused epoch's last step (train step)",
                                                pool=first.pool(), generators=gens)

    def __call__(self, xs, *tables):
        n = self._load(xs, tables)
        with tracing.stamping(self._stamps, self._i):
            self._run(n)
        self.stamps = self._stamps[:, :n].clone()
        flat = self._out[:, :n].clone()
        if self.stack_metrics:
            return flat
        return _rebuild(self._template, iter(flat[:-1])), flat[-1].to(torch.int32)

    def _run(self, n: int) -> None:
        if self.pipelined:
            first = self._make(self._i)
            if self._cur is None:
                self._cur = first
            else:
                _copy_into(self._cur, first)
        body = self._step_ahead if self.pipelined else self._step
        n_body = n - 1 if self.pipelined else n
        done = 0
        if self.graph and not self.graphs:
            done = min(self.WARMUP_STEPS, n_body)
            self._warm_up(body, done)
            if n_body > done:
                self._capture(body)
        if self.graphs:
            for _ in range(done, n_body):
                self.graphs["body"].replay()
            if self.pipelined:
                self.graphs["last"].replay()
        else:
            for _ in range(done, n_body):
                body()
            if self.pipelined:
                self._step_last()
