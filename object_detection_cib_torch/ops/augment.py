"""On-device batched augmentation: mosaic, affine warp, HSV, flip, mixup.

Counterpart of ``object_detection_cib_tpu/ops/augment.py`` on planar
(B, 3, S, S) images (the layout of the corpus on the card; the pixel
arithmetic is per channel, so the layout changes no value):

  * ``mosaic_affine_batch``: the production path, a 4-image mosaic fused
    with an axis-aligned affine warp (degrees = shear = perspective = 0).
    ``precision="fast"`` is the sparse kernel of ``ops/warp.py`` (K5) over
    tap scalars; ``precision="fast_dense"`` (the JAX package's fast warp
    under ``warp_pallas=False``) two matrix products over dense windowed tap
    matrices in bf16; ``precision="exact"`` is the two products in f32, as
    the JAX package computes it (no kernel there either).
  * the composed path for every other recipe: ``mosaic4_batch`` (the 2S x 2S
    canvas, by index arithmetic instead of the TPU's pad + roll + select),
    ``affine_batch`` (the dense separable warp when axis-aligned, else the
    per-pixel inverse map through ``_bilinear_sample``), ``flip_batch`` and
    ``mixup_batch``.
  * ``hsv_batch``, the plain version of K4.

Nothing here reads a device value on the host: placements, windows and
coins stay tensors, so a step never waits for the card.

Randomness: every function takes its random draws as tensors (mosaic
centers, ``AffineBatchValues``, flip coins, HSV gains, the mixup ratio), so
tests can feed the JAX package's draws. The ``draw_*`` helpers make them
from an explicit ``torch.Generator`` on the tensors' device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from object_detection_cib_torch.ops.warp import FILL, warp_quadrants


class DeviceSample(NamedTuple):
    """Fixed-shape sample batch.

    images: (B, 3, S, S) uint8 planar sources (content in the top-left
            (h, w) window, rest FILL), or the augmented (B, 3, S, S) floats
    sizes:  (B, 2) int32 (h, w) content sizes
    boxes:  (B, T, 4) xyxy float32
    labels: (B, T) int32
    mask:   (B, T) bool
    """

    images: torch.Tensor
    sizes: torch.Tensor
    boxes: torch.Tensor
    labels: torch.Tensor
    mask: torch.Tensor


def _box_candidates_mask(orig, proc, mask, wh_thr=2.0, ar_thr=20.0, area_thr=0.1,
                         eps=1e-16):
    """Masked candidate filter (ref default.py:193-215)."""
    w1 = orig[..., 2] - orig[..., 0]
    h1 = orig[..., 3] - orig[..., 1]
    w2 = proc[..., 2] - proc[..., 0]
    h2 = proc[..., 3] - proc[..., 1]
    ar = torch.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    ok = (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)
    return mask & ok


# ---------------------------------------------------------------------------
# mosaic
# ---------------------------------------------------------------------------

def _mosaic_placement(sizes, center, target_size: int):
    """Per-quadrant canvas placement (ref mosaic.py:71-133), batched.

    sizes (G, 4, 2), center (G, 2) -> x1a, y1a, x2a, y2a, x1b, y1b, each
    (G, 4): destination rectangle [x1a, x2a) x [y1a, y2a) on the 2Sx2S
    canvas and the source-image origin (x1b, y1b) it is copied from.
    """
    S2 = 2 * target_size
    xc, yc = center[:, 0], center[:, 1]
    h, w = sizes[..., 0], sizes[..., 1]
    zero = torch.zeros_like(xc)
    x1a = torch.stack([(xc - w[:, 0]).clamp(min=0), xc, (xc - w[:, 2]).clamp(min=0), xc], -1)
    y1a = torch.stack([(yc - h[:, 0]).clamp(min=0), (yc - h[:, 1]).clamp(min=0), yc, yc], -1)
    x2a = torch.stack([xc, (xc + w[:, 1]).clamp(max=S2), xc, (xc + w[:, 3]).clamp(max=S2)], -1)
    y2a = torch.stack([yc, yc, (yc + h[:, 2]).clamp(max=S2), (yc + h[:, 3]).clamp(max=S2)], -1)
    x1b = torch.stack([w[:, 0] - (x2a[:, 0] - x1a[:, 0]), zero,
                       w[:, 2] - (x2a[:, 2] - x1a[:, 2]), zero], -1)
    y1b = torch.stack([h[:, 0] - (y2a[:, 0] - y1a[:, 0]), h[:, 1] - (y2a[:, 1] - y1a[:, 1]),
                       zero, zero], -1)
    return x1a, y1a, x2a, y2a, x1b, y1b


def _mosaic_boxes(boxes, labels, mask, x1a, y1a, x1b, y1b, S2):
    """Translate per-quadrant boxes onto the canvas + candidate filter.

    boxes (G, 4, T, 4), labels/mask (G, 4, T), placement (G, 4) ->
    (G, 4T, 4), (G, 4T), (G, 4T).
    """
    G, _, T, _ = boxes.shape
    padw = (x1a - x1b).float()
    padh = (y1a - y1b).float()
    shift = torch.stack([padw, padh, padw, padh], -1)  # (G, 4, 4)
    b = (boxes + shift[:, :, None, :]).reshape(G, 4 * T, 4)
    m = mask.reshape(G, 4 * T)
    trunc = b.clamp(0, S2)
    m = _box_candidates_mask(b, trunc, m, eps=1e-7)
    return b.clamp(0, S2 - 1), labels.reshape(G, 4 * T), m


def draw_mosaic_centers(gen: torch.Generator, groups: int, target_size: int) -> torch.Tensor:
    """(G, 2) int32 centers uniform in [S/2, 3S/2) (ref mosaic.py:58-62)."""
    S = target_size
    return torch.randint(S // 2, 2 * S - S // 2, (groups, 2), generator=gen,
                         device=gen.device, dtype=torch.int32)


def take_rows_cols(imgs: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """out[b, c, y, x] = imgs[b, c, rows[b, y], cols[b, x]].

    imgs (B, C, H, W); rows (B, Y) and cols (B, X) integer tensors already
    inside [0, H) and [0, W). Two ``torch.gather`` calls over expanded
    (never materialised) index views.
    """
    B, C, _, W = imgs.shape
    Y, X = rows.shape[1], cols.shape[1]
    picked = torch.gather(imgs, 2, rows.long()[:, None, :, None].expand(B, C, Y, W))
    return torch.gather(picked, 3, cols.long()[:, None, None, :].expand(B, C, Y, X))


def mosaic4_batch(sample: DeviceSample, centers: torch.Tensor, target_size: int) -> DeviceSample:
    """Group the batch into 4s and mosaic each group onto a 2S x 2S canvas.

    ``sample.images`` (B, 3, S, S) with B divisible by 4, ``centers``
    (B//4, 2) int -> canvas (B//4, 3, 2S, 2S) of the input dtype filled with
    FILL, target capacity 4T. A quadrant's placement is an integer
    translation, so each canvas pixel inside the quadrant's rectangle
    [x1a, x2a) x [y1a, y2a) reads source pixel (y - y1a + y1b, x - x1a + x1b);
    later quadrants overwrite earlier ones, as the JAX package's chain of
    selects does.
    """
    B, _, S, _ = sample.images.shape
    if B % 4:
        raise ValueError(f"batch {B} is not divisible by 4")
    G = B // 4
    S2 = 2 * target_size
    dev = sample.images.device
    imgs = sample.images.reshape(G, 4, 3, S, S)
    x1a, y1a, x2a, y2a, x1b, y1b = _mosaic_placement(
        sample.sizes.reshape(G, 4, 2), centers, target_size)
    mb, ml, mm = _mosaic_boxes(sample.boxes.reshape(G, 4, -1, 4), sample.labels.reshape(G, 4, -1),
                               sample.mask.reshape(G, 4, -1), x1a, y1a, x1b, y1b, S2)
    pos = torch.arange(S2, dtype=torch.int32, device=dev)[None]  # canvas row or column
    canvas = torch.full((G, 3, S2, S2), int(FILL), dtype=sample.images.dtype, device=dev)
    for q in range(4):
        in_y = (pos >= y1a[:, q, None]) & (pos < y2a[:, q, None])  # (G, 2S)
        in_x = (pos >= x1a[:, q, None]) & (pos < x2a[:, q, None])
        # inside the rectangle the source index lies in [0, S); the clamp
        # only keeps the unused reads outside it in range
        src_y = (pos - (y1a - y1b)[:, q, None]).clamp(0, S - 1)
        src_x = (pos - (x1a - x1b)[:, q, None]).clamp(0, S - 1)
        placed = take_rows_cols(imgs[:, q], src_y, src_x)
        canvas = torch.where((in_y[:, :, None] & in_x[:, None, :])[:, None], placed, canvas)
    out_sizes = torch.full((G, 2), S2, dtype=torch.int32, device=dev)
    return DeviceSample(canvas, out_sizes, mb, ml, mm)


# ---------------------------------------------------------------------------
# affine
# ---------------------------------------------------------------------------

class AffineBatchValues(NamedTuple):
    """Per-image affine randoms, (B,) each (semantics of ref AffineRandValues)."""

    perspective_x: torch.Tensor
    perspective_y: torch.Tensor
    degrees: torch.Tensor
    scale: torch.Tensor
    shear_x: torch.Tensor
    shear_y: torch.Tensor
    translate_x: torch.Tensor
    translate_y: torch.Tensor


def draw_affine_values(
    gen: torch.Generator,
    batch: int,
    degrees: float = 0.0,
    translate: float = 0.1,
    scale: float = 0.5,
    shear: float = 0.0,
    perspective: float = 0.0,
) -> AffineBatchValues:
    """Uniform draws in the ranges of ``sample_affine_values_batch``."""

    def u(lo, hi):
        return torch.rand(batch, generator=gen, device=gen.device) * (hi - lo) + lo

    return AffineBatchValues(
        perspective_x=u(-perspective, perspective),
        perspective_y=u(-perspective, perspective),
        degrees=u(-degrees, degrees),
        scale=u(1 - scale, 1 + scale),
        shear_x=u(-shear, shear),
        shear_y=u(-shear, shear),
        translate_x=u(0.5 - translate, 0.5 + translate),
        translate_y=u(0.5 - translate, 0.5 + translate),
    )


def _affine_matrices(v: AffineBatchValues, in_w, in_h, out_w, out_h):
    """Batched M = T@S@R@P@C (ref default.py:218-247). Returns (B, 3, 3)."""
    zeros = torch.zeros_like(v.degrees)
    ones = torch.ones_like(v.degrees)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    C = mat([[ones, zeros, -ones * (in_w / 2)],
             [zeros, ones, -ones * (in_h / 2)],
             [zeros, zeros, ones]])
    P = mat([[ones, zeros, zeros],
             [zeros, ones, zeros],
             [v.perspective_x, v.perspective_y, ones]])
    rad = v.degrees * (math.pi / 180.0)
    cos, sin = torch.cos(rad) * v.scale, torch.sin(rad) * v.scale
    R = mat([[cos, sin, zeros],
             [-sin, cos, zeros],
             [zeros, zeros, ones]])
    sx = torch.tan(v.shear_x * (math.pi / 180.0))
    sy = torch.tan(v.shear_y * (math.pi / 180.0))
    S = mat([[ones, sx, zeros],
             [sy, ones, zeros],
             [zeros, zeros, ones]])
    T = mat([[ones, zeros, v.translate_x * out_w],
             [zeros, ones, v.translate_y * out_h],
             [zeros, zeros, ones]])
    return T @ S @ R @ P @ C


def _affine_boxes(boxes, mask, values: AffineBatchValues, M, out_size: int):
    """4-corner box transform + candidate filter (ref default.py:250-276)."""
    B = boxes.shape[0]
    b = boxes
    corners = torch.stack(
        [b[..., 0], b[..., 1], b[..., 2], b[..., 3],
         b[..., 0], b[..., 3], b[..., 2], b[..., 1]], -1,
    ).reshape(B, -1, 4, 2)
    hom = torch.cat([corners, torch.ones_like(corners[..., :1])], -1)  # (B, T, 4, 3)
    proj = torch.einsum("btcj,bij->btci", hom, M)
    persp = (values.perspective_x != 0.0) | (values.perspective_y != 0.0)
    xy = torch.where(persp[:, None, None, None], proj[..., :2] / proj[..., 2:3], proj[..., :2])
    hi = out_size - 1
    proc = torch.stack([
        xy[..., 0].amin(-1).clamp(0, hi), xy[..., 1].amin(-1).clamp(0, hi),
        xy[..., 0].amax(-1).clamp(0, hi), xy[..., 1].amax(-1).clamp(0, hi),
    ], -1)
    new_mask = _box_candidates_mask(boxes * values.scale[:, None, None], proc, mask)
    return proc, new_mask


def _require_f32_matmul(t: torch.Tensor) -> None:
    """The dense warps are f32 products of bilinear taps: TF32 would round
    the taps to 10 mantissa bits, so it must be off on the card."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the dense f32 warp needs torch.backends.cuda.matmul.allow_tf32 = False")


def _bilinear_sample(imgs: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """imgs (B, 3, H, W) float; xs/ys (B, h, w) float sample coords -> (B, 3, h, w).

    cv2 5.x warpAffine INTER_LINEAR: four taps, each replaced by FILL when
    out of bounds, blended along x then along y in f32, rounded to the
    integer grid (half to even). Not ``grid_sample``, whose border handling
    and rounding differ.
    """
    B, C, H, W = imgs.shape
    h, w = xs.shape[1:]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = (xs - x0)[:, None]
    fy = (ys - y0)[:, None]
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    flat = imgs.reshape(B, C, H * W)
    fill = torch.full((), FILL, dtype=imgs.dtype, device=imgs.device)

    def at(yi, xi):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        lin = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long().reshape(B, 1, h * w)
        v = torch.gather(flat, 2, lin.expand(B, C, h * w)).reshape(B, C, h, w)
        return torch.where(inb[:, None], v, fill)

    v00 = at(y0i, x0i)
    v01 = at(y0i, x0i + 1)
    v10 = at(y0i + 1, x0i)
    v11 = at(y0i + 1, x0i + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return torch.round(top * (1 - fy) + bot * fy)


def _dense_taps(i0: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor, n: int) -> torch.Tensor:
    """(..., out, n) matrix with w0 at column i0 and w1 at column i0 + 1."""
    j = torch.arange(n, dtype=torch.int32, device=i0.device)
    return w0[..., None] * (j == i0[..., None]) + w1[..., None] * (j == (i0 + 1)[..., None])


def _tap_matrix(s: torch.Tensor, n: int):
    """Bilinear 1-D sampling operator: s (B, out) float source coords ->
    A (B, out, n) tap weights (out-of-bounds taps zeroed) and cov (B, out),
    the in-bounds weight mass (1 - cov is FILL's share)."""
    i0f = torch.floor(s)
    f = s - i0f
    i0 = i0f.to(torch.int32)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    w0 = torch.where((i0 >= 0) & (i0 < n), 1.0 - f, zero)
    w1 = torch.where((i0 + 1 >= 0) & (i0 + 1 < n), f, zero)
    return _dense_taps(i0, w0, w1, n), w0 + w1


def _axis_aligned_warp(imgs: torch.Tensor, minv: torch.Tensor, out_size: int) -> torch.Tensor:
    """Separable scale + translate warp as two f32 batched matrix products.

    imgs (B, 3, H, W) f32, minv (B, 3, 3) with minv[0, 1] == minv[1, 0] == 0
    and no perspective -> (B, 3, out, out). The x pass computes
    v0 * (1 - fx) + v1 * fx with FILL for each out-of-bounds tap
    (``(1 - cov) * FILL`` added after the product), the y pass likewise.
    """
    _require_f32_matmul(imgs)
    _, _, H, W = imgs.shape
    o = torch.arange(out_size, dtype=torch.float32, device=imgs.device)
    z = minv[:, 2, 2, None]
    sx = (minv[:, 0, 0, None] * o + minv[:, 0, 2, None]) / z  # (B, out)
    sy = (minv[:, 1, 1, None] * o + minv[:, 1, 2, None]) / z
    Ax, covx = _tap_matrix(sx, W)
    Ay, covy = _tap_matrix(sy, H)
    h1 = torch.einsum("bchw,bxw->bchx", imgs, Ax)
    h1 = h1 + ((1.0 - covx) * FILL)[:, None, None, :]
    out = torch.einsum("byh,bchx->bcyx", Ay, h1)
    out = out + ((1.0 - covy) * FILL)[:, None, :, None]
    # the product comes back as a permuted view; the stages after it
    # (the HSV kernel among them) take contiguous planar images
    return torch.round(out).contiguous()


def affine_batch(sample: DeviceSample, values: AffineBatchValues, out_size: int,
                 border=(0, 0), axis_aligned: bool = False) -> DeviceSample:
    """Warp images (B, 3, H, W) f32 and boxes; candidate-filter boxes into the mask.

    For the mosaic path the input canvas is 2S x 2S with border
    (-S//2, -S//2), giving an S x S output. ``axis_aligned`` promises
    degrees == shear == perspective == 0 and takes the dense separable
    warp; otherwise each output pixel maps through the inverse matrix
    (divided by the third coordinate, so perspective is covered) and is
    sampled by ``_bilinear_sample``.
    """
    B, _, H, W = sample.images.shape
    in_w = W + border[1] * 2
    in_h = H + border[0] * 2
    if in_w != out_size or in_h != out_size:
        raise ValueError(f"input {H}x{W} with border {border} is not {out_size}x{out_size}")
    dev = sample.images.device
    M = _affine_matrices(values, W, H, in_w, in_h)
    # inv_ex: no singularity check, which would wait for the device
    Minv = torch.linalg.inv_ex(M).inverse
    if axis_aligned:
        out_imgs = _axis_aligned_warp(sample.images, Minv, out_size)
    else:
        o = torch.arange(out_size, dtype=torch.float32, device=dev)
        yy, xx = torch.meshgrid(o, o, indexing="ij")
        dst = torch.stack([xx, yy, torch.ones_like(xx)], -1)  # (h, w, 3)
        # src = dst @ Minv.T as three multiply-adds per coordinate: the
        # order of a 3-term dot is fixed, whatever the matmul settings
        m = Minv[:, None, None]  # (B, 1, 1, 3, 3)
        src = dst[..., 0, None] * m[..., 0] + dst[..., 1, None] * m[..., 1] + dst[..., 2, None] * m[..., 2]
        out_imgs = _bilinear_sample(sample.images, src[..., 0] / src[..., 2], src[..., 1] / src[..., 2])
    proc, new_mask = _affine_boxes(sample.boxes, sample.mask, values, M, out_size)
    out_sizes = torch.full((B, 2), out_size, dtype=torch.int32, device=dev)
    return DeviceSample(out_imgs, out_sizes, proc, sample.labels, new_mask)


# ---------------------------------------------------------------------------
# fused mosaic + axis-aligned affine (the production path)
# ---------------------------------------------------------------------------

def _tap_scalars_windowed(s: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """Per-row bilinear taps with the quadrant window applied.

    s (B, out) float source coords, lo/hi (B,) int window -> (j0 int32,
    w0, w1), each (B, out): tap k sits at source index j0+k with weight wk,
    zeroed outside [lo, hi).
    """
    i0f = torch.floor(s)
    f = s - i0f
    i0 = i0f.to(torch.int32)
    lo, hi = lo[:, None], hi[:, None]
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    w0 = torch.where((i0 >= lo) & (i0 < hi), 1.0 - f, zero)
    w1 = torch.where((i0 + 1 >= lo) & (i0 + 1 < hi), f, zero)
    return i0, w0, w1


def _tap_matrix_windowed(s: torch.Tensor, n: int, lo: torch.Tensor, hi: torch.Tensor):
    """Dense (B, out, n) form of ``_tap_scalars_windowed``."""
    return _dense_taps(*_tap_scalars_windowed(s, lo, hi), n)


# the fused mosaic warp's precisions: K5, the dense bf16 products, the dense f32 products
WARP_PRECISIONS = ("fast", "fast_dense", "exact")


def mosaic_affine_batch(
    sample: DeviceSample,
    centers: torch.Tensor,
    values: AffineBatchValues,
    target_size: int,
    flip_do: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
    precision: str = "fast",
) -> DeviceSample:
    """Fused 4-image mosaic + axis-aligned affine warp, canvas-free.

    The JAX package's ``mosaic_affine_batch(..., planar=True)``: sample
    images (B, 3, S, S) uint8, B divisible by 4, ``centers`` (B//4, 2) int,
    ``values`` (B//4,) each. Output (B//4, 3, S', S') ``out_dtype`` with
    S' = ``target_size`` and target capacity 4T. ``flip_do`` (B//4,) bool
    folds the horizontal flip into the x taps; the boxes are flipped by the
    caller (``flip_boxes``).

    ``precision="fast"`` is one launch of K5 (``ops/warp.py``), bf16
    operands with f32 accumulation. ``precision="fast_dense"`` is the
    JAX package's dense bf16 branch (its ``warp_pallas=False``):
    ``img - FILL``, ``Ax`` and ``Ay`` stored in bf16, the x pass a bf16
    product (accumulated in f32, stored in bf16), the y pass accumulated in
    f32 over the bf16 values (a product of two bf16 values is exact in f32,
    and bf16 values are exact in TF32, so the card's TF32 switch changes
    nothing), then ``round(out + FILL)``; it launches no kernel.
    ``precision="exact"`` is
    ``FILL + sum_q Ay_q @ (img_q - FILL) @ Ax_q^T`` in f32 over dense
    windowed tap matrices, which reproduces the composed path
    (``affine_batch(mosaic4_batch(...), axis_aligned=True)``) up to the
    summation order ahead of the rounding; as in the JAX package it is two
    plain matrix products and launches no kernel.
    """
    if precision not in WARP_PRECISIONS:
        raise ValueError(f"precision must be one of {WARP_PRECISIONS}, got {precision!r}")
    B, _, S, _ = sample.images.shape
    if B % 4:
        raise ValueError(f"batch {B} is not divisible by 4")
    G = B // 4
    S2 = 2 * target_size
    dev = sample.images.device
    imgs = sample.images.reshape(G, 4, 3, S, S)
    sizes = sample.sizes.reshape(G, 4, 2)
    boxes = sample.boxes.reshape(G, 4, -1, 4)
    labels = sample.labels.reshape(G, 4, -1)
    mask = sample.mask.reshape(G, 4, -1)

    placement = _mosaic_placement(sizes, centers, target_size)
    x1a, y1a, _, _, x1b, y1b = placement
    mb, ml, mm = _mosaic_boxes(boxes, labels, mask, x1a, y1a, x1b, y1b, S2)

    M = _affine_matrices(values, S2, S2, target_size, target_size)
    taps = mosaic_warp_taps(M, placement, target_size, flip_do)
    if precision == "fast":
        out_imgs = warp_quadrants(imgs.contiguous(), *taps, out_dtype=out_dtype)
    else:
        jx0, wx0, wx1, jy0, wy0, wy1 = taps
        Ax = _dense_taps(jx0, wx0, wx1, S)  # (G, 4, out, S)
        Ay = _dense_taps(jy0, wy0, wy1, S)
        img = imgs.float() - FILL
        if precision == "fast_dense":
            bf16 = torch.bfloat16
            t = torch.einsum("gqchw,gqxw->gqchx", img.to(bf16), Ax.to(bf16))
            out = torch.einsum("gqyh,gqchx->gcyx", Ay.to(bf16).float(), t.float())
        else:
            _require_f32_matmul(imgs)
            t = torch.einsum("gqchw,gqxw->gqchx", img, Ax)
            out = torch.einsum("gqyh,gqchx->gcyx", Ay, t)
        out_imgs = torch.round(out + FILL).to(out_dtype).contiguous()
    proc, new_mask = _affine_boxes(mb, mm, values, M, target_size)
    out_sizes = torch.full((G, 2), target_size, dtype=torch.int32, device=dev)
    return DeviceSample(out_imgs, out_sizes, proc, ml, new_mask)


def mosaic_warp_taps(M, placement, target_size: int, flip_do: Optional[torch.Tensor] = None):
    """K5's tap scalars for the canvas -> output warp ``M`` (G, 3, 3).

    ``placement`` is ``_mosaic_placement``'s (x1a, y1a, x2a, y2a, x1b, y1b).
    Returns (jx0, wx0, wx1, jy0, wy0, wy1), each (G, 4, target_size): the
    warp's source coordinates shifted by each quadrant's integer offset and
    windowed to its rectangle; ``flip_do`` mirrors the output columns.
    """
    x1a, y1a, x2a, y2a, x1b, y1b = placement
    # inv_ex: no singularity check, which would wait for the device
    Minv = torch.linalg.inv_ex(M).inverse
    o = torch.arange(target_size, dtype=torch.float32, device=M.device)
    ox = o
    if flip_do is not None:
        # flipped output column ox reads what column out-1-ox reads unflipped
        ox = torch.where(flip_do[:, None], target_size - 1.0 - o, o)  # (G, out)
    z = Minv[:, 2, 2, None]
    sx = (Minv[:, 0, 0, None] * ox + Minv[:, 0, 2, None]) / z  # (G, out) canvas x
    sy = (Minv[:, 1, 1, None] * o + Minv[:, 1, 2, None]) / z

    def taps(s, a1, b1, a2):
        per_q = [
            _tap_scalars_windowed(s - (a1[:, q] - b1[:, q])[:, None].float(),
                                  b1[:, q], b1[:, q] + (a2[:, q] - a1[:, q]))
            for q in range(4)
        ]
        return [torch.stack([t[k] for t in per_q], 1).contiguous() for k in range(3)]

    return (*taps(sx, x1a, x1b, x2a), *taps(sy, y1a, y1b, y2a))


def flip_boxes(boxes: torch.Tensor, do: torch.Tensor, width: int) -> torch.Tensor:
    """Mirror (B, T, 4) xyxy boxes at width-1 where ``do`` (B,) is set."""
    wm1 = width - 1.0
    fb = torch.stack([wm1 - boxes[..., 2], boxes[..., 1], wm1 - boxes[..., 0], boxes[..., 3]], -1)
    return torch.where(do[:, None, None], fb, boxes)


def flip_batch(sample: DeviceSample, do: torch.Tensor) -> DeviceSample:
    """Horizontal flip of images (B, 3, H, W) and boxes where ``do`` (B,) is set."""
    W = sample.images.shape[3]
    images = torch.where(do[:, None, None, None], sample.images.flip(3), sample.images)
    return sample._replace(images=images, boxes=flip_boxes(sample.boxes, do, W))


def draw_flip(gen: torch.Generator, batch: int, prob: float) -> torch.Tensor:
    """(B,) bool horizontal-flip coins."""
    return torch.rand(batch, generator=gen, device=gen.device) < prob


# ---------------------------------------------------------------------------
# mixup
# ---------------------------------------------------------------------------

def mixup_batch(s1: DeviceSample, s2: DeviceSample, r: torch.Tensor) -> DeviceSample:
    """Blend ``s1 * r + s2 * (1 - r)`` with ``r`` (B, 1, 1, 1) f32 and
    concatenate the targets to capacity 2T (ref default.py:400-408).

    ``r`` being f32 promotes bf16 images to f32: the blend is never done in
    bf16.
    """
    return DeviceSample(
        images=s1.images * r + s2.images * (1.0 - r),
        sizes=s1.sizes,
        boxes=torch.cat([s1.boxes, s2.boxes], 1),
        labels=torch.cat([s1.labels, s2.labels], 1),
        mask=torch.cat([s1.mask, s2.mask], 1),
    )


def draw_mixup(gen: torch.Generator, batch: int, prob: float):
    """-> (r (B, 1, 1, 1) f32 ~ beta(32, 32), do (B,) bool with P(do) = prob).

    ``torch.distributions.Beta`` takes no generator. Both shape parameters
    are the integer 32, so X / (X + Y) with X and Y each the sum of 32
    standard exponentials, -log(1 - U), is an exact beta(32, 32) draw from
    ``gen``.
    """
    u = torch.rand(2, batch, 32, generator=gen, device=gen.device)
    x, y = (-torch.log1p(-u)).sum(-1)
    do = torch.rand(batch, generator=gen, device=gen.device) < prob
    return (x / (x + y)).reshape(batch, 1, 1, 1), do


# ---------------------------------------------------------------------------
# HSV
# ---------------------------------------------------------------------------

def hsv_gains(gen: torch.Generator, batch: int, hue: float, saturation: float,
              value: float) -> torch.Tensor:
    """The (B, 3) HSV jitter gains (ref default.py:357): U(-1, 1) * amp + 1."""
    u = torch.rand(batch, 3, generator=gen, device=gen.device) * 2.0 - 1.0
    return torch.stack([u[:, 0] * hue, u[:, 1] * saturation, u[:, 2] * value], -1) + 1.0


def hsv_batch(images: torch.Tensor, r: torch.Tensor, channel_axis: int = -1) -> torch.Tensor:
    """uint8-LUT-exact HSV jitter with gains ``r`` (B, 3).

    The plain version of K4 (``ops/hsv.py``); the arithmetic of the JAX
    package's ``hsv_batch`` (ref default.py:354-383 via cv2's 8U paths),
    op for op in f32 and int32:
      1. cv2 BGR2HSV 8U in integer fixed point (hsv_shift 12) with
         sdiv[v] = round(1044480 / v), hdiv[d] = round(122880 / d) computed
         as floor((2a + i) / (2i)) (no ties for 1 <= i <= 255);
      2. jitter: h' = floor((h * r0) mod 180) by two conditional subtracts
         (exact for h * r0 < 540), s' = floor(clip(s * r1)),
         v' = floor(clip(v * r2));
      3. cv2 HSV2BGR 8U: f32 sector math, floor(x * 255).
    Channels (b, g, r) are (0, 1, 2) of ``channel_axis`` (-1 NHWC, 1 planar).
    """
    if channel_axis not in (-1, 1):
        raise ValueError(f"channel_axis must be -1 or 1, got {channel_axis}")
    f32 = torch.float32
    img = torch.round(images.float()).clamp(0, 255).to(torch.int32)
    if channel_axis == 1:
        bch, gch, rch = img[:, 0], img[:, 1], img[:, 2]
    else:
        bch, gch, rch = img[..., 0], img[..., 1], img[..., 2]

    v = torch.maximum(torch.maximum(bch, gch), rch)
    vmin = torch.minimum(torch.minimum(bch, gch), rch)
    diff = v - vmin
    zero = torch.zeros((), dtype=torch.int32, device=images.device)
    sdiv_v = torch.where(v > 0, torch.div(2 * 1044480 + v, (2 * v).clamp(min=1), rounding_mode="floor"), zero)
    hdiv_d = torch.where(diff > 0, torch.div(2 * 122880 + diff, (2 * diff).clamp(min=1), rounding_mode="floor"), zero)
    s = (diff * sdiv_v + 2048) >> 12
    h_num = torch.where(v == rch, gch - bch,
                        torch.where(v == gch, bch - rch + 2 * diff, rch - gch + 4 * diff))
    h = (h_num * hdiv_d + 2048) >> 12
    h = torch.where(h < 0, h + 180, h)

    r = r.to(f32)
    r0, r1, r2 = r[:, None, None, 0], r[:, None, None, 1], r[:, None, None, 2]
    hx = h.to(f32) * r0
    hx = torch.where(hx >= 360.0, hx - 360.0, hx)
    hx = torch.where(hx >= 180.0, hx - 180.0, hx)
    h = torch.floor(hx).to(torch.int32)
    s = torch.floor((s.to(f32) * r1).clamp(0.0, 255.0)).to(torch.int32)
    v = torch.floor((v.to(f32) * r2).clamp(0.0, 255.0)).to(torch.int32)

    hf = h.to(f32) * torch.tensor(6.0 / 180.0, dtype=f32, device=images.device)
    sf = s.to(f32) * torch.tensor(1.0 / 255.0, dtype=f32, device=images.device)
    vf = v.to(f32) * torch.tensor(1.0 / 255.0, dtype=f32, device=images.device)
    sector = torch.floor(hf)
    ff = hf - sector
    sector = sector.to(torch.int32).clamp(max=5)
    tab0 = vf
    tab1 = vf * (1.0 - sf)
    tab2 = vf * (1.0 - sf * ff)
    tab3 = vf * (1.0 - sf * (1.0 - ff))
    w = torch.where
    b_out = w(sector < 2, tab1, w(sector == 2, tab3, w(sector < 5, tab0, tab2)))
    g_out = w(sector == 0, tab3, w(sector < 3, tab0, w(sector == 3, tab2, tab1)))
    r_out = w(sector == 1, tab2, w((sector == 2) | (sector == 3), tab1, w(sector == 4, tab3, tab0)))
    out = torch.stack([b_out, g_out, r_out], dim=channel_axis)
    return torch.floor(out * 255.0).clamp(0, 255).to(images.dtype)
