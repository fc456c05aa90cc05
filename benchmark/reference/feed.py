"""The fused epoch's batches, worked out again from the seed.

What the measured program's device feed does for one host, one group a
step, mosaic on, an axis-aligned affine (the recipes of ``configs/``):

  * the epoch plan: a permutation of the corpus drawn through
    ``random.Random(seed)`` and numpy, each primary image with three
    co-samples, shuffled within its quad (one plan an epoch, whatever part
    of it a cut epoch runs);
  * the draws of each step, in step order, from one ``torch.Generator``
    seeded with the seed on the run's device: mosaic centres, the eight
    affine values, the HSV gains, the flip coins;
  * the mosaic of each quad and the scale-and-translate warp at the
    ``fast`` precision the program is configured with (bilinear taps
    rounded to bf16, products in f32: the plain version of its kernel K5);
    cv2's uint8 HSV arithmetic; the flip; targets to capacity; NHWC in
    [0, 1] in float32.

Frozen copies of the program's arithmetic, so that the reference draws
the same numbers and builds the same boxes; none of it is imported.
"""

from __future__ import annotations

import random
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

FILL = 114.0  # the letterbox and mosaic fill value


class Aug(NamedTuple):
    """``configs/data/augmentations/aug_params.yaml``."""

    translate: float = 0.1
    scale: float = 0.5
    hue: float = 0.015
    saturation: float = 0.7
    value: float = 0.4
    flip_lr_prob: float = 0.5


# ------------------------------------------------------------------ plans
def epoch_plans(seed: int, n: int, batch: int, epochs: int) -> List[np.ndarray]:
    """The fused epoch's (steps, 4 batch) corpus rows of each of the first
    ``epochs`` epochs (uniform co-samples, no sampler)."""
    pyrng = random.Random(seed)
    plans = []
    for _ in range(epochs):
        idx = np.random.default_rng(pyrng.randrange(2**31)).permutation(n).astype(np.int64)
        rng = np.random.default_rng(pyrng.randrange(2**31))
        steps = n // batch
        prim = steps * batch
        co = np.arange(n, dtype=np.int64)[rng.choice(n, size=3 * prim, p=None)].reshape(prim, 3)
        quads = rng.permuted(np.concatenate([idx[:prim, None], co], 1), axis=1)
        plans.append(quads.reshape(steps, 4 * batch))
    return plans


# ------------------------------------------------------------------ draws
class Draws(NamedTuple):
    centers: torch.Tensor  # (G, 2) int32
    translate: torch.Tensor  # (G, 2): x, y
    scale: torch.Tensor  # (G,)
    hsv: torch.Tensor  # (G, 3)
    flip: torch.Tensor  # (G,) bool


def draw_step(gen: torch.Generator, groups: int, size: int, aug: Aug) -> Draws:
    """One step's draws, in the program's order (centres, the eight affine
    values, HSV gains, flip coins)."""
    dev = gen.device
    centers = torch.randint(size // 2, 2 * size - size // 2, (groups, 2), generator=gen, device=dev,
                            dtype=torch.int32)

    def u(lo, hi):
        return torch.rand(groups, generator=gen, device=dev) * (hi - lo) + lo

    # perspective x/y, degrees, scale, shear x/y, translate x/y: all drawn
    # whether their range is zero or not
    _, _, _ = u(0.0, 0.0), u(0.0, 0.0), u(0.0, 0.0)
    scale = u(1 - aug.scale, 1 + aug.scale)
    _, _ = u(0.0, 0.0), u(0.0, 0.0)
    tx, ty = u(0.5 - aug.translate, 0.5 + aug.translate), u(0.5 - aug.translate, 0.5 + aug.translate)
    r = torch.rand(groups, 3, generator=gen, device=dev) * 2.0 - 1.0
    hsv = torch.stack([r[:, 0] * aug.hue, r[:, 1] * aug.saturation, r[:, 2] * aug.value], -1) + 1.0
    flip = torch.rand(groups, generator=gen, device=dev) < aug.flip_lr_prob
    return Draws(centers, torch.stack([tx, ty], -1), scale, hsv, flip)


# ---------------------------------------------------------------- targets
def content_size(height: int, width: int, size: int) -> Tuple[int, int]:
    """(h, w) of an image resized to longest side ``size``."""
    s = size / max(height, width)
    return (min(max(int(round(height * s)), 1), size), min(max(int(round(width * s)), 1), size))


def target_arrays(shapes: Sequence[Tuple[int, int]], boxes: Sequence[np.ndarray], labels: Sequence[np.ndarray],
                  size: int):
    """Per-image targets in resized-content pixels at capacity
    ``max(len(boxes))``: (boxes (N, T, 4) f32, labels (N, T) int64, mask)."""
    n, T = len(shapes), max(max((len(b) for b in boxes), default=1), 1)
    tb, tl, tm = np.zeros((n, T, 4), np.float32), np.zeros((n, T), np.int64), np.zeros((n, T), bool)
    for i, ((h, w), b, lab) in enumerate(zip(shapes, boxes, labels)):
        s = size / max(h, w)
        ok = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
        k = int(ok.sum())
        tb[i, :k] = b[ok] * s
        tl[i, :k] = lab[ok]
        tm[i, :k] = True
    return tb, tl, tm


# ---------------------------------------------------------------- augment
def _candidates(orig, proc, mask, wh_thr=2.0, ar_thr=20.0, area_thr=0.1, eps=1e-16):
    w1, h1 = orig[..., 2] - orig[..., 0], orig[..., 3] - orig[..., 1]
    w2, h2 = proc[..., 2] - proc[..., 0], proc[..., 3] - proc[..., 1]
    ar = torch.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return mask & (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def _placement(sizes, center, size: int):
    """Each quadrant's canvas rectangle [x1a, x2a) x [y1a, y2a) and the
    source origin (x1b, y1b) it is copied from; sizes (G, 4, 2) (h, w)."""
    S2 = 2 * size
    xc, yc = center[:, 0], center[:, 1]
    h, w = sizes[..., 0], sizes[..., 1]
    zero = torch.zeros_like(xc)
    x1a = torch.stack([(xc - w[:, 0]).clamp(min=0), xc, (xc - w[:, 2]).clamp(min=0), xc], -1)
    y1a = torch.stack([(yc - h[:, 0]).clamp(min=0), (yc - h[:, 1]).clamp(min=0), yc, yc], -1)
    x2a = torch.stack([xc, (xc + w[:, 1]).clamp(max=S2), xc, (xc + w[:, 3]).clamp(max=S2)], -1)
    y2a = torch.stack([yc, yc, (yc + h[:, 2]).clamp(max=S2), (yc + h[:, 3]).clamp(max=S2)], -1)
    x1b = torch.stack([w[:, 0] - (x2a[:, 0] - x1a[:, 0]), zero, w[:, 2] - (x2a[:, 2] - x1a[:, 2]), zero], -1)
    y1b = torch.stack([h[:, 0] - (y2a[:, 0] - y1a[:, 0]), h[:, 1] - (y2a[:, 1] - y1a[:, 1]), zero, zero], -1)
    return x1a, y1a, x2a, y2a, x1b, y1b


def _matrix(d: Draws, size: int) -> torch.Tensor:
    """M = T S R P C of the canvas (2S) -> output (S) warp: centre, scale,
    translate (no rotation, shear or perspective in these recipes)."""
    G = d.scale.shape[0]
    M = torch.zeros(G, 3, 3, dtype=torch.float32, device=d.scale.device)
    M[:, 0, 0] = M[:, 1, 1] = d.scale
    M[:, 0, 2] = -size * d.scale + d.translate[:, 0] * size
    M[:, 1, 2] = -size * d.scale + d.translate[:, 1] * size
    M[:, 2, 2] = 1.0
    return M


def mosaic_taps(sizes: torch.Tensor, d: Draws, size: int):
    """The warp's bilinear taps into each quadrant's source image, the flip
    folded into x: (jx0, wx0, wx1, jy0, wy0, wy1), each (G, 4, size), tap k
    at source index j0 + k with weight wk, zero outside the quadrant."""
    G = d.scale.shape[0]
    x1a, y1a, x2a, y2a, x1b, y1b = _placement(sizes.reshape(G, 4, 2), d.centers, size)
    M = _matrix(d, size)
    Minv = torch.linalg.inv_ex(M).inverse
    o = torch.arange(size, dtype=torch.float32, device=M.device)
    ox = torch.where(d.flip[:, None], size - 1.0 - o, o)
    z = Minv[:, 2, 2, None]
    sx = (Minv[:, 0, 0, None] * ox + Minv[:, 0, 2, None]) / z
    sy = (Minv[:, 1, 1, None] * o + Minv[:, 1, 2, None]) / z

    def taps(s, a1, b1, a2):
        out = []
        for q in range(4):
            sq = s - (a1[:, q] - b1[:, q])[:, None].float()
            lo, hi = b1[:, q, None], (b1[:, q] + (a2[:, q] - a1[:, q]))[:, None]
            i0f = torch.floor(sq)
            f = sq - i0f
            i0 = i0f.to(torch.int32)
            zero = torch.zeros((), dtype=sq.dtype, device=sq.device)
            w0 = torch.where((i0 >= lo) & (i0 < hi), 1.0 - f, zero)
            w1 = torch.where((i0 + 1 >= lo) & (i0 + 1 < hi), f, zero)
            out.append((i0, w0, w1))
        return [torch.stack([t[k] for t in out], 1) for k in range(3)]

    return (*taps(sx, x1a, x1b, x2a), *taps(sy, y1a, y1b, y2a)), (x1a, y1a, x1b, y1b), M


def _taps(j, w0, w1, n: int):
    """Clamped indices and bf16-rounded weights, zero outside [0, n)."""
    zero = torch.zeros((), dtype=torch.float32, device=j.device)
    t0 = torch.where((j >= 0) & (j < n), w0.to(torch.bfloat16).float(), zero)
    t1 = torch.where((j + 1 >= 0) & (j + 1 < n), w1.to(torch.bfloat16).float(), zero)
    return j.clamp(0, n - 1).long(), (j + 1).clamp(0, n - 1).long(), t0, t1


def warp(imgs, jx0, wx0, wx1, jy0, wy0, wy1) -> torch.Tensor:
    """The mosaic warp at the configured ``fast`` precision (the program's
    default): tap weights rounded to bf16, the y pass accumulated in f32 and
    stored in bf16, the x pass in f32, the four quadrants summed, rounded.
    imgs (G, 4, 3, S, S) uint8 -> (G, 3, S', S') integer-valued f32."""
    G, _, C, S, _ = imgs.shape
    So = jx0.shape[-1]
    src = imgs.float() - FILL
    iy0, iy1, ty0, ty1 = _taps(jy0, wy0, wy1, S)
    rows0 = torch.gather(src, 3, iy0[:, :, None, :, None].expand(G, 4, C, So, S))
    rows1 = torch.gather(src, 3, iy1[:, :, None, :, None].expand(G, 4, C, So, S))
    ybl = (ty0[:, :, None, :, None] * rows0 + ty1[:, :, None, :, None] * rows1).to(torch.bfloat16).float()
    ix0, ix1, tx0, tx1 = _taps(jx0, wx0, wx1, S)
    col0 = torch.gather(ybl, 4, ix0[:, :, None, None, :].expand(G, 4, C, So, So))
    col1 = torch.gather(ybl, 4, ix1[:, :, None, None, :].expand(G, 4, C, So, So))
    res = tx0[:, :, None, None, :] * col0 + tx1[:, :, None, None, :] * col1
    acc = res[:, 0]
    for q in range(1, 4):
        acc = acc + res[:, q]
    return torch.round(acc + FILL)


def reached_bytes(sizes: torch.Tensor, d: Draws, size: int) -> int:
    """uint8 source bytes that a non-zero tap of the warp reads, over the
    step's groups: distinct rows times distinct columns, 3 channels."""
    (jx0, wx0, wx1, jy0, wy0, wy1), _, _ = mosaic_taps(sizes, d, size)

    def lines(j0, w0, w1):
        hits = torch.zeros(j0.shape[:2] + (size,), dtype=torch.int32, device=j0.device)
        for j, w in ((j0, w0), (j0 + 1, w1)):
            ok = (w != 0) & (j >= 0) & (j < size)
            hits.scatter_add_(2, j.clamp(0, size - 1).long(), ok.to(torch.int32))
        return (hits > 0).sum(-1)

    return int((lines(jy0, wy0, wy1) * lines(jx0, wx0, wx1)).sum()) * 3


def hsv(images: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """cv2's 8-bit BGR -> HSV -> jitter -> BGR on planar (B, 3, H, W)
    integer-valued floats; gains ``r`` (B, 3)."""
    f32 = torch.float32
    img = torch.round(images.float()).clamp(0, 255).to(torch.int32)
    b, g, rr = img[:, 0], img[:, 1], img[:, 2]
    v = torch.maximum(torch.maximum(b, g), rr)
    diff = v - torch.minimum(torch.minimum(b, g), rr)
    zero = torch.zeros((), dtype=torch.int32, device=images.device)
    sdiv = torch.where(v > 0, torch.div(2 * 1044480 + v, (2 * v).clamp(min=1), rounding_mode="floor"), zero)
    hdiv = torch.where(diff > 0, torch.div(2 * 122880 + diff, (2 * diff).clamp(min=1), rounding_mode="floor"), zero)
    s = (diff * sdiv + 2048) >> 12
    hn = torch.where(v == rr, g - b, torch.where(v == g, b - rr + 2 * diff, rr - g + 4 * diff))
    h = (hn * hdiv + 2048) >> 12
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
    t0, t1, t2, t3 = vf, vf * (1.0 - sf), vf * (1.0 - sf * ff), vf * (1.0 - sf * (1.0 - ff))
    w = torch.where
    bo = w(sector < 2, t1, w(sector == 2, t3, w(sector < 5, t0, t2)))
    go = w(sector == 0, t3, w(sector < 3, t0, w(sector == 3, t2, t1)))
    ro = w(sector == 1, t2, w((sector == 2) | (sector == 3), t1, w(sector == 4, t3, t0)))
    return torch.floor(torch.stack([bo, go, ro], 1) * 255.0).clamp(0, 255)


class Batch(NamedTuple):
    images: torch.Tensor  # (B, S, S, 3) f32 in [0, 1]
    boxes: torch.Tensor  # (B, T, 4) xyxy pixels
    labels: torch.Tensor  # (B, T) int64, 0 where masked
    mask: torch.Tensor  # (B, T) bool


def make_batch(src: torch.Tensor, sizes: torch.Tensor, tb: torch.Tensor, tl: torch.Tensor, tm: torch.Tensor,
               d: Draws, size: int, max_targets: int) -> Batch:
    """One step's batch from its 4 G gathered planar uint8 sources (4 G, 3,
    S, S), their content sizes and targets."""
    G = d.scale.shape[0]
    S2 = 2 * size
    taps, (x1a, y1a, x1b, y1b), M = mosaic_taps(sizes, d, size)
    out = hsv(warp(src.reshape(G, 4, 3, size, size), *taps), d.hsv)
    # boxes: onto the canvas, candidate filter, through M, filter again, flip
    T = tb.shape[1]
    shift = torch.stack([(x1a - x1b).float(), (y1a - y1b).float()] * 2, -1)  # (G, 4, 4)
    b = (tb.reshape(G, 4, T, 4) + shift[:, :, None, :]).reshape(G, 4 * T, 4)
    m = _candidates(b, b.clamp(0, S2), tm.reshape(G, 4 * T), eps=1e-7)
    b = b.clamp(0, S2 - 1)
    corners = torch.stack([b[..., 0], b[..., 1], b[..., 2], b[..., 3], b[..., 0], b[..., 3], b[..., 2], b[..., 1]],
                          -1).reshape(G, -1, 4, 2)
    hom = torch.cat([corners, torch.ones_like(corners[..., :1])], -1)
    xy = torch.einsum("btcj,bij->btci", hom, M)[..., :2]
    hi = size - 1
    proc = torch.stack([xy[..., 0].amin(-1).clamp(0, hi), xy[..., 1].amin(-1).clamp(0, hi),
                        xy[..., 0].amax(-1).clamp(0, hi), xy[..., 1].amax(-1).clamp(0, hi)], -1)
    m = _candidates(b * d.scale[:, None, None], proc, m)
    wm1 = size - 1.0
    flipped = torch.stack([wm1 - proc[..., 2], proc[..., 1], wm1 - proc[..., 0], proc[..., 3]], -1)
    boxes = torch.where(d.flip[:, None, None], flipped, proc)
    labels = tl.reshape(G, 4 * T)
    if 4 * T > max_targets:
        order = torch.argsort((~m).to(torch.int8), dim=1, stable=True)[:, :max_targets]
        boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
        labels, m = torch.gather(labels, 1, order), torch.gather(m, 1, order)
    else:
        pad = max_targets - 4 * T
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, pad))
        labels, m = torch.nn.functional.pad(labels, (0, pad)), torch.nn.functional.pad(m, (0, pad))
    images = out.permute(0, 2, 3, 1) / torch.full((), 255.0, device=out.device)
    return Batch(images.contiguous(), boxes, torch.where(m, labels, torch.zeros_like(labels)), m)


def steps_batches(images: torch.Tensor, sizes: torch.Tensor, targets: Tuple[torch.Tensor, ...],
                  plans: Sequence[np.ndarray], cut: Sequence[int], seed: int, size: int, aug: Aug,
                  max_targets: int):
    """Yield the batches of the fused epochs' first steps: ``cut[e]`` steps
    of epoch e's plan, every step drawing from one generator on
    ``images``' device seeded with ``seed``."""
    gen = torch.Generator(device=images.device).manual_seed(seed)
    G = plans[0].shape[1] // 4
    tb, tl, tm = targets
    for plan, n in zip(plans, cut):
        for i in range(n):
            d = draw_step(gen, G, size, aug)
            rows = torch.from_numpy(plan[i]).to(images.device)
            yield make_batch(images[rows], sizes[rows], tb[rows], tl[rows], tm[rows], d, size, max_targets)


def count_draws(gen: torch.Generator, groups: int, size: int, aug: Aug, n: int) -> None:
    """Advance ``gen`` past ``n`` steps' draws."""
    for _ in range(n):
        draw_step(gen, groups, size, aug)
