"""Port parity: the training augment and its kernels' plain versions.

The JAX side runs as its own tests run it on the CPU: Pallas kernels in
interpret mode, draws from ``jax.random``, which are handed to the port.
Tolerances:
  * K2/K3 gather: exact (a copy).
  * K4 HSV: against the interpret-mode Pallas kernel <= 1 on < 0.2% of
    pixels (XLA on the CPU may contract multiply-adds in the kernel's
    fused ops; the port rounds every op), the class of
    tests/test_pallas_hsv.py; against ``hsv_batch`` bitwise.
  * K5 warp: bitwise against interpret-mode ``warp_quadrants`` with the
    dense ``Ax`` built from the same taps.
  * ``mosaic_affine_batch``: pixels <= 2 units and > 85% equal (the class
    of tests/test_pallas_warp.py:92-93: M is inverted by two libraries and
    a tap can move by an ulp), boxes 1e-4, masks and labels exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_cib_torch.data import device_pipeline as tdp
from object_detection_cib_torch.ops import augment as ta
from object_detection_cib_torch.ops import gather as tg
from object_detection_cib_torch.ops import hsv as th
from object_detection_cib_torch.ops import warp as tw
from object_detection_cib_tpu.data import device_pipeline as jdp
from object_detection_cib_tpu.data.host_augment import AugParams as JAugParams
from object_detection_cib_tpu.ops import augment as ja
from object_detection_cib_tpu.ops import pallas_gather, pallas_hsv, pallas_warp


def T(a):
    return torch.from_numpy(np.array(a))


def _sample(B=8, S=64, Tn=5, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (B, 3, S, S), np.uint8)
    sizes = np.stack([rng.integers(S // 2, S + 1, (B,)), rng.integers(S // 2, S + 1, (B,))],
                     -1).astype(np.int32)
    boxes = np.zeros((B, Tn, 4), np.float32)
    labels = rng.integers(0, 3, (B, Tn)).astype(np.int32)
    mask = np.zeros((B, Tn), bool)
    for b in range(B):
        for t in range(rng.integers(1, Tn)):
            x, y = rng.uniform(0, S - 12, 2)
            w, h = rng.uniform(4, 10, 2)
            boxes[b, t] = [x, y, x + w, y + h]
            mask[b, t] = True
    return imgs, sizes, boxes, labels, mask


def assert_hsv_close(got, want):
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.002, (diff > 0).mean()


# ------------------------------------------------------------ K2/K3 gather

@pytest.mark.parametrize("shape,idx", [((7, 3, 16, 128), [4, 0, 6, 4]),
                                       ((5, 3, 64, 64), [1, 1, 1, 0, 4, 2])])
def test_gather_planar_matches_pallas(shape, idx):
    corpus = np.random.default_rng(3).integers(0, 256, shape, np.uint8)
    want = pallas_gather.gather_rows_planar(jnp.asarray(corpus), jnp.asarray(idx, jnp.int32),
                                            interpret=True)
    got = tg.gather_rows_planar(T(corpus), torch.tensor(idx, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_flat_matches_pallas():
    rng = np.random.default_rng(4)
    flat = rng.integers(0, 256, (6, 8, 256), np.uint8)
    idx = [5, 0, 5, 3]
    want = pallas_gather.gather_rows_flat(jnp.asarray(flat), jnp.asarray(idx, jnp.int32),
                                          interpret=True)
    got = tg.gather_rows_flat(T(flat), torch.tensor(idx, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the JAX package's gather_rows: any row shape through the flat view
    corpus = rng.integers(0, 256, (4, 32, 32, 3), np.uint8)
    want = pallas_gather.gather_rows(jnp.asarray(corpus), jnp.asarray([3, 1, 3], jnp.int32),
                                     interpret=True)
    got = tg.gather_rows_flat(T(corpus).reshape(4, 8, -1), torch.tensor([3, 1, 3]))
    np.testing.assert_array_equal(got.reshape(3, 32, 32, 3).numpy(), np.asarray(want))


def test_gather_plain_raises_out_of_range():
    corpus = torch.zeros(3, 3, 8, 8, dtype=torch.uint8)
    for bad in ([3], [-1], [0, 5]):
        with pytest.raises(IndexError):
            tg.gather_rows_planar(corpus, torch.tensor(bad, dtype=torch.int32))


# ------------------------------------------------------------------ K4 HSV

@pytest.mark.parametrize("shape", [(8, 3, 64, 128), (4, 3, 32, 416)])
def test_hsv_matches_pallas(shape):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, shape, np.int32).astype(np.float32)
    r = np.asarray(ja.hsv_gains(jax.random.PRNGKey(7), shape[0], 0.015, 0.7, 0.4))
    want = pallas_hsv.hsv_planar(jnp.asarray(imgs), jnp.asarray(r), interpret=True)
    got = th.hsv_planar(T(imgs), T(r))
    assert_hsv_close(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ja.hsv_batch(jnp.asarray(imgs), None, r=jnp.asarray(r), channel_axis=1)))


def test_hsv_non_integral_and_extreme_gains():
    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 255, (4, 3, 32, 128)).astype(np.float32)
    r = np.asarray([[0.985, 0.3, 0.6], [1.015, 1.7, 1.4], [1.0, 1.0, 1.0], [0.99, 1.69, 0.61]],
                   np.float32)
    want = pallas_hsv.hsv_planar(jnp.asarray(imgs), jnp.asarray(r), interpret=True)
    got = th.hsv_planar(T(imgs), T(r))
    assert_hsv_close(got.numpy(), want)


def test_hsv_bf16_and_nhwc_match_jax():
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (2, 3, 16, 64)).astype(np.float32)
    r = np.asarray(ja.hsv_gains(jax.random.PRNGKey(1), 2, 0.015, 0.7, 0.4))
    want = ja.hsv_batch(jnp.asarray(imgs, jnp.bfloat16), None, r=jnp.asarray(r), channel_axis=1)
    got = th.hsv_planar(T(imgs).to(torch.bfloat16), T(r))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    nhwc = np.ascontiguousarray(imgs.transpose(0, 2, 3, 1))
    want = ja.hsv_batch(jnp.asarray(nhwc), None, r=jnp.asarray(r))
    np.testing.assert_array_equal(ta.hsv_batch(T(nhwc), T(r)).numpy(), np.asarray(want))


def _jax_exact_floordiv(num, den):
    """The arithmetic of ``exact_floordiv`` inside the JAX ``hsv_batch``
    (ops/augment.py:736-749, a local function there): an f32 quotient and one
    exact-remainder correction."""
    q = jnp.floor(num.astype(jnp.float32) / den.astype(jnp.float32)).astype(jnp.int32)
    r = num - q * den
    return q + jnp.where(r >= den, 1, 0) - jnp.where(r < 0, 1, 0)


def test_hsv_div_tables_match_port_and_jax_division():
    """The kernel's 256-entry tables equal, entry by entry, cv2's rounded
    quotients, what the port's ``hsv_batch`` divides out
    (ops/augment.py:360-361) and what the JAX ``hsv_batch``'s
    ``exact_floordiv`` gives, for every v and every diff in 0..255.
    ``test_hsv_every_table_entry_matches_jax`` sends the same 256 x 256 pairs
    through the two ``hsv_batch``'s themselves."""
    sdiv, hdiv = th.hsv_div_tables()
    assert sdiv.dtype == hdiv.dtype == torch.int32 and sdiv.shape == hdiv.shape == (256,)
    i = np.arange(256)
    for table, a in ((sdiv, 1044480), (hdiv, 122880)):
        cv2_round = np.where(i > 0, np.round(a / np.maximum(i, 1)), 0).astype(np.int64)
        np.testing.assert_array_equal(table.numpy(), cv2_round)
        ti = torch.arange(256, dtype=torch.int32)
        port = torch.where(ti > 0, torch.div(2 * a + ti, (2 * ti).clamp(min=1),
                                             rounding_mode="floor"), 0)
        np.testing.assert_array_equal(table.numpy(), port.numpy())
        ji = jnp.arange(256, dtype=jnp.int32)
        jax_t = jnp.where(ji > 0, _jax_exact_floordiv(2 * a + ji, jnp.maximum(2 * ji, 1)), 0)
        np.testing.assert_array_equal(table.numpy(), np.asarray(jax_t))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_hsv_every_table_entry_matches_jax(dtype):
    """Every (v, diff) pair, in two channel orders, through both
    ``hsv_batch``'s: each entry of both tables decides some output."""
    v, d = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    v, d = v.ravel(), np.minimum(v, d).ravel()
    px = np.stack([np.concatenate([v, v - d]), np.concatenate([v - d, v]),
                   np.concatenate([v - d // 2, v - d])]).reshape(1, 3, 256, 512).astype(np.float32)
    r = np.asarray([[1.015, 1.7, 1.4]], np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = ja.hsv_batch(jnp.asarray(px, jdt), None, r=jnp.asarray(r), channel_axis=1)
    got = th.hsv_planar(T(px).to(tdt), T(r))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("shape", [(5, 3, 13, 7), (2, 3, 9, 11)])
def test_hsv_plane_not_multiple_of_8_matches_jax(shape):
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, shape).astype(np.float32)
    r = np.asarray(ja.hsv_gains(jax.random.PRNGKey(3), shape[0], 0.015, 0.7, 0.4))
    assert (shape[2] * shape[3]) % 8 != 0
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = ja.hsv_batch(jnp.asarray(imgs, jdt), None, r=jnp.asarray(r), channel_axis=1)
        got = th.hsv_planar_plain(T(imgs).to(tdt), T(r))
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


# ----------------------------------------------------------------- K5 warp

def _dense(j0, w0, w1, n):
    """The TPU kernel's dense tap matrix from tap scalars (f32, then bf16 inside)."""
    hh = np.arange(n)
    return (np.where(hh == j0[..., None], w0[..., None], 0)
            + np.where(hh == j0[..., None] + 1, w1[..., None], 0)).astype(np.float32)


@pytest.mark.parametrize("G,S,seed", [(3, 64, 0), (2, 48, 1), (2, 208, 11)])
def test_warp_plain_matches_pallas_bitwise(G, S, seed):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (G, 4, 3, S, S), np.uint8)

    def axis():
        j0 = rng.integers(-3, S + 1, (G, 4, S)).astype(np.int32)
        w0 = rng.random((G, 4, S), dtype=np.float32)
        w1 = rng.random((G, 4, S), dtype=np.float32)
        w0[rng.random((G, 4, S)) < 0.2] = 0.0
        w1[rng.random((G, 4, S)) < 0.2] = 0.0
        return j0, w0, w1

    (jx, wx0, wx1), (jy, wy0, wy1) = axis(), axis()
    # dead quadrants: group 0 rows [0, S/2) have no y-weight in any
    # quadrant (pure fill), quadrant 1 of group 1 is dead everywhere
    wy0[0, :, : S // 2] = wy1[0, :, : S // 2] = 0.0
    wy0[1, 1] = wy1[1, 1] = 0.0
    want = pallas_warp.warp_quadrants(
        jnp.asarray(imgs), jnp.asarray(_dense(jx, wx0, wx1, S)), jnp.asarray(jy),
        jnp.asarray(wy0), jnp.asarray(wy1), 114.0, out_dtype=jnp.float32, interpret=True)
    got = tw.warp_quadrants(*(T(a) for a in (imgs, jx, wx0, wx1, jy, wy0, wy1)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[0, :, : S // 2] == 114.0).all()
    got16 = tw.warp_quadrants(*(T(a) for a in (imgs, jx, wx0, wx1, jy, wy0, wy1)),
                              out_dtype=torch.bfloat16)
    want16 = np.asarray(jnp.asarray(want).astype(jnp.bfloat16), np.float32)  # > 256 rounds
    np.testing.assert_array_equal(got16.float().numpy(), want16)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("scale", [0.5, 1.5])
def test_warp_plain_matches_pallas_at_extreme_scales(scale, flip):
    """Taps of real mosaic draws at both ends of aug_params.yaml's scale
    range (0.5 +- 0.5), mirrored or not: the inputs that stress the CUDA
    kernel's x-windows and row staging."""
    G, S = 2, 64
    rng = np.random.default_rng(int(scale * 10) + flip)
    imgs = rng.integers(0, 256, (G, 4, 3, S, S), np.uint8)
    sizes = rng.integers(S // 2, S + 1, (G, 4, 2)).astype(np.int32)
    centers = rng.integers(S // 2, 2 * S - S // 2, (G, 2)).astype(np.int32)
    zeros = np.zeros(G, np.float32)
    values = ta.AffineBatchValues(
        *(T(v) for v in (zeros, zeros, zeros, np.full(G, scale, np.float32), zeros, zeros,
                         rng.uniform(0.4, 0.6, G).astype(np.float32),
                         rng.uniform(0.4, 0.6, G).astype(np.float32))))
    placement = ta._mosaic_placement(T(sizes), T(centers), S)
    M = ta._affine_matrices(values, 2 * S, 2 * S, S, S)
    flip_do = T(np.array([True, False])) if flip else None
    jx, wx0, wx1, jy, wy0, wy1 = (t.numpy() for t in ta.mosaic_warp_taps(M, placement, S, flip_do))
    want = pallas_warp.warp_quadrants(
        jnp.asarray(imgs), jnp.asarray(_dense(jx, wx0, wx1, S)), jnp.asarray(jy),
        jnp.asarray(wy0), jnp.asarray(wy1), 114.0, out_dtype=jnp.float32, interpret=True)
    got = tw.warp_quadrants_plain(*(T(a) for a in (imgs, jx, wx0, wx1, jy, wy0, wy1)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got != 114.0).any()


def test_tap_scalars_and_matrix_match_jax():
    rng = np.random.default_rng(5)
    s = rng.uniform(-10, 70, (3, 64)).astype(np.float32)
    lo = np.asarray([0, 5, 20], np.int32)
    hi = np.asarray([64, 40, 33], np.int32)
    for got, want in zip(ta._tap_scalars_windowed(T(s), T(lo), T(hi)),
                         ja._tap_scalars_windowed(jnp.asarray(s), jnp.asarray(lo), jnp.asarray(hi))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ta._tap_matrix_windowed(T(s), 64, T(lo), T(hi)).numpy(),
        np.asarray(ja._tap_matrix_windowed(jnp.asarray(s), 64, jnp.asarray(lo), jnp.asarray(hi))))


def test_affine_matrices_and_boxes_match_jax():
    values = ja.sample_affine_values_batch(jax.random.PRNGKey(2), 4, degrees=10.0, shear=3.0,
                                           perspective=0.001)
    tv = ta.AffineBatchValues(*(T(v) for v in values))
    M = ta._affine_matrices(tv, 128, 128, 64, 64)
    Mj = ja._affine_matrices(values, 128, 128, 64, 64)
    np.testing.assert_allclose(M.numpy(), np.asarray(Mj), rtol=1e-6, atol=1e-6)
    _, _, boxes, _, mask = _sample(B=4, S=128, Tn=6, seed=3)
    proc, m = ta._affine_boxes(T(boxes), T(mask), tv, T(np.asarray(Mj)), 64)
    pj, mj = ja._affine_boxes(jnp.asarray(boxes), jnp.asarray(mask), values, Mj, 64)
    np.testing.assert_allclose(proc.numpy(), np.asarray(pj), atol=1e-4)
    np.testing.assert_array_equal(m.numpy(), np.asarray(mj))


# ------------------------------------------------ the fused mosaic + warp

def _jax_draws(seed, G, S, flip):
    km, ka, kf = jax.random.split(jax.random.PRNGKey(seed), 3)
    values = ja.sample_affine_values_batch(ka, G, translate=0.1, scale=0.5)
    do = (jax.random.uniform(kf, (G,)) < 0.5) if flip else None
    centers = jax.random.randint(km, (G, 2), S // 2, 2 * S - S // 2)
    return km, values, do, centers


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mosaic_affine_matches_jax_pallas_path(seed, flip):
    S = 64
    arrs = _sample(seed=seed)
    km, values, do, centers = _jax_draws(seed, 2, S, flip)
    js = ja.mosaic_affine_batch(ja.DeviceSample(*map(jnp.asarray, arrs)), km, values, S,
                                flip_do=do, precision="fast", planar=True,
                                warp_pallas=True, pallas_interpret=True)
    ts = ta.mosaic_affine_batch(ta.DeviceSample(*map(T, arrs)), T(centers).int(),
                                ta.AffineBatchValues(*(T(v) for v in values)), S,
                                flip_do=None if do is None else T(do))
    a, b = ts.images.numpy(), np.asarray(js.images)
    assert a.shape == b.shape == (2, 3, S, S)
    diff = np.abs(a - b)
    assert diff.max() <= 2.0, diff.max()
    assert (diff == 0).mean() > 0.85, (diff == 0).mean()
    np.testing.assert_allclose(ts.boxes.numpy(), np.asarray(js.boxes), atol=1e-4)
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))
    np.testing.assert_array_equal(ts.labels.numpy(), np.asarray(js.labels))
    np.testing.assert_array_equal(ts.sizes.numpy(), np.asarray(js.sizes))


def test_flip_boxes_matches_jax():
    _, _, boxes, _, _ = _sample(B=4, seed=6)
    do = np.asarray([True, False, True, False])
    np.testing.assert_array_equal(ta.flip_boxes(T(boxes), T(do), 64).numpy(),
                                  np.asarray(ja.flip_boxes(jnp.asarray(boxes), jnp.asarray(do), 64)))


# ----------------------------------------------------------------- to_batch

def _jax_to_batch(max_targets, feed_dtype):
    """The JAX package's ``to_batch`` closure inside ``build_device_augment_fn``."""
    fn = jdp.build_device_augment_fn(64, JAugParams(), max_targets=max_targets, planar=True,
                                     warp_precision="fast", feed_dtype=feed_dtype)
    inner = fn.__wrapped__
    return inner.__closure__[inner.__code__.co_freevars.index("to_batch")].cell_contents


@pytest.mark.parametrize("max_targets", [40, 6])  # pad branch, truncate branch
@pytest.mark.parametrize("feed", ["bf16", "f32"])
def test_to_batch_matches_jax(max_targets, feed):
    jfeed, tfeed = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}[feed]
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (2, 3, 16, 16)).astype(np.float32)
    _, _, boxes, labels, mask = _sample(B=2, Tn=10, seed=8)
    mask[0, [0, 1, 2, 4, 5, 7, 8, 9]] = True  # 8 valid in image 0: > 6 overflows
    s = (imgs, np.full((2, 2), 16, np.int32), boxes, labels, mask)
    jb, jovf = _jax_to_batch(max_targets, jfeed)(ja.DeviceSample(*map(jnp.asarray, s)))
    tb, tovf = tdp.to_batch(ta.DeviceSample(*map(T, s)), max_targets, tfeed)
    assert int(tovf) == int(jovf)
    if max_targets < 10:
        assert int(tovf) > 0
    assert tb.images.dtype == tfeed and tb.images.is_contiguous()
    for got, want in zip(tb, jb):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
