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
    a tap can move by an ulp), boxes 1e-4, masks and labels exact; its
    dense bf16 branch (``precision="fast_dense"``) against the JAX
    ``warp_pallas=False`` einsums in the same pixel class, boxes, masks and
    labels exact.
  * the composed path (the JAX functions are NHWC, the port's planar; the
    tests transpose): ``mosaic4_batch``, ``flip_batch`` and ``_tap_matrix``
    exact; ``_bilinear_sample``, ``_axis_aligned_warp``, ``affine_batch``
    and ``mosaic_affine_batch(precision="exact")`` <= 1 unit with >= 99% of
    pixels equal (the class of tests/test_device_augment.py:140, :305, :338:
    two libraries invert M, so a sample coordinate can fall on the other
    side of a .5 blend boundary), boxes 1e-4, masks exact; ``mixup_batch``
    with JAX's ratio 1e-5, targets exact.
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


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_bf16_warp_matches_jax_einsum_path(seed, flip):
    """``precision="fast_dense"`` against the JAX package's ``warp_pallas=False``
    branch, the dense bf16 einsums, on the same draws."""
    S = 64
    arrs = _content_sample(seed=seed)
    km, values, do, centers = _jax_draws(seed, 2, S, flip)
    js = ja.mosaic_affine_batch(ja.DeviceSample(*map(jnp.asarray, arrs)), km, values, S,
                                flip_do=do, precision="fast", planar=True, warp_pallas=False)
    ts = ta.mosaic_affine_batch(ta.DeviceSample(*map(T, arrs)), T(centers).int(),
                                ta.AffineBatchValues(*(T(v) for v in values)), S,
                                flip_do=None if do is None else T(do), precision="fast_dense")
    assert ts.images.is_contiguous()
    a, b = ts.images.numpy(), np.asarray(js.images)
    assert a.shape == b.shape == (2, 3, S, S)
    diff = np.abs(a - b)
    assert diff.max() <= 2.0, diff.max()
    assert (diff == 0).mean() > 0.85, (diff == 0).mean()
    np.testing.assert_array_equal(ts.boxes.numpy(), np.asarray(js.boxes))
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(js.mask))
    np.testing.assert_array_equal(ts.labels.numpy(), np.asarray(js.labels))
    # beside the kernel's path on the same draws: the same fast class
    k5 = ta.mosaic_affine_batch(ta.DeviceSample(*map(T, arrs)), T(centers).int(),
                                ta.AffineBatchValues(*(T(v) for v in values)), S,
                                flip_do=None if do is None else T(do))
    d = (k5.images - ts.images).abs()
    assert float(d.max()) <= 2.0 and float((d == 0).float().mean()) > 0.85
    assert torch.equal(k5.boxes, ts.boxes) and torch.equal(k5.mask, ts.mask)


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


# ------------------------------------------------------- the composed path

def nhwc(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 3, 1))


def assert_warp_close(got_planar, want_nhwc, min_equal=0.99):
    """At most 1 unit apart, at least ``min_equal`` of the pixels equal."""
    diff = np.abs(nhwc(got_planar) - np.asarray(want_nhwc, np.float32))
    assert diff.max() <= 1.0, diff.max()
    assert (diff == 0).mean() >= min_equal, (diff == 0).mean()


def _jsample(arrs):
    imgs, sizes, boxes, labels, mask = arrs
    return ja.DeviceSample(jnp.asarray(nhwc(imgs)), *map(jnp.asarray, (sizes, boxes, labels, mask)))


def _content_sample(B=8, S=64, seed=0):
    """Like a corpus batch: content in the top-left (h, w) window, FILL elsewhere."""
    imgs, sizes, boxes, labels, mask = _sample(B=B, S=S, seed=seed)
    yy, xx = np.mgrid[:S, :S]
    outside = (yy[None] >= sizes[:, 0, None, None]) | (xx[None] >= sizes[:, 1, None, None])
    imgs = np.where(outside[:, None], np.uint8(114), imgs)
    return imgs, sizes, boxes, labels, mask


def _values(seed, B, **kw):
    jv = ja.sample_affine_values_batch(jax.random.PRNGKey(seed), B, **kw)
    return jv, ta.AffineBatchValues(*(T(v) for v in jv))


GENERAL = dict(degrees=10.0, translate=0.1, scale=0.5, shear=2.0, perspective=5e-4)
IDENTITY = dict(degrees=0.0, translate=0.0, scale=0.0, shear=0.0, perspective=0.0)
AXIS = dict(degrees=0.0, translate=0.1, scale=0.5, shear=0.0, perspective=0.0)


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mosaic4_matches_jax(seed, dtype):
    S = 64
    arrs = _content_sample(seed=seed)
    if dtype == "f32":
        arrs = (arrs[0].astype(np.float32),) + arrs[1:]
    key = jax.random.PRNGKey(seed)
    centers = jax.random.randint(key, (2, 2), S // 2, 2 * S - S // 2)
    want = ja.mosaic4_batch(_jsample(arrs), key, S)
    got = ta.mosaic4_batch(ta.DeviceSample(*map(T, arrs)), T(centers).int(), S)
    assert got.images.shape == (2, 3, 2 * S, 2 * S) and got.images.dtype == T(arrs[0]).dtype
    np.testing.assert_array_equal(nhwc(got.images), np.asarray(want.images))
    assert (got.images != 114).any() and (got.images == 114).any()
    for name in ("sizes", "boxes", "labels", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


def test_mosaic4_quadrants_hold_their_sources():
    """Each quadrant's rectangle shows the source shifted by its integer offset."""
    S = 32
    imgs, sizes, boxes, labels, mask = _content_sample(B=4, S=S, seed=5)
    center = np.asarray([[S - 3, S + 5]], np.int32)
    got = ta.mosaic4_batch(ta.DeviceSample(*map(T, (imgs, sizes, boxes, labels, mask))), T(center), S)
    x1a, y1a, x2a, y2a, x1b, y1b = (t[0].numpy() for t in
                                    ta._mosaic_placement(T(sizes)[None], T(center), S))
    canvas = got.images[0].numpy()
    covered = np.zeros((2 * S, 2 * S), bool)
    for q in range(4):
        h, w = y2a[q] - y1a[q], x2a[q] - x1a[q]
        np.testing.assert_array_equal(canvas[:, y1a[q]:y2a[q], x1a[q]:x2a[q]],
                                      imgs[q][:, y1b[q]:y1b[q] + h, x1b[q]:x1b[q] + w])
        covered[y1a[q]:y2a[q], x1a[q]:x2a[q]] = True
    assert (canvas[:, ~covered] == 114).all()


@pytest.mark.parametrize("seed,prob", [(0, 0.5), (1, 0.5), (2, 1.0), (3, 0.0)])
def test_flip_batch_matches_jax(seed, prob):
    arrs = _sample(B=6, S=32, seed=seed)
    arrs = (arrs[0].astype(np.float32),) + arrs[1:]
    key = jax.random.PRNGKey(seed)
    do = np.asarray(jax.random.uniform(key, (6,)) < prob)
    want = ja.flip_batch(_jsample(arrs), key, prob)
    got = ta.flip_batch(ta.DeviceSample(*map(T, arrs)), T(do))
    np.testing.assert_array_equal(nhwc(got.images), np.asarray(want.images))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bilinear_sample_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, H, W, h, w = 3, 40, 56, 32, 48
    imgs = rng.integers(0, 256, (B, 3, H, W)).astype(np.float32)
    xs = rng.uniform(-4, W + 3, (B, h, w)).astype(np.float32)
    ys = rng.uniform(-4, H + 3, (B, h, w)).astype(np.float32)
    xs[0, 0, :4] = [-1.0, 0.0, W - 1.0, W]  # taps exactly on and one off the border
    ys[0, 0, :4] = [0.0, -1.0, H, H - 1.0]
    got = ta._bilinear_sample(T(imgs), T(xs), T(ys))
    want = np.stack([np.asarray(ja._bilinear_sample(jnp.asarray(nhwc(imgs)[b]), jnp.asarray(xs[b]),
                                                    jnp.asarray(ys[b]))) for b in range(B)])
    assert got.shape == (B, 3, h, w)
    assert_warp_close(got.numpy(), want, min_equal=0.999)
    assert float(got.min()) >= 0 and float(got.max()) <= 255
    assert (got == got.round()).all()
    far = ta._bilinear_sample(T(imgs), T(xs) + 1000.0, T(ys))
    assert (far == 114.0).all()


def test_tap_matrix_matches_jax():
    s = np.random.default_rng(6).uniform(-3, 50, (4, 32)).astype(np.float32)
    s[0, :3] = [-1.0, 0.0, 47.0]
    A, cov = ta._tap_matrix(T(s), 48)
    Aj, covj = ja._tap_matrix(jnp.asarray(s), 48)
    np.testing.assert_array_equal(A.numpy(), np.asarray(Aj))
    np.testing.assert_array_equal(cov.numpy(), np.asarray(covj))
    assert (A != 0).sum(-1).max() <= 2 and float(cov.min()) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_axis_aligned_warp_matches_jax_and_gather_path(seed):
    S = 48
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (4, 3, S, S)).astype(np.float32)
    jv, tv = _values(seed, 4, **AXIS)
    Mj = ja._affine_matrices(jv, S, S, S, S)
    minv = np.asarray(jnp.linalg.inv(Mj))
    got = ta._axis_aligned_warp(T(imgs), T(minv), S)
    want = ja._axis_aligned_warp(jnp.asarray(nhwc(imgs)), jnp.asarray(minv), S)
    assert_warp_close(got.numpy(), want, min_equal=0.999)
    # the port's own per-pixel path computes the same warp
    sample = ta.DeviceSample(T(imgs), torch.full((4, 2), S, dtype=torch.int32),
                             torch.zeros(4, 1, 4), torch.zeros(4, 1, dtype=torch.int32),
                             torch.zeros(4, 1, dtype=torch.bool))
    dense = ta.affine_batch(sample, tv, S, axis_aligned=True)
    gathered = ta.affine_batch(sample, tv, S, axis_aligned=False)
    assert_warp_close(dense.images.numpy(), nhwc(gathered.images), min_equal=0.999)


# a rotating affine never takes the separable warp
@pytest.mark.parametrize("recipe,axis_aligned", [("general", False), ("axis", False), ("axis", True),
                                                 ("identity", False), ("identity", True)])
@pytest.mark.parametrize("seed", [0, 1])
def test_affine_batch_matches_jax(seed, recipe, axis_aligned):
    S = 64
    imgs, sizes, boxes, labels, mask = _sample(B=4, S=S, Tn=6, seed=seed)
    arrs = (imgs.astype(np.float32), sizes, boxes, labels, mask)
    jv, tv = _values(seed + 10, 4, **{"general": GENERAL, "axis": AXIS, "identity": IDENTITY}[recipe])
    want = ja.affine_batch(_jsample(arrs), jv, S, axis_aligned=axis_aligned)
    got = ta.affine_batch(ta.DeviceSample(*map(T, arrs)), tv, S, axis_aligned=axis_aligned)
    assert_warp_close(got.images.numpy(), want.images)
    assert got.images.is_contiguous()  # the HSV kernel takes contiguous planes
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-4)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.sizes.numpy(), np.asarray(want.sizes))
    if recipe == "identity":
        np.testing.assert_array_equal(got.images.numpy(), arrs[0])
        np.testing.assert_allclose(got.boxes.numpy(), boxes, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_affine_batch_on_mosaic_canvas_matches_jax(seed):
    """The general-affine recipe: 2S canvas, border (-S//2, -S//2), S out."""
    S = 48
    arrs = _content_sample(B=8, S=S, seed=seed)
    key = jax.random.PRNGKey(seed)
    centers = jax.random.randint(key, (2, 2), S // 2, 2 * S - S // 2)
    jv, tv = _values(seed + 20, 2, **GENERAL)
    jm = ja.mosaic4_batch(_jsample(arrs), key, S)
    want = ja.affine_batch(jm._replace(images=jm.images.astype(jnp.float32)), jv, S,
                           border=(-S // 2, -S // 2))
    tm = ta.mosaic4_batch(ta.DeviceSample(*map(T, arrs)), T(centers).int(), S)
    got = ta.affine_batch(tm._replace(images=tm.images.float()), tv, S, border=(-S // 2, -S // 2))
    assert got.images.shape == (2, 3, S, S)
    assert_warp_close(got.images.numpy(), want.images)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-4)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    with pytest.raises(ValueError, match="border"):
        ta.affine_batch(tm._replace(images=tm.images.float()), tv, S)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mosaic_affine_exact_matches_jax_and_composed_path(seed, flip):
    S = 64
    arrs = _content_sample(seed=seed)
    km, values, do, centers = _jax_draws(seed, 2, S, flip)
    tv = ta.AffineBatchValues(*(T(v) for v in values))
    tsample = ta.DeviceSample(*map(T, arrs))
    tdo = None if do is None else T(do)
    got = ta.mosaic_affine_batch(tsample, T(centers).int(), tv, S, flip_do=tdo, precision="exact")
    assert got.images.dtype == torch.float32 and got.images.shape == (2, 3, S, S)
    assert got.images.is_contiguous()  # the HSV kernel takes contiguous planes
    js = ja.mosaic_affine_batch(ja.DeviceSample(*map(jnp.asarray, arrs)), km, values, S,
                                flip_do=do, precision="exact", planar=True)
    assert_warp_close(got.images.numpy(), nhwc(js.images))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(js.boxes), atol=1e-4)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(js.mask))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(js.labels))
    # the port's composed path: canvas, dense separable warp, then the flip
    canvas = ta.mosaic4_batch(tsample, T(centers).int(), S)
    comp = ta.affine_batch(canvas._replace(images=canvas.images.float()), tv, S,
                           border=(-S // 2, -S // 2), axis_aligned=True)
    if tdo is not None:
        comp = comp._replace(images=ta.flip_batch(comp, tdo).images)
    assert_warp_close(got.images.numpy(), nhwc(comp.images), min_equal=0.999)
    torch.testing.assert_close(got.boxes, comp.boxes, rtol=0, atol=0)
    assert torch.equal(got.mask, comp.mask)
    # and the fast path stays in its class around it (the JAX contract)
    fast = ta.mosaic_affine_batch(tsample, T(centers).int(), tv, S, flip_do=tdo)
    d = (fast.images - got.images).abs()
    assert float(d.max()) <= 4.0 and float((d <= 1).float().mean()) > 0.99
    assert torch.equal(fast.boxes, got.boxes) and torch.equal(fast.mask, got.mask)
    with pytest.raises(ValueError, match="precision"):
        ta.mosaic_affine_batch(tsample, T(centers).int(), tv, S, precision="bf16")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_mixup_batch_matches_jax(seed, dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    a, b = _sample(B=4, S=32, seed=seed), _sample(B=4, S=32, seed=seed + 7)
    key = jax.random.PRNGKey(seed)
    r = np.asarray(jax.random.beta(key, 32.0, 32.0, (4, 1, 1, 1)))
    ja_, jb_ = (s._replace(images=s.images.astype(jdt)) for s in (_jsample(a), _jsample(b)))
    want = ja.mixup_batch(ja_, jb_, key)
    ta_, tb_ = (ta.DeviceSample(T(s[0]).to(tdt), *map(T, s[1:])) for s in (a, b))
    got = ta.mixup_batch(ta_, tb_, T(r))
    assert got.images.dtype == torch.float32  # bf16 * f32 ratio: never blended in bf16
    np.testing.assert_allclose(nhwc(got.images), np.asarray(want.images, np.float32), atol=1e-5)
    assert got.boxes.shape == (4, 10, 4)
    for name in ("sizes", "boxes", "labels", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


def test_draw_mixup_is_a_beta_32_32_draw():
    r, do = ta.draw_mixup(torch.Generator().manual_seed(0), 4096, 0.3)
    assert r.shape == (4096, 1, 1, 1) and r.dtype == torch.float32
    assert do.shape == (4096,) and do.dtype == torch.bool
    assert 0.0 < float(r.min()) and float(r.max()) < 1.0
    # beta(32, 32): mean 1/2, variance 1/(4 * 65)
    assert abs(float(r.mean()) - 0.5) < 0.005
    assert abs(float(r.var()) - 1 / 260) < 4e-4
    assert abs(float(do.float().mean()) - 0.3) < 0.03
    r2, do2 = ta.draw_mixup(torch.Generator().manual_seed(0), 4096, 0.3)
    assert torch.equal(r, r2) and torch.equal(do, do2)
    r3, _ = ta.draw_mixup(torch.Generator().manual_seed(1), 4096, 0.3)
    assert not torch.equal(r, r3)
