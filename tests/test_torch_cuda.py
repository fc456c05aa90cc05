"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (from a fixture) where there is no card.
This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which imports JAX.)
"""

import numpy as np
import pytest
import torch

from object_detection_cib_torch.models import layers
from object_detection_cib_torch.ops import augment as aug_ops
from object_detection_cib_torch.ops import bn_silu as bn_ops
from object_detection_cib_torch.ops import gather as gather_ops
from object_detection_cib_torch.ops import hsv as hsv_ops
from object_detection_cib_torch.ops import nms as nms_ops
from object_detection_cib_torch.ops import warp as warp_ops
from object_detection_cib_torch.ops.build import build_all
from object_detection_cib_torch.test_utils import bn_silu as bn_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    build_all()
    return torch.device("cuda")


def _boxes(B, K, n_live, seed, span=300.0, wh=(5.0, 90.0)):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(B, K, 2, generator=g) * span
    sz = wh[0] + torch.rand(B, K, 2, generator=g) * (wh[1] - wh[0])
    cls = torch.randint(0, 3, (B, K, 1), generator=g).float() * 4096.0
    boxes = torch.cat([xy, xy + sz], -1) + cls
    live = torch.zeros(B, K, dtype=torch.bool)
    live[:, :n_live] = True
    live &= torch.rand(B, K, generator=g) > 0.1
    return boxes, live


@pytest.mark.parametrize(
    "B,K,n_live,thr",
    [(1, 1, 1, 0.5), (2, 255, 200, 0.45), (3, 257, 257, 0.6), (4, 2048, 2048, 0.6),
     (2, 1000, 700, 0.3), (1, nms_ops.MAX_K, 5000, 0.6), (32, 2048, 1500, 0.6),
     (64, 2048, 2048, 0.6), (2, 64, 64, 0.45), (2, 65, 65, 0.45), (1, 2048, 2048, 0.6),
     (3, 130, 130, -0.5), (2, 300, 0, 0.5)],
)
def test_kernel_equals_plain_bitwise(dev, B, K, n_live, thr):
    boxes, live = _boxes(B, K, n_live, seed=K + B)
    boxes, live = boxes.to(dev), live.to(dev)
    before = nms_ops.greedy_nms_mask.launches
    got = nms_ops.greedy_nms_mask(boxes, live, thr)
    torch.cuda.synchronize()
    assert nms_ops.greedy_nms_mask.launches == before + 1
    want = nms_ops.greedy_nms_mask_plain(boxes, live, thr)
    assert torch.equal(got, want)


def test_kernel_chain_case(dev):
    boxes = torch.zeros(1, 256, 4)
    boxes[0, :3] = torch.tensor([[0, 0, 10, 10], [3, 0, 13, 10], [6, 0, 16, 10]], dtype=torch.float32)
    live = torch.zeros(1, 256, dtype=torch.bool)
    live[0, :3] = True
    got = nms_ops.greedy_nms_mask(boxes.to(dev), live.to(dev), 0.45)
    assert got[0, :3].tolist() == [True, False, True]


def test_kernel_edge_images(dev):
    """One batch: no live box; disjoint boxes, all kept; equal boxes, box 0
    suppresses all others."""
    boxes = torch.zeros(3, 300, 4)
    boxes[:2, :, 0] = torch.arange(300.0) * 20.0
    boxes[:2, :, 2] = boxes[:2, :, 0] + 10.0
    boxes[:2, :, 3] = 10.0
    boxes[2] = torch.tensor([0.0, 0.0, 100.0, 100.0])
    live = torch.ones(3, 300, dtype=torch.bool)
    live[0] = False
    got = nms_ops.greedy_nms_mask(boxes.to(dev), live.to(dev), 0.5)
    assert torch.equal(got, nms_ops.greedy_nms_mask_plain(boxes.to(dev), live.to(dev), 0.5))
    assert not got[0].any() and got[1].all()
    assert got[2].nonzero().flatten().tolist() == [0]


def test_kernel_workspace_is_not_stale(dev):
    """Calls in a row on different shapes, none synchronised in between: each
    call's workspace holds only its own words."""
    shapes = [(4, 2048, 0.6), (2, 130, 0.3), (7, 1000, 0.45), (1, 64, 0.5), (4, 2048, 0.6)]
    cases = [(*(t.to(dev) for t in _boxes(B, K, K, seed=i)), thr)
             for i, (B, K, thr) in enumerate(shapes)]
    got = [nms_ops.greedy_nms_mask(*case) for case in cases]
    torch.cuda.synchronize()
    for g, case in zip(got, cases):
        assert torch.equal(g, nms_ops.greedy_nms_mask_plain(*case))


def test_kernel_batch_in_workspace_chunks(dev, monkeypatch):
    """A workspace cap below the batch's need: the images go through in
    chunks that reuse it."""
    boxes, live = (t.to(dev) for t in _boxes(5, 300, 300, seed=11))
    monkeypatch.setattr(nms_ops, "WORKSPACE_CAP_BYTES", 2 * 300 * 6 * 8)
    got = nms_ops.greedy_nms_mask(boxes, live, 0.45)
    assert torch.equal(got, nms_ops.greedy_nms_mask_plain(boxes, live, 0.45))


def test_kernel_wrapper_refuses(dev):
    boxes, live = _boxes(1, 16, 16, seed=0)
    boxes, live = boxes.to(dev), live.to(dev)
    with pytest.raises(ValueError, match="contiguous"):
        nms_ops.greedy_nms_mask(torch.zeros(1, 32, 4, device=dev)[:, ::2], live, 0.5)
    with pytest.raises(ValueError, match="MAX_K"):
        big = torch.zeros(1, nms_ops.MAX_K + 1, 4, device=dev)
        nms_ops.greedy_nms_mask(big, torch.ones(1, nms_ops.MAX_K + 1, dtype=torch.bool, device=dev), 0.5)
    with pytest.raises(ValueError):
        nms_ops.greedy_nms_mask(boxes, live.cpu(), 0.5)


# ------------------------------------------------------------ K2/K3 gather

@pytest.mark.parametrize("shape", [(7, 3, 16, 128), (9, 3, 64, 64), (5, 3, 13, 7)])
def test_gather_planar_equals_plain(dev, shape):
    g = torch.Generator().manual_seed(shape[-1])
    corpus = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
    idx = torch.tensor([4, 0, 3, 4, 1], dtype=torch.int32)
    before = gather_ops.gather_rows_planar.launches
    got = gather_ops.gather_rows_planar(corpus.to(dev), idx.to(dev))
    torch.cuda.synchronize()
    assert gather_ops.gather_rows_planar.launches == before + 1
    assert torch.equal(got.cpu(), gather_ops.gather_rows_plain(corpus, idx))


def test_gather_flat_equals_plain(dev):
    g = torch.Generator().manual_seed(1)
    flat = torch.randint(0, 256, (6, 8, 384), generator=g, dtype=torch.uint8)
    idx = torch.tensor([5, 5, 0, 2], dtype=torch.int32)
    before = gather_ops.gather_rows_flat.launches
    got = gather_ops.gather_rows_flat(flat.to(dev), idx.to(dev))
    torch.cuda.synchronize()
    assert gather_ops.gather_rows_flat.launches == before + 1
    assert torch.equal(got.cpu(), flat[idx.long()])


def _gather_expected(corpus, idx):
    """corpus[idx] with zero rows where an index lies outside [0, N)."""
    n = corpus.shape[0]
    ok = (idx >= 0) & (idx < n)
    want = gather_ops.gather_rows_plain(corpus, torch.where(ok, idx, 0))
    want[~ok] = 0
    return want


@pytest.mark.parametrize("K", [1, 255, 256, 4096])
def test_gather_aligned_rows_equal_plain(dev, K):
    # rows of 49,920 B: 16-byte aligned, so copied as 16-byte vectors
    g = torch.Generator().manual_seed(K)
    corpus = torch.randint(0, 256, (600, 3, 40, 416), generator=g, dtype=torch.uint8)
    idx = torch.randint(0, 600, (K,), generator=g, dtype=torch.int32)
    idx[: K // 3] = idx[0]  # repeated rows
    src = corpus.to(dev)
    got = gather_ops.gather_rows_planar(src, idx.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got, gather_ops.gather_rows_plain(src, idx.to(dev).long()))


@pytest.mark.parametrize("shape", [(9, 3, 40, 416), (9, 3, 13, 7), (9, 3, 4, 6)])
def test_gather_out_of_range_rows_are_zero(dev, shape):
    g = torch.Generator().manual_seed(5)
    corpus = torch.randint(1, 256, shape, generator=g, dtype=torch.uint8)
    idx = torch.tensor([3, -1, 8, 9, 3, 1000, -7, 0], dtype=torch.int32)
    got = gather_ops.gather_rows_planar(corpus.to(dev), idx.to(dev))
    torch.cuda.synchronize()
    want = _gather_expected(corpus, idx)
    assert torch.equal(got.cpu(), want)
    assert not got[[1, 3, 5, 6]].any() and got[[0, 2, 4, 7]].all()


@pytest.mark.parametrize("offset", [1, 2, 4, 8, 16])
def test_gather_unaligned_source_base(dev, offset):
    # a contiguous view whose base lies `offset` bytes into its buffer: the
    # copy takes the widest vector that the base alignment allows
    n, row = 11, 3 * 16 * 64
    g = torch.Generator().manual_seed(offset)
    buf = torch.randint(0, 256, (n * row + offset,), generator=g, dtype=torch.uint8).to(dev)
    src = buf[offset:].view(n, 3, 16, 64)
    assert src.is_contiguous() and src.data_ptr() % 16 == offset % 16
    idx = torch.tensor([10, 0, 5, 5, 2], dtype=torch.int32, device=dev)
    got = gather_ops.gather_rows_planar(src, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, gather_ops.gather_rows_plain(src, idx))


# ------------------------------------------------------------------ K4 HSV

_HSV_GAINS = [[0.985, 0.3, 0.6], [1.015, 1.7, 1.4], [1.0, 1.0, 1.0], [0.99, 1.69, 0.61]]


def _hsv_input(case):
    """(4 or 5, 3, H, W) f32 pixels of one case of ``test_hsv_equals_plain``."""
    g = torch.Generator().manual_seed(2)
    if case == "integral":
        return torch.randint(0, 256, (4, 3, 32, 416), generator=g).float()
    if case == "non_integral":
        return torch.rand(4, 3, 32, 416, generator=g) * 255.0
    if case == "odd_plane":  # 91 positions: not a multiple of 8, element path
        return torch.randint(0, 256, (4, 3, 13, 7), generator=g).float()
    if case == "offset_base":  # made 16-byte unaligned by the test
        return torch.randint(0, 256, (4, 3, 16, 64), generator=g).float()
    # every (v, diff) pair, in both channel orders: entries 0, 1 and 255 of
    # both division tables are read
    v, d = torch.meshgrid(torch.arange(256), torch.arange(256), indexing="ij")
    v, d = v.flatten(), torch.minimum(v, d).flatten()
    px = torch.stack([torch.cat([v, v - d]), torch.cat([v - d, v]), torch.cat([v - d // 2, v - d])])
    return px.view(1, 3, 256, 512).float().expand(4, -1, -1, -1).contiguous()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["integral", "non_integral", "odd_plane", "offset_base", "tables"])
def test_hsv_equals_plain(dev, dtype, case):
    x = _hsv_input(case).to(dtype).to(dev)
    if case == "offset_base":
        buf = torch.zeros(x.numel() + 1, dtype=dtype, device=dev)
        buf[1:] = x.flatten()
        x = buf[1:].view(x.shape)  # one element past a 16-byte boundary
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    r = torch.tensor(_HSV_GAINS, device=dev)
    before = hsv_ops.hsv_planar.launches
    got = hsv_ops.hsv_planar(x, r)
    torch.cuda.synchronize()
    assert hsv_ops.hsv_planar.launches == before + 1
    want = hsv_ops.hsv_planar_plain(x, r)
    assert torch.equal(got, want)


# ----------------------------------------------------------------- K5 warp

def _random_taps(G, So, S, seed):
    rng = np.random.default_rng(seed)

    def axis():
        j0 = rng.integers(-3, S + 1, (G, 4, So)).astype(np.int32)
        w0 = rng.random((G, 4, So), dtype=np.float32)
        w1 = rng.random((G, 4, So), dtype=np.float32)
        w0[rng.random((G, 4, So)) < 0.2] = 0.0
        w1[rng.random((G, 4, So)) < 0.2] = 0.0
        return [torch.from_numpy(a) for a in (j0, w0, w1)]

    imgs = torch.from_numpy(rng.integers(0, 256, (G, 4, 3, S, S), np.uint8))
    return imgs, axis() + axis()


@pytest.mark.parametrize("S", [64, 416, 640])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_warp_equals_plain(dev, S, out_dtype):
    imgs, taps = _random_taps(2, S, S, seed=S)
    taps[4][1] = 0.0  # quadrant 1 of group 1 has no y-weight: skipped
    taps[5][1] = 0.0
    args = [imgs.to(dev)] + [t.to(dev) for t in taps]
    before = warp_ops.warp_quadrants.launches
    got = warp_ops.warp_quadrants(*args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert warp_ops.warp_quadrants.launches == before + 1
    want = warp_ops.warp_quadrants_plain(*args, out_dtype=out_dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("flip", [False, True])
def test_mosaic_affine_on_card_equals_plain(dev, flip):
    rng = np.random.default_rng(3)
    B, S, T = 8, 96, 5
    sample = aug_ops.DeviceSample(
        torch.from_numpy(rng.integers(0, 256, (B, 3, S, S), np.uint8)),
        torch.from_numpy(rng.integers(S // 2, S + 1, (B, 2)).astype(np.int32)),
        torch.from_numpy(rng.uniform(0, S - 12, (B, T, 4)).astype(np.float32)).sort(-1).values,
        torch.from_numpy(rng.integers(0, 3, (B, T)).astype(np.int32)),
        torch.from_numpy(rng.random((B, T)) < 0.7),
    )
    gen = torch.Generator().manual_seed(4)
    centers = aug_ops.draw_mosaic_centers(gen, 2, S)
    values = aug_ops.draw_affine_values(gen, 2)
    do = aug_ops.draw_flip(gen, 2, 0.5) if flip else None
    cpu = aug_ops.mosaic_affine_batch(sample, centers, values, S, flip_do=do)
    on = lambda t: t.to(dev)  # noqa: E731
    gpu = aug_ops.mosaic_affine_batch(
        aug_ops.DeviceSample(*map(on, sample)), on(centers),
        aug_ops.AffineBatchValues(*map(on, values)), S,
        flip_do=None if do is None else on(do))
    # the card inverts M with its own solver: taps may move by an ulp, so the
    # pixels are held to the JAX test's class, boxes to 1e-4
    d = (gpu.images.cpu() - cpu.images).abs()
    assert d.max() <= 2 and (d == 0).float().mean() > 0.85
    assert torch.allclose(gpu.boxes.cpu(), cpu.boxes, atol=1e-4)
    assert torch.equal(gpu.mask.cpu(), cpu.mask)


def _mosaic_taps(G, S, scale, flip, seed):
    """Taps of mosaic draws at a fixed affine scale, as the training step
    makes them (translate in [0.4, 0.6], no rotation or shear)."""
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.integers(0, 256, (G, 4, 3, S, S), np.uint8))
    sizes = torch.from_numpy(rng.integers(S // 2, S + 1, (G, 4, 2)).astype(np.int32))
    centers = torch.from_numpy(rng.integers(S // 2, 2 * S - S // 2, (G, 2)).astype(np.int32))
    zeros = torch.zeros(G)
    values = aug_ops.AffineBatchValues(
        zeros, zeros, zeros, torch.full((G,), scale), zeros, zeros,
        torch.from_numpy(rng.uniform(0.4, 0.6, G).astype(np.float32)),
        torch.from_numpy(rng.uniform(0.4, 0.6, G).astype(np.float32)))
    placement = aug_ops._mosaic_placement(sizes, centers, S)
    M = aug_ops._affine_matrices(values, 2 * S, 2 * S, S, S)
    flip_do = torch.from_numpy(rng.random(G) < 0.5) if flip else None
    return imgs, list(aug_ops.mosaic_warp_taps(M, placement, S, flip_do))


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("scale", [0.5, 1.5])
def test_warp_mosaic_taps_equal_plain(dev, scale, flip):
    imgs, taps = _mosaic_taps(8, 416, scale, flip, seed=int(scale * 10) + flip)
    for t in taps[1:3] + taps[4:6]:
        t[3, 1] = 0.0  # quadrant 1 of group 3 lies wholly outside its window
    args = [imgs.to(dev)] + [t.to(dev) for t in taps]
    for out_dtype in (torch.bfloat16, torch.float32):
        got = warp_ops.warp_quadrants(*args, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, warp_ops.warp_quadrants_plain(*args, out_dtype=out_dtype))


@pytest.mark.parametrize("S,So", [(416, 320), (320, 416), (416, 520), (52, 100), (45, 37)])
def test_warp_other_sizes_equal_plain(dev, S, So):
    # So != S, and So wider than one pass of the kernel (448 columns); S not
    # a multiple of 16 (4-byte copies) or of 4 (byte copies); So odd
    imgs, taps = _random_taps(3, So, S, seed=S + So)
    args = [imgs.to(dev)] + [t.to(dev) for t in taps]
    for out_dtype in (torch.bfloat16, torch.float32):
        got = warp_ops.warp_quadrants(*args, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, warp_ops.warp_quadrants_plain(*args, out_dtype=out_dtype))


# ------------------------------------------------------------- the recipes

def _small_pipes(dev, **kw):
    """The same 64 px fake corpus and recipe on the CPU and on the card."""
    from object_detection_cib_torch.data.device_pipeline import DeviceDataPipeline
    from object_detection_cib_torch.data.host_augment import AugParams
    from object_detection_cib_torch.data.synthetic import build_fake_manifest

    info = build_fake_manifest(num_classes=3, num_images=24, image_size=64, seed=2)
    aug = kw.pop("aug_params", AugParams())
    return [DeviceDataPipeline(info, 64, 4, aug, max_targets=40, seed=0,
                               feed_dtype=torch.float32, device=d, **kw) for d in ("cpu", dev)]


def test_hsv_f32_on_composed_output_equals_plain(dev):
    """K4's f32 instance on what the composed path hands it: the general
    affine's output at 416, scaled off the integer grid."""
    from object_detection_cib_torch.data.host_augment import AffineParams, AugParams

    g = torch.Generator(device=dev).manual_seed(0)
    canvas = torch.randint(0, 256, (8, 3, 832, 832), generator=g, device=dev).float()
    values = aug_ops.draw_affine_values(g, 8, **AffineParams(degrees=10.0, shear=2.0,
                                                             perspective=5e-4)._asdict())
    sample = aug_ops.DeviceSample(canvas, torch.full((8, 2), 832, dtype=torch.int32, device=dev),
                                  torch.zeros(8, 1, 4, device=dev),
                                  torch.zeros(8, 1, dtype=torch.int32, device=dev),
                                  torch.zeros(8, 1, dtype=torch.bool, device=dev))
    warped = aug_ops.affine_batch(sample, values, 416, border=(-208, -208)).images
    assert warped.dtype == torch.float32 and (warped == warped.round()).all()
    x = (warped * 0.77 + 3.3).contiguous()  # non-integral, as after a blend
    r = aug_ops.hsv_gains(g, 8, *AugParams().hsv_params)
    before = hsv_ops.hsv_planar.launches
    got = hsv_ops.hsv_planar(x, r)
    assert hsv_ops.hsv_planar.launches == before + 1
    assert torch.equal(got, aug_ops.hsv_batch(x, r, channel_axis=1))
    assert torch.equal(hsv_ops.hsv_planar(warped, r), aug_ops.hsv_batch(warped, r, channel_axis=1))


def test_gather_64_rows_equals_plain(dev):
    """K2 at the no-mosaic step's K = B = 64 rows of a 416 corpus."""
    g = torch.Generator(device=dev).manual_seed(1)
    corpus = torch.randint(0, 256, (200, 3, 416, 416), generator=g, device=dev, dtype=torch.uint8)
    idx = torch.randint(0, 200, (64,), generator=g, device=dev, dtype=torch.int32)
    before = gather_ops.gather_rows_planar.launches
    got = gather_ops.gather_rows_planar(corpus, idx)
    assert gather_ops.gather_rows_planar.launches == before + 1
    assert got.shape == (64, 3, 416, 416) and torch.equal(got, corpus[idx.long()])


@pytest.mark.parametrize("recipe", ["mixup", "mixup_exact", "no_mosaic", "general_affine"])
def test_recipe_step_on_card_matches_cpu(dev, recipe):
    """One whole gather-and-augment step, same rows and draws on both devices:
    pixels within 1/255, boxes within 1e-4, labels and masks equal; the
    kernels launch as the recipe says."""
    from object_detection_cib_torch.data.host_augment import AffineParams, AugParams, HSVParams

    # HSV off: it turns the warp's one-unit differences into several
    aug = AugParams(hsv_params=HSVParams.no_aug())
    kw = {"mixup": dict(mixup_prob=0.5), "mixup_exact": dict(mixup_prob=0.5, warp_precision="exact"),
          "no_mosaic": dict(use_mosaic=False),
          "general_affine": dict(aug_params=aug._replace(
              affine_params=AffineParams(degrees=10.0, shear=2.0, perspective=5e-4)))}[recipe]
    kw.setdefault("aug_params", aug)
    cpu, card = _small_pipes(dev, **kw)
    groups, secs = cpu._epoch_plan()
    draws = cpu.draw()
    idx = torch.from_numpy(groups[0].astype(np.int32))
    idx2 = torch.from_numpy(secs[0].astype(np.int32)) if secs.size else None
    want, wovf = cpu.gather_augment(idx, draws, idx2)
    counted = (gather_ops.gather_rows_planar, hsv_ops.hsv_planar, warp_ops.warp_quadrants)
    before = [fn.launches for fn in counted]
    got, govf = card.gather_augment(idx.to(dev), draws.to(dev), None if idx2 is None else idx2.to(dev))
    launched = [fn.launches - b for fn, b in zip(counted, before)]
    groups_n = 2 if recipe.startswith("mixup") else 1
    assert launched == [groups_n, 0, groups_n if recipe == "mixup" else 0]
    diff = (got.images.cpu() - want.images).abs()
    assert float(diff.max()) <= 1.0 / 255 + 1e-6
    assert float((diff > 1e-6).float().mean()) < 0.001 * groups_n
    torch.testing.assert_close(got.boxes.cpu(), want.boxes, rtol=0, atol=1e-4)
    assert torch.equal(got.labels.cpu(), want.labels) and torch.equal(got.mask.cpu(), want.mask)
    assert int(govf) == int(wovf)


def test_exact_warp_refuses_tf32(dev):
    cpu, card = _small_pipes(dev, warp_precision="exact")
    groups, _ = cpu._epoch_plan()
    idx = torch.from_numpy(groups[0].astype(np.int32)).to(dev)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            card.gather_augment(idx, card.draw())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    card.gather_augment(idx, card.draw())


# ------------------------------------------------------------ the letterbox

def _raw_images(sizes, seed):
    """Seeded (h, w, 3) uint8 images, None for a failed file, in one blob."""
    from object_detection_cib_torch.data.native_loader import RawImages

    rng = np.random.default_rng(seed)
    return RawImages.from_arrays([None if hw is None else rng.integers(0, 256, hw + (3,), dtype=np.uint8)
                                  for hw in sizes])


@pytest.mark.parametrize("S", [416, 640, 97])
@pytest.mark.parametrize("center", [False, True])
def test_letterbox_equals_plain_bitwise(dev, S, center):
    """The kernel against its plain version on the card, planar rows and an
    NHWC view: COCO-like sizes, 1 x N, N x 1, 97 x 1203, a failed file."""
    from object_detection_cib_torch.ops import letterbox as lb

    sizes = [(480, 640), (640, 480), (427, 640), (375, 500), (1, 517), (517, 1), (1203, 97), (97, 1203),
             (1, 1), None, (S, S), (640, 640)]
    raw = _raw_images(sizes, seed=S + center)
    on = [t.to(dev) for t in raw[:3]]
    for nhwc in (False, True):
        shape = (len(sizes), S, S, 3) if nhwc else (len(sizes), 3, S, S)
        got, want = (torch.zeros(shape, dtype=torch.uint8, device=dev) for _ in range(2))
        view = (lambda t: t.permute(0, 3, 1, 2)) if nhwc else (lambda t: t)
        before = lb.letterbox.launches
        got_sizes = lb.letterbox(*on, view(got), center)
        torch.cuda.synchronize()
        assert lb.letterbox.launches == before + 1
        want_sizes = lb.letterbox_plain(*on, view(want), center)
        assert torch.equal(got_sizes, want_sizes)
        assert torch.equal(got, want)
    assert got_sizes[9].tolist() == [0, 0]


def test_pack_rows_on_card_equals_cpu(dev):
    """JPEG bytes decoded on the host and letterboxed into rows on the card:
    the CPU's plain version's bytes and sizes, a failing file included."""
    import io

    from PIL import Image

    from object_detection_cib_torch.data import native_loader

    rng = np.random.default_rng(3)
    bufs = []
    for h, w in [(480, 640), (427, 640), (1, 300), (1203, 97)]:
        b = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(b, format="JPEG")
        bufs.append(b.getvalue())
    bufs.append(b"not a jpeg")
    cpu = torch.zeros((5, 3, 416, 416), dtype=torch.uint8)
    card = torch.zeros((5, 3, 416, 416), dtype=torch.uint8, device=dev)
    s_cpu, f_cpu = native_loader.pack_rows(bufs, cpu)
    s_card, f_card = native_loader.pack_rows(bufs, card)
    assert f_cpu == f_card == 1 and s_card.is_cuda
    assert torch.equal(s_card.cpu(), s_cpu) and torch.equal(card.cpu(), cpu)


# ------------------------------------------------------- the host feeds

def test_corpus_from_canvases_on_card_equals_cpu(dev):
    """The corpus built from seeded canvases (the JPEG corpus's constructor):
    the transpose on the card gives the CPU's bytes, chunk edges included."""
    from object_detection_cib_torch.data.device_pipeline import DeviceCorpus, fake_canvases
    from object_detection_cib_torch.data.synthetic import build_fake_manifest

    info = build_fake_manifest(num_classes=3, num_images=DeviceCorpus.UPLOAD_ROWS + 5,
                               image_size=96, seed=1)
    canv, sizes = fake_canvases(info, 96, seed=2)
    cpu = DeviceCorpus.from_canvases(info, canv, sizes, "cpu")
    card = DeviceCorpus.from_canvases(info, canv, sizes, dev)
    assert card.images.is_cuda and card.images.is_contiguous()
    for name in ("images", "sizes", "t_boxes", "t_labels", "t_mask"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name)), name
    assert torch.equal(cpu.images, torch.from_numpy(canv).permute(0, 3, 1, 2))


@pytest.mark.parametrize("recipe", ["mosaic", "no_mosaic"])
def test_host_fed_step_on_card_matches_cpu(dev, recipe):
    """One host-fed step (fake groups, loaded on the host and copied up), the
    same rows and draws on both devices, at the gates of the recipes' CPU
    against card check (HSV off: 1/255 on under 0.1% of pixels)."""
    from object_detection_cib_torch.data.host_augment import AugParams, HSVParams

    kw = dict(aug_params=AugParams(hsv_params=HSVParams.no_aug()), device_cache=False)
    if recipe == "no_mosaic":
        kw["use_mosaic"] = False
    cpu, card = _small_pipes(dev, **kw)
    groups, _ = cpu._epoch_plan()
    draws = cpu.draw()
    want, wovf = cpu.load_augment(groups[0], draws)
    counted = (gather_ops.gather_rows_planar, hsv_ops.hsv_planar, warp_ops.warp_quadrants)
    before = [fn.launches for fn in counted]
    got, govf = card.load_augment(groups[0], draws.to(dev))
    assert [fn.launches - b for fn, b in zip(counted, before)] == [0, 0, int(recipe == "mosaic")]
    diff = (got.images.cpu() - want.images).abs()
    assert float(diff.max()) <= 1.0 / 255 + 1e-6
    assert float((diff > 1e-6).float().mean()) < 0.001
    torch.testing.assert_close(got.boxes.cpu(), want.boxes, rtol=0, atol=1e-4)
    assert torch.equal(got.labels.cpu(), want.labels) and torch.equal(got.mask.cpu(), want.mask)
    assert int(govf) == int(wovf)


def test_host_fed_pinned_groups_survive_a_slow_consumer(dev):
    """prefetch=1, the card kept busy before each copy and the host slow after
    it: the producer loads the next groups into pinned memory while earlier
    copies may still be queued. Every group reaches the card as the CPU
    loads it."""
    import time

    from object_detection_cib_torch.data.host_augment import AugParams
    from object_detection_cib_torch.data.synthetic import build_fake_manifest
    from object_detection_cib_torch.data.device_pipeline import DeviceDataPipeline

    info = build_fake_manifest(num_classes=3, num_images=48, image_size=96, seed=3)  # 12 steps
    mk = lambda d: DeviceDataPipeline(info, 96, 4, AugParams(), mixup_prob=0.5, seed=1, device=d,
                                      device_cache=False, prefetch=1)
    cpu, card = mk("cpu"), mk(dev)
    groups, secs = card._epoch_plan()
    plan = torch.from_numpy(groups.astype(np.int32)).to(dev)
    plan2 = torch.from_numpy(secs.astype(np.int32)).to(dev)
    got = []
    for prim, sec in card._host_fed(groups, secs, plan, plan2):
        torch.cuda._sleep(20_000_000)  # the next group's copy waits behind this
        got.append((prim, sec))
        time.sleep(0.02)
    torch.cuda.synchronize()
    assert len(got) == len(groups) == 12
    for i, (prim, sec) in enumerate(got):
        for sample, rows in ((prim, groups[i]), (sec, secs[i])):
            want = cpu.upload(cpu._load_group(rows), torch.from_numpy(rows))
            assert sample.images.is_cuda
            for x, y in zip(sample, want):
                assert torch.equal(x.cpu(), y)


def test_prefetcher_batches_on_card_equal_cpu(dev):
    """The host pipeline's batches copied up (pinned, non-blocking) and
    normalized on the card equal the CPU's, bit for bit, with a slow consumer
    and prefetch=1."""
    import time

    from object_detection_cib_torch.data.host_augment import AugParams, TrainSampleAugmentor
    from object_detection_cib_torch.data.pipeline import DetectionDataset, Prefetcher
    from object_detection_cib_torch.data.reader import SampleReader
    from object_detection_cib_torch.data.samplers import ShuffleSampler
    from object_detection_cib_torch.data.synthetic import build_fake_manifest

    info = build_fake_manifest(num_classes=3, num_images=24, image_size=96, seed=4)

    def batches(d):
        ds = DetectionDataset(info, SampleReader(64, info.classes, fake_mode=True),
                              TrainSampleAugmentor(AugParams()), use_mosaic=True,
                              mosaic_target_size=64, mixup_prob=0.5, seed=0)
        pf = Prefetcher(ds, 4, 30, sampler=ShuffleSampler(info, seed=0), num_threads=1, prefetch=1,
                        device=d)
        out = []
        for b in pf:
            if d != "cpu":
                torch.cuda._sleep(20_000_000)
                time.sleep(0.02)
            out.append(b)
        return out, pf.overflow_total

    (want, wo), (got, go) = batches("cpu"), batches(dev)
    torch.cuda.synchronize()
    assert len(got) == len(want) == 6 and go == wo
    for a, b in zip(got, want):
        assert a.images.is_cuda and a.images.dtype == torch.float32
        for x, y in zip(a, b):
            assert torch.equal(x.cpu(), y)


def test_to_unit_on_card_is_the_cpu_division(dev):
    """Every uint8 value, and bf16 integers, scaled on the card exactly as on
    the CPU (a true f32 division, not a multiply by 1/255)."""
    from object_detection_cib_torch.utils.device import to_unit

    x = torch.arange(256, dtype=torch.uint8)
    for src in (x, x.to(torch.bfloat16), x.float()):
        assert torch.equal(to_unit(src.to(dev)).cpu(), to_unit(src))
    assert torch.equal(to_unit(x), torch.from_numpy(np.arange(256, dtype=np.float32) / np.float32(255.0)))


def test_checkpoint_snapshot_survives_in_place_updates_on_card(dev, tmp_path):
    """The optimizer's next steps run on the card while the writer copies the
    snapshot: the file holds the state at the save, bit for bit."""
    from object_detection_cib_torch.models.yolov5 import build_network
    from object_detection_cib_torch.train.checkpoint import CheckpointManager, Snapshot, load_state
    from object_detection_cib_torch.train.optim import OptimizerConfig, SmartSGD

    net = build_network(3, "s", device=dev, seed=0)
    opt = SmartSGD(net, OptimizerConfig(max_epochs=10), 10)
    for b in opt.buffers.values():
        b.normal_()
    opt.step_count = 5
    want = {k: v.cpu().clone() for k, v in net.state_dict().items()}
    want_mom = {k: v.cpu().clone() for k, v in opt.buffers.items()}
    cm = CheckpointManager(tmp_path / "ck")
    cm.save_last(Snapshot(net, opt))
    with torch.no_grad():  # in place, enqueued right behind the snapshot's clones
        for _ in range(20):
            for p in net.parameters():
                p.mul_(0.5).add_(1.0)
            for b in opt.buffers.values():
                b.sub_(1.0)
    cm.wait_until_finished()
    state = load_state(tmp_path / "ck" / "last")
    assert all(torch.equal(state["net"][k], v) for k, v in want.items())
    assert all(torch.equal(state["optimizer"]["momentum"][k], v) for k, v in want_mom.items())
    assert state["optimizer"]["step_count"] == 5


def test_cli_fast_dev_run_on_card(dev, tmp_path):
    """``cli.train`` with ``trainer.platform`` null runs on the card: the
    device pipeline launches the training kernels, validation launches K1."""
    from object_detection_cib_torch.cli.train import main
    from object_detection_cib_torch.train.checkpoint import load_state

    counted = (gather_ops.gather_rows_planar, hsv_ops.hsv_planar, warp_ops.warp_quadrants,
               nms_ops.greedy_nms_mask)
    for fn in counted:
        fn.launches = 0
    metrics = main(["experiment=yv5n", "dataset_name=fake", "data.batch_size=8", "data.target_image_size=64",
                    "data.fake_num_images=32", "data.pipeline=device", "data.device_cache=True",
                    "trainer.fast_dev_run=True", "logger=csv", "callbacks.model_summary=null",
                    "extras.print_config=False", f"paths.output_dir={tmp_path}"])
    assert [fn.launches for fn in counted] == [1, 1, 1, 1]
    assert 0.0 <= metrics["map"] <= 1.0
    assert load_state(tmp_path / "checkpoints" / "last")["optimizer"]["step_count"] == 1


# ------------------------------------------------------------ the fused epoch

@pytest.fixture
def deterministic():
    """cuDNN's deterministic algorithms, so that two eager runs of the same
    steps can be bitwise equal; restored after the test."""
    was = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was


def _fused_pipe(dev, mode="mosaic", n=48, seed=3, **extra):
    from object_detection_cib_torch.data.device_pipeline import DeviceDataPipeline
    from object_detection_cib_torch.data.host_augment import AugParams
    from object_detection_cib_torch.data.synthetic import build_fake_manifest

    info = build_fake_manifest(num_images=n, num_classes=3, image_size=64, seed=2)
    kw = {"mosaic": {}, "mixup": dict(mixup_prob=0.5), "no_mosaic": dict(use_mosaic=False)}[mode]
    return DeviceDataPipeline(info, 64, 4, AugParams(), max_targets=6, seed=seed, device=dev, **kw, **extra)


def _checksum(batch, *rows):
    return (batch.images.float().sum(), (batch.boxes * batch.mask[..., None]).sum(),
            batch.labels.sum().float())


TRAINING_KERNELS = (gather_ops.gather_rows_planar, hsv_ops.hsv_planar, warp_ops.warp_quadrants)


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("mode", ["mosaic", "mixup"])
def test_graphed_fused_epoch_equals_eager_on_card(dev, mode, pipelined):
    """Two epochs of 12 steps: the captured graph's batches (a checksum
    step) and overflow counts bitwise the eager fused epoch's, the
    generator's draws included; K2/K4/K5 counted once per step (twice under
    mixup) by replay."""
    eager, graphed = _fused_pipe(dev, mode), _fused_pipe(dev, mode)
    f_eager = eager.build_fused_epoch_fn(_checksum, pipelined=pipelined, stack_metrics=True, graph=False)
    f_graph = graphed.build_fused_epoch_fn(_checksum, pipelined=pipelined, stack_metrics=True)
    assert f_graph.graph and not f_eager.graph
    for epoch in range(2):
        want = f_eager(eager.epoch_host_arrays())
        before = [fn.launches for fn in TRAINING_KERNELS]
        got = f_graph(graphed.epoch_host_arrays())
        torch.cuda.synchronize()
        per_step = 2 if mode == "mixup" else 1
        assert [fn.launches - b for fn, b in zip(TRAINING_KERNELS, before)] == [12 * per_step] * 3
        assert torch.equal(got, want), (epoch, (got - want).abs().max())
        assert got[-1].sum() > 0  # max_targets 6: the overflow row is live
    assert set(f_graph.graphs) == ({"body", "last"} if pipelined else {"body"})
    assert torch.equal(graphed.gen.get_state(), eager.gen.get_state())


@pytest.mark.parametrize("mode", ["mosaic", "mixup", "no_mosaic"])
def test_flat_corpus_launches_k3_on_card(dev, mode):
    """The corpus held as NHWC rows (``corpus_layout="flat"``): a graphed
    fused epoch of 12 steps bitwise the planar corpus's, K3 counted once a
    step (twice under mixup) by replay and K2 never; then three steps of
    the step loop, bitwise too, K3 counted by launch."""
    planar, flat = _fused_pipe(dev, mode), _fused_pipe(dev, mode, corpus_layout="flat")
    assert tuple(flat.corpus.shape) == (48, 64, 64, 3)
    want = planar.build_fused_epoch_fn(_checksum, stack_metrics=True)(planar.epoch_host_arrays())
    fn = flat.build_fused_epoch_fn(_checksum, stack_metrics=True)
    gathers = (gather_ops.gather_rows_planar, gather_ops.gather_rows_flat)
    before = [g.launches for g in gathers]
    got = fn(flat.epoch_host_arrays())
    torch.cuda.synchronize()
    per_step = 2 if mode == "mixup" else 1
    assert fn.graph and [g.launches - b for g, b in zip(gathers, before)] == [0, 12 * per_step]
    assert torch.equal(got, want), (got - want).abs().max()
    before = gather_ops.gather_rows_flat.launches
    for (a, _), (b, _) in zip(flat.epoch(max_steps=3), planar.epoch(max_steps=3), strict=True):
        for name in ("images", "boxes", "labels", "mask"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert gather_ops.gather_rows_flat.launches - before == 3 * per_step


def _tiny_trainer(dev, tmp=None, **kw):
    from object_detection_cib_torch.data.synthetic import build_fake_manifest
    from object_detection_cib_torch.train.trainer import Trainer

    info = build_fake_manifest(num_images=40, num_classes=3, image_size=64, seed=2)
    val = build_fake_manifest(num_images=16, num_classes=3, image_size=64, seed=9)
    t = Trainer(info, val, size="n", image_size=64, batch_size=8, max_targets=20, seed=0,
                dtype=torch.bfloat16, device=dev, **kw)
    if tmp is not None:
        from object_detection_cib_torch.train.checkpoint import CheckpointManager

        t.ckpt = CheckpointManager(tmp / "ck")
    return t


def _state(t):
    return [v.detach().clone() for v in list(t.net.state_dict().values()) + list(t.optimizer.buffers.values())]


def _max_diff(a, b):
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


def test_graphed_train_steps_equal_eager_on_card(dev, deterministic):
    """Five bf16 yolov5n steps (two eager warm-up steps, then replays): the
    parameters, statistics and momentum after them bitwise the eager fused
    epoch's where two eager runs are bitwise; otherwise within 4x the
    run-to-run spread measured here (printed)."""
    def run(graph):
        t = _tiny_trainer(dev)
        fn = t.pipeline.build_fused_epoch_fn(lambda b, hp: t.train_step(b, hp), pipelined=True,
                                             stack_metrics=True, graph=graph)
        flat = fn(t.pipeline.epoch_host_arrays(), t.optimizer.hyper_table(0, 5))
        torch.cuda.synchronize()
        return _state(t), flat

    (e1, m1), (e2, m2), (g, mg) = run(False), run(False), run(True)
    spread, err = _max_diff(e1, e2), _max_diff(g, e1)
    print(f"eager vs eager {spread}, graph vs eager {err}; losses {mg[0].tolist()} vs {m1[0].tolist()}")
    if spread == 0:
        assert err == 0 and torch.equal(mg, m1)
    else:
        assert err <= 4 * spread


def test_fused_fit_counts_launches_by_replay_on_card(dev):
    """fit over two epochs of 5 steps on the fused path: K2/K4/K5 10 each,
    counted by replay (2 steps ran eagerly as warm-up), K1 once per
    validation batch; losses and mAP finite, parameters moved."""
    t = _tiny_trainer(dev, max_epochs=2)
    before = _state(t)
    counted = TRAINING_KERNELS + (nms_ops.greedy_nms_mask,)
    for fn in counted:
        fn.launches = 0
    m = t.fit()
    assert t._fused_fn is not None and t._fused_fn.graph
    assert [fn.launches for fn in counted] == [10, 10, 10, 2 * 2]  # 16 val images, B = 8, every epoch
    replays = {k: g.replays for k, g in t._fused_fn.graphs.items()}
    assert replays == {"body": 4 + 2, "last": 2}  # epoch 1: 2 warm-up + 2 replays + last; epoch 2: 4 + last
    assert all(np.isfinite(em["total"]).all() for em in t.epoch_metrics) and np.isfinite(m["map"])
    assert _max_diff(before, _state(t)) > 0 and t.optimizer.step_count == 10
    assert set(t.device_epoch_walls()) == {1} and t.device_epoch_walls()[1] > 0


def test_stage_stamps_advance_once_per_replay_on_card(dev):
    """Two graphed pipelined epochs of 5 steps (the first: 2 eager warm-up
    steps, 2 replays of the body and the last step's graph; the second: 4
    and 1): every stage stamps every step's column, in stage order; each
    replay stamps its own column, so the optimizer's stamps advance column
    by column; the second epoch stamps anew, after the first."""
    from object_detection_cib_torch.utils import tracing

    t = _tiny_trainer(dev)
    fn = t.pipeline.build_fused_epoch_fn(lambda b, hp: t.train_step(b, hp), pipelined=True, stack_metrics=True)
    epochs = []
    for e in range(2):
        xs = t.pipeline.epoch_host_arrays()
        n = int(xs[0].shape[0])
        fn(xs, t.optimizer.hyper_table(e * n, n))
        epochs.append(fn.stamps.cpu().numpy())
    assert fn.graph and {k: g.replays for k, g in fn.graphs.items()} == {"body": 2 + 4, "last": 2}
    order = ("forward_begin", "forward_end", "loss_end", "backward_end", "optimizer_end")
    for s in epochs:
        r = {m: s[i] for i, m in enumerate(tracing.MARKS)}
        assert s.shape == (len(tracing.MARKS), n) and not r["allreduce_end"].any()
        assert all((r[m] > 0).all() for m in tracing.MARKS if m != "allreduce_end")
        assert all((r[a] <= r[b]).all() for a, b in zip(order, order[1:]))
        assert (r["augment_begin"] <= r["augment_end"]).all() and (np.diff(r["optimizer_end"]) > 0).all()
        assert set(tracing.stage_ms(s)) == {"augment", "forward", "loss", "backward", "optimizer"}
    assert epochs[1][epochs[1] > 0].min() > epochs[0].max()


def test_dispatch_ahead_changes_no_bit_on_card(dev, deterministic):
    """Three epochs validated once at the end: epochs 2 and 3 are enqueued
    before the fetch of the epoch before them, or not; the parameters come
    out bitwise equal."""
    states = []
    for ahead in (True, False):
        t = _tiny_trainer(dev, max_epochs=3, fused_dispatch_ahead=ahead)
        t.loop = t.loop._replace(check_val_every_n_epoch=3)
        t.fit()
        states.append(_state(t))
    assert _max_diff(*states) == 0


def test_capture_failure_raises_on_card(dev):
    """A host sync inside the step (``.item()``) fails the capture: the
    fused epoch raises, naming the step, and runs nothing eagerly in its
    place; the card still works after."""
    pipe = _fused_pipe(dev)
    seen = []

    def syncing(batch, *rows):
        seen.append(float(batch.images.float().sum().item()))
        return batch.labels.sum().float()

    fn = pipe.build_fused_epoch_fn(syncing, stack_metrics=True)
    with pytest.raises(RuntimeError, match="capturing a fused-epoch step"):
        fn(pipe.epoch_host_arrays())
    assert len(seen) == fn.WARMUP_STEPS  # the warm-up steps ran; the captured one stopped at .item()
    assert fn.graphs == {}
    assert float(torch.ones(4, device=dev).sum()) == 4.0


def test_boundary_snapshot_holds_the_epoch_state_on_card(dev, tmp_path, deterministic):
    """With the next epoch already enqueued, the boundary checkpoint holds
    epoch 1's state: bitwise a one-epoch run's, and not the end state."""
    t = _tiny_trainer(dev, tmp_path, max_epochs=2)
    t.loop = t.loop._replace(check_val_every_n_epoch=2)
    saved = []
    real = t.ckpt.save_last
    t.ckpt.save_last = lambda snap: (saved.append(snap.to_host()), real(snap))[1]
    t.fit()
    ref = _tiny_trainer(dev, max_epochs=2)
    ref.fit(max_epochs=1)
    first = saved[0]
    assert first["optimizer"]["step_count"] == 5
    ref_state = ref.net.state_dict()
    assert all(torch.equal(v, ref_state[k].cpu()) for k, v in first["net"].items())
    end = t.net.state_dict()
    assert not all(torch.equal(v, end[k].cpu()) for k, v in first["net"].items())


def test_capture_runs_without_the_garbage_collector_on_card(dev):
    """A capture holds Python's cyclic collector off and turns it back on."""
    import gc

    from object_detection_cib_torch.ops.graph import CapturedGraph

    x = torch.ones(4, device=dev)
    seen = []

    def step():
        seen.append(gc.isenabled())
        x.mul_(2.0)

    g = CapturedGraph(step, torch.cuda.Stream(), "a probe")
    g.replay()
    torch.cuda.synchronize()
    assert seen == [False] and gc.isenabled() and float(x[0]) == 2.0


def test_capture_after_a_dead_trainer_on_card(dev):
    """A trainer dropped while the collector waits leaves its graphs in
    reference cycles; a collection inside the next trainer's capture would
    free them there, and the capture would fail. The capture collects
    first, so its step finds nothing left to free when it collects inside
    the capture (as an automatic collection might) and the capture holds."""
    import gc

    dead = _tiny_trainer(dev)
    dead.fit(max_epochs=1)
    assert dead._fused_fn.graph
    gc.disable()
    try:
        del dead
        t = _tiny_trainer(dev)
        real, collected = t.train_step, []

        def step(batch, hp=None):
            if torch.cuda.is_current_stream_capturing():
                collected.append(gc.collect())
            return real(batch, hp)

        t.train_step = step
        t.fit(max_epochs=1)
    finally:
        gc.enable()
    assert t._fused_fn.graph and collected and not any(collected)


def test_state_carried_across_the_jax_layout_resumes_bitwise_on_card(dev, tmp_path, deterministic):
    """One fused epoch saves the port's own ``last``; that state through the
    JAX layout and back (``torch_to_flax_state``, ``flax_state_to_torch``)
    resumes the second epoch bitwise the own checkpoint, in fresh trainers
    and in one whose graph was captured before the restore (its state
    scrambled first: the restore must copy into the tensors the graph
    reads), against the first trainer going on without a restore."""
    from object_detection_cib_torch.models.convert import flax_state_to_torch, torch_to_flax_state
    from object_detection_cib_torch.train.checkpoint import load_state, save_state

    def tiny(tmp=None):
        t = _tiny_trainer(dev, tmp, max_epochs=2)
        t.loop = t.loop._replace(check_val_every_n_epoch=2)
        return t

    first = tiny(tmp_path)
    first.fit(max_epochs=1)
    own, converted = tmp_path / "ck" / "last", tmp_path / "converted"
    save_state(converted, flax_state_to_torch(torch_to_flax_state(load_state(own), len(first.classes))))
    runs = {}
    for name, path in (("own", own), ("converted", converted)):
        t = tiny()
        t.restore(path)
        assert (t.epoch, t.optimizer.step_count) == (1, 5)
        t.fit(max_epochs=2)
        runs[name] = _state(t)
    captured = tiny()
    captured.fit(max_epochs=1)
    assert captured._fused_fn.graph
    with torch.no_grad():
        for x in list(captured.net.parameters()) + list(captured.net.buffers()):
            x.mul_(0.5)
        for b in captured.optimizer.buffers.values():
            b.zero_()
    captured.optimizer.step_count = 0
    captured.restore(converted)
    assert (captured.epoch, captured.optimizer.step_count) == (1, 5)
    counted = TRAINING_KERNELS + (nms_ops.greedy_nms_mask,)
    for fn in counted:
        fn.launches = 0
    captured.fit(max_epochs=2)
    assert [fn.launches for fn in counted] == [5, 5, 5, 2]  # replays of the graph captured before the restore
    first.fit(max_epochs=2)
    assert _max_diff(runs["own"], runs["converted"]) == 0
    assert _max_diff(_state(captured), _state(first)) == 0


# ------------------------------------------------- training BatchNorm + SiLU

# (side, C): every training BatchNorm's (M = 64 side^2 rows, C) of yolov5s at
# 416 px, B = 64, and yolov5l's 1024-channel layer
BN_LAYERS = [(side, C) for side, C, _ in bn_cases.LAYERS["s"]] + [(13, 1024)]
_bn_inputs = bn_cases.layer_inputs


def _bn_against_plain(x, dy, w, b, rm, rv):
    """The kernels against ``bn_silu_train_plain`` / ``bn_silu_grad_plain``
    within ``test_utils/bn_silu.py``'s limits; both outputs channels_last."""
    gaps = bn_cases.against_plain(x, dy, w, b, rm, rv)
    print({k: f"{v:.3g}" for k, v in gaps.items()})
    assert not bn_cases.exceeded(gaps), gaps
    y, stats = bn_ops._forward_kernels(x, w, b, rm.clone(), rv.clone(), 0.03, 1e-3)
    dx = bn_ops._backward_kernels(x, dy, w, b, stats)[0]
    assert y.is_contiguous(memory_format=torch.channels_last) and dx.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("side,C", BN_LAYERS)
def test_bn_silu_kernels_equal_plain_at_the_layer_shapes(dev, side, C):
    x, dy, w, b, rm, rv = _bn_inputs(dev, 64, C, side, side, seed=side * 7 + C)
    _bn_against_plain(x, dy, w, b, rm, rv)


@pytest.mark.parametrize("N,C,H,W", [(1, 8, 1, 1), (1, 24, 1, 7), (3, 96, 5, 7), (2, 4096, 3, 3),
                                     (5, 2048, 2, 3), (7, 40, 33, 31)])
def test_bn_silu_kernels_equal_plain_at_other_shapes(dev, N, C, H, W):
    """Widths whose 8-channel vectors do not divide a block's 256 threads
    (24, 40, 96), two blocks across a row (4096), a row of one block (2048),
    and few or ragged rows."""
    x, dy, w, b, rm, rv = _bn_inputs(dev, N, C, H, W, seed=C + H)
    _bn_against_plain(x, dy, w, b, rm, rv)


def test_bn_silu_backward_reads_a_channel_slice_of_a_concat(dev):
    """dy as a channel slice of a channels_last concat's gradient (rows of
    96 elements, 32 of them read) gives the dx of the same dy made
    contiguous, bitwise."""
    x, _, w, b, rm, rv = _bn_inputs(dev, 4, 32, 9, 11, seed=5)
    wide = _bn_inputs(dev, 4, 96, 9, 11, seed=6)[1]
    dy = wide[:, 32:64]
    assert bn_ops._row_stride(dy) == 96
    _, stats = bn_ops._forward_kernels(x, w, b, rm, rv, 0.03, 1e-3)
    got = bn_ops._backward_kernels(x, dy, w, b, stats)
    want = bn_ops._backward_kernels(x, dy.contiguous(memory_format=torch.channels_last), w, b, stats)
    for g, v in zip(got, want):
        assert torch.equal(g, v)


@pytest.mark.parametrize("side,C", [(208, 32), (13, 1024)])
def test_bn_silu_kernels_give_the_same_bits_twice(dev, side, C):
    x, dy, w, b, rm, rv = _bn_inputs(dev, 64, C, side, side, seed=1)
    runs = []
    for _ in range(2):
        rk, vk = rm.clone(), rv.clone()
        y, stats = bn_ops._forward_kernels(x, w, b, rk, vk, 0.03, 1e-3)
        runs.append((y, stats, rk, vk) + bn_ops._backward_kernels(x, dy, w, b, stats))
    for a, c in zip(*runs):
        assert torch.equal(a, c)


def test_bn_silu_variance_comes_from_deviations_at_a_large_mean(dev):
    """x = 1000 + noise (std 8 to 48 by channel) in bf16 over the stem's
    2.77 M rows: the kernel's statistics within 1e-5 of the f64 ones of the
    same values (E[x^2] - E[x]^2 in f32 would miss by far more)."""
    g = torch.Generator(device=dev).manual_seed(3)
    sd = torch.linspace(8.0, 48.0, 32, device=dev)
    x = (1000.0 + torch.randn(64, 208, 208, 32, generator=g, device=dev) * sd).to(torch.bfloat16).permute(0, 3, 1, 2)
    ones = torch.ones(32, device=dev)
    _, stats = bn_ops._forward_kernels(x, ones, ones, ones.clone(), ones.clone(), 0.03, 1e-3)
    v64 = x.double().var(dim=(0, 2, 3), unbiased=False)
    m64 = x.double().mean((0, 2, 3))
    assert float(((stats[1].double() - v64).abs() / v64).max()) < 1e-5
    assert float(((stats[0].double() - m64).abs() / v64.sqrt()).max()) < 1e-5


@pytest.mark.parametrize("case", ["channels_8x_not", "nchw", "bf16_parameters"])
def test_conv_bn_act_raises_where_the_kernels_cannot_read_its_output_on_card(dev, case):
    """A bf16 training forward with grad on the card takes the op whatever
    the conv output: where the kernels cannot read it (C % 8 != 0, an NCHW
    output, bf16 BatchNorm parameters) the op raises and nothing launches;
    no case falls back to the plain layers."""
    torch.manual_seed(0)
    m = layers.ConvBnAct(8, 12 if case == "channels_8x_not" else 16, 3).to(dev)
    x = torch.randn(2, 8, 6, 6, device=dev).to(torch.bfloat16)
    if case != "nchw":
        m, x = m.to(memory_format=torch.channels_last), x.contiguous(memory_format=torch.channels_last)
    if case == "bf16_parameters":
        m.bn.to(torch.bfloat16)
    m.train()
    before = bn_ops.bn_silu_train.launches
    with pytest.raises(ValueError, match="bn_silu_train"):
        m(x)
    assert bn_ops.bn_silu_train.launches == before


def test_bn_silu_counts_each_layer_once_a_step_by_replay_on_card(dev, deterministic):
    """Five bf16 yolov5n steps on the fused path (every training BatchNorm
    takes the op): the op's launches are the layers times the steps, eager
    or graphed (two eager warm-up steps, then replays); the graphed state
    bitwise the eager one's where two eager runs are bitwise."""
    counts = []

    def run(graph):
        t = _tiny_trainer(dev)
        bns = sum(isinstance(m, layers.ConvBnAct) for m in t.net.modules())
        fn = t.pipeline.build_fused_epoch_fn(lambda b, hp: t.train_step(b, hp), pipelined=True,
                                             stack_metrics=True, graph=graph)
        before = bn_ops.bn_silu_train.launches
        fn(t.pipeline.epoch_host_arrays(), t.optimizer.hyper_table(0, 5))
        torch.cuda.synchronize()
        counts.append((bn_ops.bn_silu_train.launches - before, 5 * bns, bool(fn.graph)))
        return _state(t)

    e1, e2, g = run(False), run(False), run(True)
    assert all(got == want for got, want, _ in counts) and counts[0][1] == 5 * 57, counts
    assert [graphed for *_, graphed in counts] == [False, False, True]
    spread, err = _max_diff(e1, e2), _max_diff(g, e1)
    print(f"eager vs eager {spread}, graph vs eager {err}")
    if spread == 0:
        assert err == 0
    else:
        assert err <= 4 * spread


# ------------------------------------------------- several cards: data parallelism

@pytest.fixture
def two_cards(dev):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs 2 cards, {n} visible")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_kernels_launch_on_their_tensors_card_from_a_fresh_thread(two_cards):
    """K1, K2, K4 and K5 called from a new thread, whose current device is
    card 0, on tensors on card 1: each launches there (on card 1's stream)
    and equals its plain version bitwise."""
    import threading

    d1 = two_cards[1]
    torch.cuda.set_device(0)
    out, errors = {}, []

    def work():
        try:
            out["current"] = torch.cuda.current_device()
            boxes, live = _boxes(2, 300, 250, seed=5)
            b, l = boxes.to(d1), live.to(d1)
            out["nms"] = nms_ops.greedy_nms_mask(b, l, 0.5), nms_ops.greedy_nms_mask_plain(b, l, 0.5)
            g = torch.Generator().manual_seed(1)
            src = torch.randint(0, 256, (20, 3, 64, 64), dtype=torch.uint8, generator=g).to(d1)
            idx = torch.tensor([3, 0, 19, 7], dtype=torch.int32, device=d1)
            out["gather"] = gather_ops.gather_rows_planar(src, idx), gather_ops.gather_rows_plain(src, idx)
            x = _hsv_input("integral").to(torch.bfloat16).to(d1)
            r = torch.tensor(_HSV_GAINS, device=d1)
            out["hsv"] = hsv_ops.hsv_planar(x, r), hsv_ops.hsv_planar_plain(x, r)
            imgs, taps = _random_taps(2, 64, 64, seed=3)
            args = [imgs.to(d1)] + [t.to(d1) for t in taps]
            out["warp"] = (warp_ops.warp_quadrants(*args, out_dtype=torch.bfloat16),
                           warp_ops.warp_quadrants_plain(*args, out_dtype=torch.bfloat16))
            torch.cuda.synchronize(d1)
        except Exception as e:  # handed to the test's thread
            errors.append(e)

    th = threading.Thread(target=work)
    th.start()
    th.join(timeout=300)
    assert not th.is_alive() and not errors, errors
    assert out["current"] == 0
    for name in ("nms", "gather", "hsv", "warp"):
        got, want = out[name]
        assert got.device == d1 and torch.equal(got, want), name


def _nccl_steps(mesh, steps):
    """On this rank's card: ``steps`` f32 yolov5n steps at 64 px, global
    B = 8 with mixup, through the step loop and the fused epoch (a CUDA
    graph holding the NCCL collectives after 2 eager steps), over the
    replicated and the sharded corpus: the state after each."""
    from object_detection_cib_torch.core.types import FeatureShape, default_anchors
    from object_detection_cib_torch.data.device_pipeline import DeviceDataPipeline
    from object_detection_cib_torch.data.host_augment import AugParams
    from object_detection_cib_torch.data.synthetic import build_fake_manifest
    from object_detection_cib_torch.models.yolov5 import build_network
    from object_detection_cib_torch.train.optim import OptimizerConfig, SmartSGD
    from object_detection_cib_torch.train.steps import make_train_step

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0) if mesh is None else mesh.device
    info = build_fake_manifest(num_images=48, num_classes=3, image_size=64, seed=2)
    out = {}
    for sharding in ("replicated", "sharded") if mesh is not None else ("replicated",):
        for loop in ("steps", "fused"):
            pipe = DeviceDataPipeline(info, 64, 8, AugParams(), max_targets=20, seed=3, device=dev,
                                      feed_dtype=torch.float32, mesh=mesh, corpus_sharding=sharding, mixup_prob=0.5)
            net = build_network(3, "n", device=dev, seed=0)
            opt = SmartSGD(net, OptimizerConfig(), 6)
            step = make_train_step(net, default_anchors(), FeatureShape(64, 64), opt, mesh=mesh)
            if loop == "steps":
                for batch, _ in pipe.epoch(steps):
                    step(batch, opt.hyper_table(opt.step_count, 1, dev)[0])
            else:
                fn = pipe.build_fused_epoch_fn(lambda b, hp: step(b, hp), stack_metrics=True)
                fn(pipe.epoch_host_arrays(steps), opt.hyper_table(0, steps))
                assert fn.graphs, "the fused epoch ran without a graph"
            torch.cuda.synchronize(dev)
            out[(sharding, loop)] = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}
    return out


def test_nccl_ranks_on_two_cards_equal_one_card(two_cards):
    """Two NCCL ranks on cards 0 and 1, four steps each way: the graphed
    fused epoch (its collectives captured) bitwise the step loop on each
    rank, the sharded corpus bitwise the replicated one, both ranks
    bitwise alike, and the state within f32 parity tolerance (atol 1e-5 +
    rtol 1e-4) of one process stepping the whole global batch on card 0."""
    from object_detection_cib_torch.parallel.distributed import launch

    ranks = launch(_nccl_steps, 2, (4,), device_type="cuda", timeout_s=300, join_timeout_s=900)
    one = _nccl_steps(None, 4)[("replicated", "steps")]
    for res in ranks:
        ref = res[("replicated", "steps")]
        for key, state in res.items():
            assert all(np.array_equal(state[k], ref[k]) for k in ref), key
        for k, v in one.items():
            np.testing.assert_allclose(ref[k], v, atol=1e-5, rtol=1e-4, err_msg=k)
    assert all(np.array_equal(ranks[0][("replicated", "steps")][k], ranks[1][("replicated", "steps")][k])
               for k in one)
