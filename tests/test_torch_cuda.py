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

from object_detection_cib_torch.ops import augment as aug_ops
from object_detection_cib_torch.ops import gather as gather_ops
from object_detection_cib_torch.ops import hsv as hsv_ops
from object_detection_cib_torch.ops import nms as nms_ops
from object_detection_cib_torch.ops import warp as warp_ops
from object_detection_cib_torch.ops.build import build_all

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
     (2, 1000, 700, 0.3), (1, nms_ops.MAX_K, 5000, 0.6), (32, 2048, 1500, 0.6)],
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


# ------------------------------------------------------------------ K4 HSV

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("integral", [True, False])
def test_hsv_equals_plain(dev, dtype, integral):
    g = torch.Generator().manual_seed(2)
    if integral:
        x = torch.randint(0, 256, (4, 3, 32, 416), generator=g).float()
    else:
        x = torch.rand(4, 3, 32, 416, generator=g) * 255.0
    x = x.to(dtype)
    r = torch.tensor([[0.985, 0.3, 0.6], [1.015, 1.7, 1.4], [1.0, 1.0, 1.0], [0.99, 1.69, 0.61]])
    before = hsv_ops.hsv_planar.launches
    got = hsv_ops.hsv_planar(x.to(dev), r.to(dev))
    torch.cuda.synchronize()
    assert hsv_ops.hsv_planar.launches == before + 1
    want = hsv_ops.hsv_planar_plain(x.to(dev), r.to(dev))
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
