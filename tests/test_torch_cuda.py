"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (from a fixture) where there is no card.
This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which imports JAX.)
"""

import pytest
import torch

from object_detection_cib_torch.ops import nms as nms_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    nms_ops.build()
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
