"""Port parity: core types, box conversions and the IoU family vs the JAX package.

Same numpy inputs (seeded) through both; f32 on the CPU. Tolerance atol 1e-6:
the formulas are op-for-op the same, so the only differences are the last
bits of the transcendental (arctan) and division kernels of the two
libraries, far below 1e-6 for boxes of tens to hundreds of pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_cib_torch.core import boxes as tboxes
from object_detection_cib_torch.core import iou as tiou
from object_detection_cib_torch.core import types as ttypes
from object_detection_cib_tpu.core import boxes as jboxes
from object_detection_cib_tpu.core import iou as jiou
from object_detection_cib_tpu.core import types as jtypes

ATOL = 1e-6


def _rand_boxes(rng, shape):
    xy = rng.uniform(0, 200, shape + (2,)).astype(np.float32)
    wh = rng.uniform(1, 80, shape + (2,)).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1)


def test_types_match():
    ja, ta = jtypes.default_anchors(), ttypes.default_anchors()
    assert ta.strides == ja.strides
    for jl, tl in zip(ja.levels(), ta.levels()):
        np.testing.assert_array_equal(tl.as_array(), jl.as_array())
        assert tl.as_array().dtype == np.float32
    assert ttypes.FeatureShape(3, 4) == jtypes.FeatureShape(3, 4)


@pytest.mark.parametrize("fn", ["cxcywh_to_xyxy", "xyxy_to_cxcywh", "box_area"])
def test_box_conversions(fn):
    b = _rand_boxes(np.random.default_rng(0), (3, 7))
    want = np.asarray(getattr(jboxes, fn)(jnp.asarray(b)))
    got = getattr(tboxes, fn)(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_scale_boxes():
    b = _rand_boxes(np.random.default_rng(1), (5,))
    want = np.asarray(jboxes.scale_boxes(jnp.asarray(b), 0.5, 2.0))
    got = tboxes.scale_boxes(torch.from_numpy(b), 0.5, 2.0).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
def test_aligned_iou_family(kind):
    rng = np.random.default_rng(2)
    b1 = _rand_boxes(rng, (4, 33))
    b2 = b1.copy()
    b2[..., :2] += rng.uniform(-30, 30, (4, 33, 2)).astype(np.float32)
    b2[..., 2:] += rng.uniform(-30, 30, (4, 33, 2)).astype(np.float32)
    b2[..., 2:] = np.maximum(b2[..., 2:], b2[..., :2] + 1)
    want = np.asarray(jiou.get_iou_fn(kind)(jnp.asarray(b1), jnp.asarray(b2)))
    got = tiou.get_iou_fn(kind)(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_ciou_alpha_detached():
    """CIoU's gradient equals JAX's, whose alpha sits under stop_gradient.

    atol 1e-5: gradients of O(0.01-1) through arctan and two divisions.
    """
    import jax

    rng = np.random.default_rng(3)
    b1, b2 = _rand_boxes(rng, (6,)), _rand_boxes(rng, (6,))
    want = np.asarray(
        jax.grad(lambda x: jiou.compute_ciou(x, jnp.asarray(b2)).sum())(jnp.asarray(b1))
    )
    t1 = torch.from_numpy(b1).requires_grad_()
    tiou.compute_ciou(t1, torch.from_numpy(b2)).sum().backward()
    np.testing.assert_allclose(t1.grad.numpy(), want, atol=1e-5, rtol=0)


def test_pairwise_iou():
    rng = np.random.default_rng(4)
    a = _rand_boxes(rng, (2, 40))
    b = _rand_boxes(rng, (2, 25))
    want = np.asarray(jiou.compute_iou_pairwise(jnp.asarray(a), jnp.asarray(b)))
    got = tiou.compute_iou_pairwise(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (2, 40, 25)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
