"""Port parity: the greedy-NMS keep mask and ``non_max_suppression`` vs JAX.

The mask is compared EXACTLY: the port's plain version (what the CPU runs,
and what the CUDA kernel is held to on the card) against both the JAX
package's XLA fixpoint ``core/nms.py:_greedy_nms_mask`` and its Pallas
kernel in interpret mode. Cases are those of tests/test_pallas_nms.py, plus
a K that is not a multiple of 256.

``non_max_suppression`` is compared with JAX's ``impl="xla"`` on the same
decoded detections: classes, valid and num_valid exactly, boxes and scores
to atol 1e-6 (they are gathered, not computed, so in practice they are
bit-equal). Scores quantised to bf16 make ties common; the stable orders
must then pick the same boxes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_cib_torch.core.nms import non_max_suppression as t_nms
from object_detection_cib_torch.ops.nms import (
    greedy_nms_mask,
    greedy_nms_mask_plain,
    greedy_nms_mask_words,
    suppression_words,
)
from object_detection_cib_tpu.core.nms import _greedy_nms_mask
from object_detection_cib_tpu.core.nms import non_max_suppression as j_nms
from object_detection_cib_tpu.ops.pallas_nms import pallas_greedy_nms_mask


def _random_boxes(n_real, K=256, seed=0, span=200, wh=(10, 80)):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((K, 4), np.float32)
    xy = rng.uniform(0, span, (n_real, 2))
    sz = rng.uniform(wh[0], wh[1], (n_real, 2))
    boxes[:n_real] = np.concatenate([xy, xy + sz], -1)
    live = np.zeros(K, bool)
    live[:n_real] = True
    return boxes, live


def _port_mask(boxes, live, thr):
    return greedy_nms_mask(
        torch.from_numpy(boxes[None]), torch.from_numpy(live[None]), thr
    )[0].numpy()


def _check_all_three(boxes, live, thr):
    want = np.asarray(_greedy_nms_mask(jnp.asarray(boxes), jnp.asarray(live), thr))
    pallas = np.asarray(
        pallas_greedy_nms_mask(jnp.asarray(boxes), jnp.asarray(live), thr, interpret=True)
    )
    got = _port_mask(boxes, live, thr)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_real", [5, 60, 200])
def test_plain_mask_matches_xla_and_pallas(seed, n_real):
    boxes, live = _random_boxes(n_real, seed=seed)
    _check_all_three(boxes, live, 0.45)


def test_plain_mask_chain_case():
    # A kills B, B kills C, A doesn't kill C -> greedy keeps {A, C}
    boxes = np.zeros((256, 4), np.float32)
    boxes[0] = [0, 0, 10, 10]
    boxes[1] = [3, 0, 13, 10]  # IoU(A,B) = 7/13
    boxes[2] = [6, 0, 16, 10]  # IoU(B,C) = 7/13; IoU(A,C) = 4/16
    live = np.zeros(256, bool)
    live[:3] = True
    got = _check_all_three(boxes, live, 0.45)
    assert got[:3].tolist() == [True, False, True]


def test_plain_mask_batched():
    b0, l0 = _random_boxes(50, seed=3)
    b1, l1 = _random_boxes(120, seed=4)
    boxes, live = np.stack([b0, b1]), np.stack([l0, l1])
    want = np.asarray(
        jax.vmap(_greedy_nms_mask, in_axes=(0, 0, None))(
            jnp.asarray(boxes), jnp.asarray(live), 0.5
        )
    )
    pallas = np.asarray(
        pallas_greedy_nms_mask(jnp.asarray(boxes), jnp.asarray(live), 0.5, interpret=True)
    )
    got = greedy_nms_mask(torch.from_numpy(boxes), torch.from_numpy(live), 0.5).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


def test_plain_mask_k2048_production_capacity():
    boxes, live = _random_boxes(900, K=2048, seed=5, span=400, wh=(10, 90))
    _check_all_three(boxes, live, 0.5)


def test_plain_mask_k_not_multiple_of_tile():
    """K=1000: JAX takes its XLA path; the port's kernel masks the ragged tile."""
    boxes, live = _random_boxes(700, K=1000, seed=6, span=300)
    want = np.asarray(_greedy_nms_mask(jnp.asarray(boxes), jnp.asarray(live), 0.45))
    np.testing.assert_array_equal(_port_mask(boxes, live, 0.45), want)


def test_plain_mask_threshold_ties():
    """IoU exactly at the threshold is kept (strictly greater suppresses)."""
    boxes = np.zeros((4, 4), np.float32)
    boxes[0] = [0, 0, 10, 10]
    boxes[1] = [5, 0, 15, 10]  # IoU = 50/150 = 1/3 (up to f32 rounding)
    live = np.ones(4, bool)
    live[2:] = False
    iou = float(np.asarray(
        jax.numpy.asarray(50.0, jnp.float32) / (jnp.asarray(150.0, jnp.float32) + 1e-7)
    ))
    for thr in (iou, np.nextafter(np.float32(iou), np.float32(0))):
        want = np.asarray(_greedy_nms_mask(jnp.asarray(boxes), jnp.asarray(live), float(thr)))
        np.testing.assert_array_equal(_port_mask(boxes, live, float(thr)), want)


# The CUDA kernel's algorithm (64-bit suppression words, then a scan over the
# 64-box blocks) in plain PyTorch, held exact against the plain version, the
# XLA fixpoint and the interpret-mode Pallas kernel.

def _edge_case(name):
    K = 300
    boxes = np.zeros((K, 4), np.float32)
    live = np.ones(K, bool)
    if name == "equal_boxes":  # box 0 suppresses all others
        boxes[:] = [0, 0, 100, 100]
    else:  # disjoint boxes: all kept, or none live
        boxes[:, 0] = np.arange(K) * 20.0
        boxes[:, 2] = boxes[:, 0] + 10.0
        boxes[:, 3] = 10.0
        live[:] = name == "disjoint"
    return boxes, live


def _words_cases():
    cases = {f"random_{n}_seed{seed}": (*_random_boxes(n, seed=seed), 0.45)
             for seed in (0, 1, 2) for n in (5, 60, 200)}
    cases["k2048"] = (*_random_boxes(900, K=2048, seed=5, span=400, wh=(10, 90)), 0.5)
    cases["k64"] = (*_random_boxes(64, K=64, seed=7, span=120), 0.45)
    cases["k65"] = (*_random_boxes(65, K=65, seed=8, span=120), 0.45)
    cases["k1000_ragged"] = (*_random_boxes(700, K=1000, seed=6, span=300), 0.45)
    cases["thr_zero"] = (*_random_boxes(150, K=192, seed=9), 0.0)
    cases["thr_negative"] = (*_random_boxes(100, K=130, seed=10), -0.5)
    for name in ("none_live", "disjoint", "equal_boxes"):
        cases[name] = (*_edge_case(name), 0.5)
    return cases


_WORDS_CASES = _words_cases()


@pytest.mark.parametrize("name", list(_WORDS_CASES))
def test_words_algorithm_matches_plain_xla_and_pallas(name):
    boxes, live, thr = _WORDS_CASES[name]
    tb, tl = torch.from_numpy(boxes[None]), torch.from_numpy(live[None])
    got = greedy_nms_mask_words(tb, tl, thr)[0].numpy()
    np.testing.assert_array_equal(got, greedy_nms_mask_plain(tb, tl, thr)[0].numpy())
    want = np.asarray(_greedy_nms_mask(jnp.asarray(boxes), jnp.asarray(live), thr))
    np.testing.assert_array_equal(got, want)
    if len(live) % 256 == 0:  # the Pallas kernel takes whole tiles only
        pallas = pallas_greedy_nms_mask(jnp.asarray(boxes), jnp.asarray(live), thr, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(pallas))
    if name == "none_live":
        assert not got.any()
    if name == "disjoint":
        assert got.all()
    if name == "equal_boxes":
        assert got.nonzero()[0].tolist() == [0]


def test_words_algorithm_batched_and_ties():
    b0, l0 = _random_boxes(50, seed=3)
    b1, l1 = _random_boxes(120, seed=4)
    boxes, live = torch.from_numpy(np.stack([b0, b1])), torch.from_numpy(np.stack([l0, l1]))
    assert torch.equal(greedy_nms_mask_words(boxes, live, 0.5), greedy_nms_mask_plain(boxes, live, 0.5))
    # IoU exactly at the threshold is kept; one ulp below it suppresses
    tie = torch.zeros(1, 4, 4)
    tie[0, 0] = torch.tensor([0.0, 0.0, 10.0, 10.0])
    tie[0, 1] = torch.tensor([5.0, 0.0, 15.0, 10.0])
    tie_live = torch.tensor([[True, True, False, False]])
    iou = float(torch.tensor(50.0) / (torch.tensor(150.0) + 1e-7))
    for thr, kept in ((iou, [True, True]), (float(np.nextafter(np.float32(iou), np.float32(0))), [True, False])):
        assert greedy_nms_mask_words(tie, tie_live, thr)[0, :2].tolist() == kept
        assert greedy_nms_mask_plain(tie, tie_live, thr)[0, :2].tolist() == kept


def test_suppression_words_layout():
    """Right of the diagonal, bit i of word w of row j is 'j suppresses
    64 w + i'; in a row's own block, 'the earlier box 64 w + i suppresses j';
    left of the diagonal and past K nothing; bit 63 included."""
    K = 130
    boxes = torch.zeros(1, K, 4)
    boxes[0, :, 2:] = 10.0  # all equal: every pair is above the threshold
    words = suppression_words(boxes, 0.5)[0]
    assert words.shape == (K, 3) and words.dtype == torch.int64
    bits = ((words[:, :, None] >> torch.arange(64)) & 1).bool().reshape(K, 192)
    j, i = torch.meshgrid(torch.arange(K), torch.arange(192), indexing="ij")
    want = (i < K) & ((i // 64 > j // 64) | ((i // 64 == j // 64) & (i < j)))
    assert torch.equal(bits, want)
    assert bits[0, 127] and bits[63, 62] and not bits[63, 63] and not bits[62, 63]


def test_wrapper_rejects_bad_inputs():
    b = torch.zeros(1, 8, 4)
    live = torch.ones(1, 8, dtype=torch.bool)
    with pytest.raises(ValueError):
        greedy_nms_mask(b.double(), live, 0.5)
    with pytest.raises(ValueError):
        greedy_nms_mask(b, live.float(), 0.5)
    with pytest.raises(ValueError):
        greedy_nms_mask(b[:, :4], live, 0.5)
    with pytest.raises(ValueError):
        greedy_nms_mask(b[0], live[0], 0.5)
    assert greedy_nms_mask_plain(b, live, 0.5).shape == (1, 8)


def _detections(seed, B=2, N=600, nc=4, bf16_scores=False):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 200, (B, N, 2))
    wh = rng.uniform(5, 60, (B, N, 2))
    obj = rng.uniform(0, 1, (B, N, 1))
    cls = rng.uniform(0, 1, (B, N, nc))
    if bf16_scores:
        obj = np.asarray(jnp.asarray(obj, jnp.bfloat16).astype(jnp.float32))
        cls = np.asarray(jnp.asarray(cls, jnp.bfloat16).astype(jnp.float32))
        # coarser still: 8 levels, so many (obj * cls) products tie exactly
        obj, cls = np.round(obj * 8) / 8, np.round(cls * 8) / 8
    return np.concatenate([xy, xy + wh, obj, cls], -1).astype(np.float32)


def _compare_nms(det, **kw):
    want = j_nms(jnp.asarray(det), impl="xla", **kw)
    got = t_nms(torch.from_numpy(det), **kw)
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.num_valid.numpy(), np.asarray(want.num_valid))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-6, rtol=0)
    assert got.classes.dtype == torch.int32 and got.num_valid.dtype == torch.int32
    return got


@pytest.mark.parametrize(
    "case",
    [
        dict(nc=4, kw=dict(conf_thres=0.25, iou_thres=0.45, max_nms=512)),
        dict(nc=4, kw=dict(conf_thres=0.001, iou_thres=0.6, max_nms=1000, max_det=300)),
        dict(nc=1, kw=dict(conf_thres=0.1, iou_thres=0.5, max_nms=256)),
        dict(nc=4, kw=dict(conf_thres=0.1, iou_thres=0.5, multi_label=False)),
        dict(nc=4, kw=dict(conf_thres=0.05, iou_thres=0.5, classes=[0, 2])),
    ],
    ids=["multi_label", "val_settings", "single_class", "best_class", "allow_list"],
)
@pytest.mark.parametrize("ties", [False, True], ids=["f32", "bf16_ties"])
def test_nms_matches_jax(case, ties):
    det = _detections(7, nc=case["nc"], bf16_scores=ties)
    got = _compare_nms(det, **case["kw"])
    assert int(got.num_valid.sum()) > 0
    if ties:
        flat = det[..., 4:5] * det[..., 5:]
        assert len(np.unique(flat)) < flat.size // 4  # ties really are common
