"""Port parity: the train step's rematerialisation (``remat_policy``).

yolov5n at 64 px on the CPU, inputs from numpy seeds. Tolerances:
  * each policy against no remat, one step in f32 and in f64: the losses,
    every gradient, every parameter after SmartSGD and every BatchNorm
    running statistic BITWISE equal (the recompute repeats the forward's
    operators on the same inputs); the running statistics move once;
  * each policy against the JAX ``make_train_step(remat_policy=p)``, three
    steps from converted weights: ``tests/test_torch_train.py``'s three-step
    tolerances (loss rtol 1e-4; parameters and statistics atol 1e-5 + rtol
    1e-4).
The two-rank case (the global BatchNorm) is in ``tests/test_torch_parallel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_cib_torch.core.types import FeatureShape, default_anchors
from object_detection_cib_torch.models.convert import flax_to_torch
from object_detection_cib_torch.models.layers import BatchNorm
from object_detection_cib_torch.models.yolov5 import build_network
from object_detection_cib_torch.train.optim import OptimizerConfig, SmartSGD
from object_detection_cib_torch.train.steps import REMAT_SAVES, Batch, make_train_step
from object_detection_cib_tpu.core.types import FeatureShape as JShape
from object_detection_cib_tpu.core.types import default_anchors as j_anchors
from object_detection_cib_tpu.models.yolov5 import build_network as j_build
from object_detection_cib_tpu.train import optim as jopt
from object_detection_cib_tpu.train.steps import Batch as JBatch
from object_detection_cib_tpu.train.steps import create_train_state
from object_detection_cib_tpu.train.steps import make_train_step as j_make_step

S, B, T, NC = 64, 4, 10, 3
POLICIES = sorted(REMAT_SAVES)


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((B, T, 4), np.float32)
    labels = np.zeros((B, T), np.int32)
    mask = np.zeros((B, T), bool)
    for b in range(B):
        for t in range(rng.integers(1, T)):
            x, y = rng.uniform(0, S - 20, 2)
            w, h = rng.uniform(3, 40, 2)
            boxes[b, t] = [x, y, min(x + w, S - 1), min(y + h, S - 1)]
            labels[b, t] = rng.integers(0, NC)
            mask[b, t] = True
    images = rng.random((B, S, S, 3), np.float32)
    return images, boxes, labels, mask


def _one_step(policy, dtype):
    """One step from seeded weights: (metrics, gradients, state, BatchNorm
    forward calls)."""
    net = build_network(NC, "n", device="cpu", seed=5).to(dtype)
    step = make_train_step(net, default_anchors(), FeatureShape(S, S), SmartSGD(net, OptimizerConfig(), 6),
                           remat_policy=policy)
    calls = []
    for m in net.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_hook(lambda *_: calls.append(1))
    images, *targets = (torch.from_numpy(a) for a in _batch(7))
    metrics = step(Batch(images.to(dtype), *targets))
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    return metrics, grads, {k: v.clone() for k, v in net.state_dict().items()}, len(calls)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_step_is_bitwise_the_step_without_it(policy, dtype):
    torch.set_num_threads(1)
    m0, g0, s0, calls0 = _one_step(None, dtype)
    m, g, s, calls = _one_step(policy, dtype)
    assert calls > calls0  # the backward ran the BatchNorms again
    for name in m0._fields:
        assert torch.equal(getattr(m, name), getattr(m0, name)), name
    assert set(g) == set(g0)
    for k, v in g0.items():
        assert torch.equal(g[k], v), k
    for k, v in s0.items():  # parameters after SmartSGD, running statistics moved once
        assert torch.equal(s[k], v), k


def test_unknown_remat_policy_raises():
    net = build_network(NC, "n", device="cpu", seed=5)
    with pytest.raises(ValueError, match="unknown remat_policy 'bogus'"):
        make_train_step(net, default_anchors(), FeatureShape(S, S), SmartSGD(net, OptimizerConfig(), 6),
                        remat_policy="bogus")


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_three_steps_match_jax(policy):
    torch.set_num_threads(1)
    jnet = j_build(NC, "n")
    jsgd = jopt.SmartSGD(jopt.OptimizerConfig(max_epochs=10), steps_per_epoch=10)
    state = create_train_state(jnet, jax.random.PRNGKey(0), JShape(S, S), jsgd)
    net = build_network(NC, "n", device="cpu")
    net.load_state_dict(flax_to_torch(jax.tree.map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})))
    opt = SmartSGD(net, OptimizerConfig(max_epochs=10), steps_per_epoch=10)
    tstep = make_train_step(net, default_anchors(), FeatureShape(S, S), opt, remat_policy=policy)
    jstep = jax.jit(j_make_step(jnet, j_anchors(), JShape(S, S), jsgd, remat_policy=policy))
    for i in range(3):
        arrays = _batch(20 + i)
        state, jm = jstep(state, JBatch(*map(jnp.asarray, arrays)))
        tm = tstep(Batch(*(torch.from_numpy(a) for a in arrays)))
        for name in ("total", "box", "obj", "cls"):
            np.testing.assert_allclose(float(getattr(tm, name)), float(getattr(jm, name)), rtol=1e-4,
                                       err_msg=f"{name} step {i}")
    want = flax_to_torch(jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
    got = net.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-4, err_msg=k)
