"""Port parity: assignment, loss, SmartSGD and the train step.

Inputs come from numpy seeds; both sides run in f32 on the CPU.
Tolerances:
  * assignment: every field exact (the same f32 ops in the same order),
    compaction and ``assign_drop`` included;
  * loss components rtol 1e-5 and their gradients with respect to the head
    maps atol 1e-5 (transcendentals differ in the last bits between the two
    libraries' CPU kernels);
  * SmartSGD hyperparameters exact (both in f32), one update atol 1e-7;
  * three yolov5n train steps at 64 px from converted weights: loss rtol
    1e-4, every parameter and BatchNorm statistic within atol 1e-5 +
    rtol 1e-4 (convolutions sum in another order, ~60 layers deep, forward
    and backward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_cib_torch.core import assigner as tas
from object_detection_cib_torch.core.types import FeatureShape as TShape
from object_detection_cib_torch.core.types import default_anchors as t_anchors
from object_detection_cib_torch.data.synthetic import build_fake_manifest
from object_detection_cib_torch.models.convert import flax_to_torch
from object_detection_cib_torch.models.yolov5 import (
    DetectionHeadResult as THead,
    Yolov5NetworkResult as TResult,
    build_network as t_build,
)
from object_detection_cib_torch.train import loss as tloss
from object_detection_cib_torch.train import optim as topt
from object_detection_cib_torch.train.steps import Batch as TBatch, make_train_step as t_make_step
from object_detection_cib_torch.train.trainer import _compute_loss_weights as t_weights
from object_detection_cib_tpu.core import assigner as jas
from object_detection_cib_tpu.core.types import FeatureShape as JShape
from object_detection_cib_tpu.core.types import default_anchors as j_anchors
from object_detection_cib_tpu.models.yolov5 import (
    DetectionHeadResult as JHead,
    Yolov5NetworkResult as JResult,
    build_network as j_build,
)
from object_detection_cib_tpu.train import loss as jloss
from object_detection_cib_tpu.train import optim as jopt
from object_detection_cib_tpu.train.steps import (
    Batch as JBatch,
    create_train_state,
    make_train_step as j_make_step,
)
from object_detection_cib_tpu.train.trainer import _compute_loss_weights as j_weights

IMG, NC, A = 64, 3, 3


def T(a):
    return torch.from_numpy(np.array(a))


def _targets(B, Tn, seed, img=IMG, nc=NC):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((B, Tn, 4), np.float32)
    labels = np.zeros((B, Tn), np.int32)
    mask = np.zeros((B, Tn), bool)
    for b in range(B):
        for t in range(rng.integers(1, Tn)):
            x, y = rng.uniform(0, img - 20, 2)
            w, h = rng.uniform(3, 40, 2)
            boxes[b, t] = [x, y, min(x + w, img - 1), min(y + h, img - 1)]
            labels[b, t] = rng.integers(0, nc)
            mask[b, t] = True
    boxes[0, 0] = [8.0, 16.0, 24.0, 32.0]  # integer grid coordinates
    mask[0, 0] = True
    return boxes, labels, mask


# -------------------------------------------------------------- assignment

@pytest.mark.parametrize("B,Tn", [(4, 12), (2, 30)])
@pytest.mark.parametrize("seed", [0, 1])
def test_assignment_exact(B, Tn, seed):
    """The port's gate and three offset slots are JAX's defaults."""
    boxes, labels, mask = _targets(B, Tn, seed)
    want = jas.assign_targets(jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask),
                              JShape(IMG, IMG), j_anchors(), 4.0, 3)
    got = tas.assign_targets(T(boxes), T(labels), T(mask), TShape(IMG, IMG), t_anchors())
    for gl, jl in zip(got.levels(), want.levels()):
        for name, g, j in zip(jl._fields, gl, jl):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=name)
        assert int(gl.valid.sum()) > 0


@pytest.mark.parametrize("thr", [4.0, 2.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_five_offset_assignment_exact(seed, thr):
    """The reference's full offset table (``assigners.offset_capacity=5``)."""
    boxes, labels, mask = _targets(4, 12, seed)
    want = jas.assign_targets(jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask),
                              JShape(IMG, IMG), j_anchors(), thr, 5)
    got = tas.assign_targets(T(boxes), T(labels), T(mask), TShape(IMG, IMG), t_anchors(),
                             threshold=thr, offset_capacity=5)
    three = tas.assign_targets(T(boxes), T(labels), T(mask), TShape(IMG, IMG), t_anchors(), threshold=thr)
    for gl, jl, tl in zip(got.levels(), want.levels(), three.levels()):
        for name, g, j in zip(jl._fields, gl, jl):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=name)
        assert gl.valid.shape[0] == tl.valid.shape[0] * 5 // 3
    # boxes[0, 0] sits on integer grid coordinates: there the five-slot table
    # also emits the duplicate neighbour cells the compact one drops
    assert sum(int(lv.valid.sum()) for lv in got.levels()) > sum(int(lv.valid.sum()) for lv in three.levels())
    with pytest.raises(ValueError, match="offset_capacity"):
        tas.assign_targets(T(boxes), T(labels), T(mask), TShape(IMG, IMG), t_anchors(), offset_capacity=4)


def test_train_step_without_compaction_equals_a_roomy_cap():
    """``assign_compact_slots=None`` keeps every slot; a cap no level reaches
    gives the same step."""
    boxes, labels, mask = _targets(4, 10, 7)
    images = np.random.default_rng(8).random((4, IMG, IMG, 3), np.float32)
    out = []
    for slots in (None, 10_000):
        net = t_build(NC, "n", device="cpu", seed=3)
        step = t_make_step(net, t_anchors(), TShape(IMG, IMG), topt.SmartSGD(net, topt.OptimizerConfig(), 10),
                           assign_compact_slots=slots, assign_offset_capacity=5, assign_threshold=3.0)
        m = step(TBatch(*map(T, (images, boxes, labels, mask))))
        out.append((m, net.state_dict()))
    (m0, sd0), (m1, sd1) = out
    assert int(m0.assign_drop) == int(m1.assign_drop) == 0
    np.testing.assert_allclose(float(m0.total), float(m1.total), rtol=1e-6)
    for k in sd0:
        np.testing.assert_allclose(sd0[k].numpy(), sd1[k].numpy(), rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("cap", [4, 40, 10_000])
def test_compaction_and_drop_exact(cap):
    boxes, labels, mask = _targets(4, 12, 2)
    want = jas.assign_targets(jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask),
                              JShape(IMG, IMG), j_anchors())
    got = tas.assign_targets(T(boxes), T(labels), T(mask), TShape(IMG, IMG), t_anchors())
    drops = []
    for gl, jl in zip(got.levels(), want.levels()):
        gc = tas.compact_level_assignment(gl, cap)
        jc = jas.compact_level_assignment(jl, cap)
        for name, g, j in zip(jc._fields, gc, jc):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=name)
        drops.append(max(int(jl.valid.sum()) - min(cap, jl.valid.shape[0]), 0))
    if cap == 4:
        assert sum(drops) > 0


# -------------------------------------------------------------------- loss

def _heads(B, seed, nc=NC):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 2, (B, IMG // s, IMG // s, A * (5 + nc))).astype(np.float32)
            for s in (8, 16, 32)]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_head_grads_match_jax(weighted, seed):
    B = 4
    boxes, labels, mask = _targets(B, 12, seed + 10)
    raws = _heads(B, seed)
    cw = np.asarray([0.5, 2.0, 4.0], np.float32) if weighted else None
    jassign = jas.assign_targets(jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask),
                                 JShape(IMG, IMG), j_anchors())
    jassign = jas.Assignment(*(jas.compact_level_assignment(lv, 128 * B) for lv in jassign.levels()))

    def jfn(rs):
        res = jloss.yolov5_loss(JResult(*(JHead(r, A, NC) for r in rs)), jassign, JShape(IMG, IMG),
                                class_weights=None if cw is None else jnp.asarray(cw))
        return res.total, res

    (jtotal, jres), jgrads = jax.value_and_grad(jfn, has_aux=True)([jnp.asarray(r) for r in raws])

    tassign = tas.assign_targets(T(boxes), T(labels), T(mask), TShape(IMG, IMG), t_anchors())
    tassign = tas.Assignment(*(tas.compact_level_assignment(lv, 128 * B) for lv in tassign.levels()))
    traws = [T(r).requires_grad_() for r in raws]
    tres = tloss.yolov5_loss(TResult(*(THead(r, A, NC) for r in traws)), tassign, TShape(IMG, IMG),
                             class_weights=None if cw is None else T(cw))
    tres.total.backward()
    for name, g, j in zip(("localization", "objectness", "classification"), tres, jres):
        np.testing.assert_allclose(g.detach().item(), float(j), rtol=1e-5, err_msg=name)
    for g, j in zip(traws, jgrads):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(j), atol=1e-5)


def test_bce_with_logits_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 8, (64, 5)).astype(np.float32)
    t = rng.random((64, 5)).astype(np.float32)
    pw = rng.uniform(0.5, 3, 5).astype(np.float32)
    np.testing.assert_allclose(tloss.bce_with_logits(T(x), T(t), T(pw)).numpy(),
                               np.asarray(jloss.bce_with_logits(jnp.asarray(x), jnp.asarray(t),
                                                                jnp.asarray(pw))), rtol=1e-6, atol=1e-6)


def test_loss_weights_match_jax():
    info = build_fake_manifest(num_classes=5, num_images=40, seed=3, zipf_a=1.01)
    np.testing.assert_array_equal(t_weights(info), j_weights(info))


# --------------------------------------------------------------- SmartSGD

CFGS = [
    topt.OptimizerConfig(max_epochs=10),
    topt.OptimizerConfig(max_epochs=7, schedule="cosine", lrf=0.1),
    topt.OptimizerConfig(max_epochs=5, schedule="cosine_annealing"),
    topt.OptimizerConfig(max_epochs=300, schedule="step"),
    topt.OptimizerConfig(max_epochs=10, warmup=None),
]


def _jcfg(c):
    w = None if c.warmup is None else jopt.WarmupParams(*c.warmup)
    return jopt.OptimizerConfig(*c[:-1], warmup=w)


@pytest.mark.parametrize("ci", range(len(CFGS)))
def test_hyperparams_match_jax(ci):
    cfg, spe = CFGS[ci], 40
    tsgd = topt.SmartSGD(t_build(NC, "n", device="cpu"), cfg, spe)
    jsgd = jopt.SmartSGD(_jcfg(cfg), spe)
    assert tsgd.nw == jsgd.nw == (0 if cfg.warmup is None else 120)
    for step in (0, 1, 2, 57, 119, 120, 121, 200, 399):
        got = tsgd.hyperparams(step)
        want = [float(v) for v in jsgd.hyperparams(jnp.asarray(step, jnp.int32))]
        assert got == pytest.approx(want, rel=1e-6, abs=1e-9), (step, got, want)
    if cfg.warmup is not None:
        lr_bias, lr_other, mom = tsgd.hyperparams(0)
        assert lr_other == 0.0 and lr_bias == pytest.approx(0.1) and mom == pytest.approx(0.8)


def test_groups_and_update_match_jax():
    jnet = j_build(NC, "n")
    variables = jax.tree.map(np.asarray, jax.jit(lambda k, x: jnet.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3))))
    params = variables["params"]
    rng = np.random.default_rng(4)
    grads = jax.tree.map(lambda p: rng.normal(0, 1, p.shape).astype(np.float32), params)
    net = t_build(NC, "n", device="cpu")
    net.load_state_dict(flax_to_torch(variables))
    tg = flax_to_torch({"params": grads})
    # the same three groups on both sides
    jlabels = flax_to_torch({"params": jax.tree.map(
        lambda p, g: np.full(p.shape, g, np.float32), params, jopt.group_params(params))})
    tlabels = topt.group_params(net)
    for name, lab in jlabels.items():
        assert (lab.numpy() == tlabels[name]).all(), name

    cfg = topt.OptimizerConfig(max_epochs=10)
    jsgd = jopt.SmartSGD(_jcfg(cfg), 10)
    tsgd = topt.SmartSGD(net, cfg, 10)
    state = jsgd.init(params)
    for step in range(3):  # step 0 is warmup with lr_other = 0
        params_j, state = jsgd.update(grads, state, params, jnp.asarray(step))
        params = jax.tree.map(np.asarray, params_j)
        for name, p in net.named_parameters():
            p.grad = tg[name].clone()
        tsgd.step()
        want = flax_to_torch({"params": params})
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-7,
                                       err_msg=f"{name} step {step}")


# ------------------------------------------------------------- train step

def test_three_train_steps_match_jax():
    B, Tn = 4, 10
    jnet = j_build(NC, "n")
    shape = JShape(IMG, IMG)
    jsgd = jopt.SmartSGD(jopt.OptimizerConfig(max_epochs=10), steps_per_epoch=10)
    state = create_train_state(jnet, jax.random.PRNGKey(0), shape, jsgd)
    net = t_build(NC, "n", device="cpu")
    net.load_state_dict(flax_to_torch(jax.tree.map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})))
    tsgd = topt.SmartSGD(net, topt.OptimizerConfig(max_epochs=10), steps_per_epoch=10)
    tstep = t_make_step(net, t_anchors(), TShape(IMG, IMG), tsgd)
    jstep = jax.jit(j_make_step(jnet, j_anchors(), shape, jsgd))

    for i in range(3):
        boxes, labels, mask = _targets(B, Tn, 20 + i)
        images = np.random.default_rng(30 + i).random((B, IMG, IMG, 3), np.float32)
        state, jm = jstep(state, JBatch(*map(jnp.asarray, (images, boxes, labels, mask))))
        tm = tstep(TBatch(*map(T, (images, boxes, labels, mask))))
        for name in ("total", "box", "obj", "cls"):
            np.testing.assert_allclose(float(getattr(tm, name)), float(getattr(jm, name)),
                                       rtol=1e-4, err_msg=f"{name} step {i}")
        assert tm.lr == pytest.approx(float(jm.lr), rel=1e-6)
        assert int(tm.assign_drop) == int(jm.assign_drop) == 0
    want = flax_to_torch(jax.tree.map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
    got = net.state_dict()
    assert set(got) == set(want)
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
