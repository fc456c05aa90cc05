"""Port parity: the bf16 train step against the JAX package's bf16 train step.

Production trains in bf16 compute over f32 parameters
(``configs/experiment/yv5s.yaml``; JAX ``build_network(dtype=bfloat16)``,
the port's ``net.dtype = torch.bfloat16``). A bare tolerance on a bf16 step
cannot tell a cast in the wrong place (a BatchNorm reduced in bf16, a head
or a loss fed in another dtype) from bf16 rounding; a ratio against the JAX
package's own bf16 error can. So one step of yolov5n (nc=3, 64 px, B=4, the
loss and SmartSGD of ``test_torch_train.py``'s three-step test) runs from
the same converted flax variables on the same numpy-seeded batch three
ways: JAX in bf16, the port in bf16 and the port in f64, the reference.
Four batches (seeds 30-33 and 20-23), each one step from the same start.

Distances from the f64 step, each as the largest absolute difference and
as the norm of the difference over the norm of the reference:
  * the loss components ``total``, ``box``, ``obj``, ``cls``, each over the
    four batches (one scalar a step is one draw of rounding noise: a single
    batch's ratio swings from 0.1 to 12 either way);
  * each head's raw output of the step's forward (train mode), over the
    four batches;
  * the parameters and BatchNorm statistics after the step (largest
    absolute difference), and the update they took (after - before,
    relative norm), over the four batches.

Gate: port <= 2 x JAX + slack, the slack being 4 x the port's own f32
step's distance (the f32 rounding floor of the same quantity, far below
either bf16 distance), and, so that the step really rounded to bf16, each
head's relative distance at least half JAX's. Measured on an x86-64 CPU (port
bf16 / JAX bf16, largest absolute difference): total 3.87e-3 / 6.39e-3,
box 7.48e-4 / 1.06e-3, obj 1.39e-4 / 1.91e-4, cls 2.33e-4 / 7.25e-4; heads
P3 0.470 / 0.395, P4 0.581 / 0.403, P5 0.448 / 0.661; parameters 7.86e-3 /
7.90e-3; the update's relative norm 0.0168 / 0.0165. The largest ratio is
1.44 (P4's largest difference), the heads' relative norms 0.97-1.07: no
fault was found.

The controls plant two faults into the port's step, and the gate fails
both: the parameters held in bf16 (the update rounded away) and the cast
to bf16 left out (f32 compute). What the gate cannot see: BatchNorm
statistics reduced in bf16 (the JAX package's measurement-only
``BN_FORCE_F32_STATS=False``) add rounding of bf16's own size and stay
inside it (measured, 16 of 16 distances within the limit).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_cib_torch.core.types import FeatureShape as TShape
from object_detection_cib_torch.core.types import default_anchors as t_anchors
from object_detection_cib_torch.models.convert import flax_to_torch
from object_detection_cib_torch.models.yolov5 import build_network as t_build
from object_detection_cib_torch.train import optim as topt
from object_detection_cib_torch.train.steps import Batch as TBatch, make_train_step as t_make_step
from object_detection_cib_tpu.core.types import FeatureShape as JShape
from object_detection_cib_tpu.core.types import default_anchors as j_anchors
from object_detection_cib_tpu.models.yolov5 import build_network as j_build
from object_detection_cib_tpu.train import optim as jopt
from object_detection_cib_tpu.train.steps import Batch as JBatch, create_train_state, make_train_step as j_make_step

from test_torch_train import _targets

IMG, NC, B, TN = 64, 3, 4, 10
SEEDS = range(4)
LOSSES = ("total", "box", "obj", "cls")
RATIO, FLOOR = 2.0, 4.0


def _batch(seed):
    boxes, labels, mask = _targets(B, TN, 20 + seed)
    images = np.random.default_rng(30 + seed).random((B, IMG, IMG, 3), np.float32)
    return images, boxes, labels, mask


def _flat(state: dict, keys) -> np.ndarray:
    return np.concatenate([np.asarray(state[k], np.float64).ravel() for k in keys])


def _run(losses, heads, after) -> dict:
    return dict(losses=losses, heads=heads, after=after)


@pytest.fixture(scope="module")
def start():
    """JAX's bf16 runs of the four batches, and the flax variables they start from."""
    jnet = j_build(NC, "n", dtype=jnp.bfloat16)
    shape = JShape(IMG, IMG)
    jsgd = jopt.SmartSGD(jopt.OptimizerConfig(max_epochs=10), steps_per_epoch=10)
    state = create_train_state(jnet, jax.random.PRNGKey(0), shape, jsgd)
    variables = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    step = jax.jit(j_make_step(jnet, j_anchors(), shape, jsgd))
    forward = jax.jit(lambda v, x: jnet.apply(v, x, train=True, mutable=["batch_stats"])[0])
    init = {k: v.numpy() for k, v in flax_to_torch(variables).items()}
    keys = sorted(k for k in init if not k.endswith("num_batches_tracked"))
    runs = []
    for seed in SEEDS:
        images, boxes, labels, mask = _batch(seed)
        heads = [np.asarray(lv.raw, np.float32) for lv in forward(variables, images).levels()]
        assert forward(variables, images).levels()[0].raw.dtype == jnp.bfloat16
        new, m = step(state, JBatch(*map(jnp.asarray, (images, boxes, labels, mask))))
        after = flax_to_torch(jax.tree.map(np.asarray, {"params": new.params, "batch_stats": new.batch_stats}))
        runs.append(_run({n: float(getattr(m, n)) for n in LOSSES}, heads,
                         _flat({k: v.numpy() for k, v in after.items()}, keys)))
    return dict(variables=variables, init=_flat(init, keys), keys=keys, jax=runs)


def _port_runs(start, dtype, params_dtype=torch.float32) -> list:
    """The port's step of each batch from the start, computing in ``dtype``
    over parameters in ``params_dtype`` (f64: inputs in f64 too)."""
    runs = []
    for seed in SEEDS:
        images, boxes, labels, mask = _batch(seed)
        net = t_build(NC, "n", device="cpu")
        net.load_state_dict(flax_to_torch(start["variables"]))
        net.to(params_dtype)
        net.dtype = None if dtype == params_dtype else dtype
        x = torch.from_numpy(images).to(torch.float64 if dtype == torch.float64 else torch.float32)
        with torch.no_grad():
            heads = [lv.raw.double().numpy() for lv in copy.deepcopy(net).train()(x.to(params_dtype)).levels()]
        sgd = topt.SmartSGD(net, topt.OptimizerConfig(max_epochs=10), steps_per_epoch=10)
        step = t_make_step(net, t_anchors(), TShape(IMG, IMG), sgd)
        m = step(TBatch(x.to(params_dtype), torch.from_numpy(boxes).to(x.dtype), torch.from_numpy(labels),
                        torch.from_numpy(mask)))
        after = {k: v.detach().double().numpy() for k, v in net.state_dict().items()}
        runs.append(_run({n: float(getattr(m, n)) for n in LOSSES}, heads, _flat(after, start["keys"])))
    return runs


@pytest.fixture(scope="module")
def references(start):
    return _port_runs(start, torch.float64, torch.float64), _port_runs(start, torch.float32)


def _distances(runs, ref, init) -> dict:
    """name -> distance from the f64 runs, over the four batches."""

    def both(a, r):
        a, r = np.concatenate([np.ravel(x) for x in a]), np.concatenate([np.ravel(x) for x in r])
        return np.abs(a - r).max(), np.linalg.norm(a - r) / np.linalg.norm(r)

    out = {}
    for n in LOSSES:
        out[f"{n} max"], out[f"{n} rel"] = both([r["losses"][n] for r in runs], [r["losses"][n] for r in ref])
    for lv in range(3):
        out[f"head P{lv + 3} max"], out[f"head P{lv + 3} rel"] = both([r["heads"][lv] for r in runs],
                                                                    [r["heads"][lv] for r in ref])
    out["parameters max"] = both([r["after"] for r in runs], [r["after"] for r in ref])[0]
    out["update rel"] = both([r["after"] - init for r in runs], [r["after"] - init for r in ref])[1]
    return out


def _gate(port, start, references) -> dict:
    """name -> (port, JAX, limit): the port's and JAX's bf16 distances and the gate's limit."""
    ref, f32 = references
    d_port, d_jax = _distances(port, ref, start["init"]), _distances(start["jax"], ref, start["init"])
    d_f32 = _distances(f32, ref, start["init"])
    return {k: (d_port[k], d_jax[k], RATIO * d_jax[k] + FLOOR * d_f32[k]) for k in d_port}


def _passes(gate: dict) -> bool:
    """The upper gate on every distance, and the lower one: the heads' relative
    distances at least half JAX's, so that the step really rounded to bf16."""
    lower = all(p >= j / RATIO for k, (p, j, _) in gate.items() if k.startswith("head") and k.endswith("rel"))
    return lower and all(p <= lim for p, _, lim in gate.values())


def test_bf16_step_within_twice_jax_bf16_distance(start, references, capsys):
    gate = _gate(_port_runs(start, torch.bfloat16), start, references)
    with capsys.disabled():
        print("\n[bf16 step] distance from the f64 step, port bf16 / JAX bf16 (limit):")
        for k, (p, j, lim) in gate.items():
            print(f"  {k:16s} {p:.4g} / {j:.4g} (ratio {p / j:.3f}, limit {lim:.4g})")
    assert _passes(gate), gate


@pytest.mark.parametrize("fault", ["params_in_bf16", "computes_in_f32"])
def test_bf16_gate_catches_planted_faults(start, references, fault):
    """The control: the same step with the parameters held in bf16 (the
    update rounded to bf16 each step) or computing in f32 (the cast to bf16
    missing) fails the gate."""
    if fault == "params_in_bf16":
        runs = _port_runs(start, torch.bfloat16, torch.bfloat16)
    else:
        runs = _port_runs(start, torch.float32)
    assert not _passes(_gate(runs, start, references))
