"""Port parity: the JAX package's whole training state carried into the port.

One JAX yolov5n state (64 px, nc=10) after two jitted steps, so that its
SmartSGD momentum is non-zero, built once for the module. Checked:
  (a) ``flax_state_to_torch`` consumes every leaf (parameters, BatchNorm
      statistics, momentum, step), puts each head's momentum in the head
      conv as box | obj | cls, raises on an unknown leaf and on a momentum
      tree whose paths or shapes differ; ``torch_to_flax_state`` inverts
      it bitwise, into the tree Orbax restores without a target;
  (b) resume parity: from the converted state the port takes two more
      steps on the batches JAX takes from its own state, once inside the
      warmup (step 2) and once past it (step 150 > nw = 100): losses rtol
      1e-4, ``lr`` rel 1e-6, parameters and BatchNorm statistics atol 1e-5
      + rtol 1e-4 (``tests/test_torch_train.py``'s three steps). The
      momentum buffers hold whole gradients (the parameters move by lr
      times them), and JAX's own f32 buffers lie farther than that
      tolerance from JAX's f64 buffers of the same two steps (flax's
      one-pass batch variance, the early convs' kernels summed over every
      pixel), while the port's f32 buffers lie within it
      (``test_momentum_witness``). So each momentum element is held
      within atol 1e-5 + rtol 1e-4 (of that element) plus twice JAX's own
      largest distance, in that tensor, between its f32 and f64 buffers: a
      slack taken from JAX alone;
  (c) four planted faults fail (b): the momentum zeroed, the step reset to
      0, the head's momentum concatenated in another order, and the conv
      kernels' buffers updated without their weight decay (an optimizer
      fault that moves the parameters by less than their tolerance: only
      the momentum gate sees it);
  (d) the JAX ``CheckpointManager`` writes ``last`` and ``best`` as Orbax
      directories, ``tools/orbax_to_torch.py`` converts them, and the port's
      ``Trainer.from_config(... ckpt_path=...)`` starts at JAX's epoch
      ``step // steps_per_epoch`` with JAX's hyperparameters and its
      ``best_value``; an Orbax directory as ``ckpt_path`` raises naming the
      tool. A checkpoint of a JAX training option, the space-to-depth stem,
      converts to the plain stem's tensors and drives the port's network
      to the JAX option's outputs.
"""

import copy
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from object_detection_cib_torch.config import engine as t_engine
from object_detection_cib_torch.core.types import FeatureShape as TShape
from object_detection_cib_torch.core.types import default_anchors as t_anchors
from object_detection_cib_torch.models import convert
from object_detection_cib_torch.models.convert import flax_state_to_torch, torch_to_flax_state
from object_detection_cib_torch.models.yolov5 import build_network as t_build
from object_detection_cib_torch.train import optim as topt
from object_detection_cib_torch.train.checkpoint import apply_state, load_state
from object_detection_cib_torch.train.steps import Batch as TBatch, make_train_step as t_make_step
from object_detection_cib_torch.train.trainer import Trainer
from object_detection_cib_tpu.core.types import FeatureShape as JShape
from object_detection_cib_tpu.core.types import default_anchors as j_anchors
from object_detection_cib_tpu.models.yolov5 import build_network as j_build
from object_detection_cib_tpu.train import optim as jopt
from object_detection_cib_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from object_detection_cib_tpu.train.steps import Batch as JBatch, create_train_state
from object_detection_cib_tpu.train.steps import make_train_step as j_make_step

ROOT = Path(__file__).resolve().parents[1]
IMG, NC, B, TN, SPE = 64, 10, 4, 10, 10
CFG = topt.OptimizerConfig(max_epochs=30)  # nw = max(round(10 * 3.0), 100) = 100 steps of warmup
PAST = 150  # a step past the warmup, in epoch 15 of 30
RESUME = {"warmup": 2, "past_warmup": PAST}
SMALL = ["experiment=yv5n", "dataset_name=fake", "trainer=cpu", "model.net.dtype=null",
         "model.net.widen_factor=0.25", "data.batch_size=4", "data.target_image_size=64",
         "data.num_workers=1", "data.max_targets=40", "callbacks.model_summary=null", "logger=csv",
         "print_config=False", "model.net.stem_space_to_depth=false"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These small CPU runs gain little from torch's intra-op threads, and
    beside other test workers those threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(i: int):
    """Batch ``i``, numpy from seeds: images in [0, 1], boxes, labels, mask."""
    rng = np.random.default_rng(100 + i)
    boxes = np.zeros((B, TN, 4), np.float32)
    labels = np.zeros((B, TN), np.int32)
    mask = np.zeros((B, TN), bool)
    for b in range(B):
        for t in range(rng.integers(1, TN)):
            x, y = rng.uniform(0, IMG - 20, 2)
            w, h = rng.uniform(3, 40, 2)
            boxes[b, t] = [x, y, min(x + w, IMG - 1), min(y + h, IMG - 1)]
            labels[b, t] = rng.integers(0, NC)
            mask[b, t] = True
    images = rng.random((B, IMG, IMG, 3), np.float32)
    return images, boxes, labels, mask


def _jcfg(c: topt.OptimizerConfig) -> jopt.OptimizerConfig:
    w = None if c.warmup is None else jopt.WarmupParams(*c.warmup)
    return jopt.OptimizerConfig(*c[:-1], warmup=w)


def _restored(state) -> dict:
    """A JAX ``TrainState`` as Orbax restores it without a target."""
    return jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats,
                                     "opt_state": {"momentum_buf": state.opt_state.momentum_buf},
                                     "step": state.step})


@pytest.fixture(scope="module")
def run():
    """The JAX state after two steps, and for each resume point the state
    there, JAX's metrics of two more steps from it and the state after."""
    jnet = j_build(NC, "n")
    shape = JShape(IMG, IMG)
    jsgd = jopt.SmartSGD(_jcfg(CFG), SPE)
    state = create_train_state(jnet, jax.random.PRNGKey(0), shape, jsgd)
    jstep = jax.jit(j_make_step(jnet, j_anchors(), shape, jsgd))
    for i in range(2):
        state, _ = jstep(state, JBatch(*map(jnp.asarray, _batch(i))))
    resumed = {}
    for name, step in RESUME.items():
        s = state._replace(step=jnp.asarray(step, jnp.int32))
        start, metrics = _restored(s), []
        for i in (2, 3):
            s, m = jstep(s, JBatch(*map(jnp.asarray, _batch(i))))
            metrics.append({k: float(getattr(m, k)) for k in ("total", "box", "obj", "cls", "lr")})
        resumed[name] = (start, metrics, _restored(s), _jax_f64_momentum(jstep, s0=state, step=step))
    return {"state": state, "restored": _restored(state), "resumed": resumed}


def _jax_f64_momentum(jstep, s0, step: int) -> dict:
    """JAX's own two steps on batches 2 and 3 from ``s0`` at ``step``, in
    f64 (x64 on, every float leaf and input f64) -> its momentum buffers
    in the port's names and layout (f64 numpy)."""
    with jax.enable_x64(True):
        def f64(x):
            x = np.asarray(x)
            return jnp.asarray(x, jnp.float64) if np.issubdtype(x.dtype, np.floating) else jnp.asarray(x)

        s = jax.tree.map(f64, s0._replace(step=np.asarray(step, np.int32)))
        for i in (2, 3):
            s, _ = jstep(s, JBatch(*map(f64, _batch(i))))
        mom = jax.tree.map(np.asarray, s.opt_state.momentum_buf)
    assert all(v.dtype == np.float64 for v in jax.tree.leaves(mom))
    return convert._params_to_torch(mom, "momentum")


def _heads(net) -> list:
    return sorted(n[:-len(".conv.bias")] for n, _ in net.named_parameters() if n.endswith(".conv.bias"))


# ----------------------------------------------------------------- (a)

def test_every_leaf_is_consumed(run):
    s = run["restored"]
    ckpt = flax_state_to_torch(s)
    net = t_build(NC, "n", device="cpu")
    assert set(ckpt["net"]) == set(net.state_dict())
    assert set(ckpt["optimizer"]["momentum"]) == {n for n, _ in net.named_parameters()}
    assert ckpt["optimizer"]["step_count"] == 2 and type(ckpt["optimizer"]["step_count"]) is int

    def numel(tree):
        return sum(v.size for v in jax.tree.leaves(tree))

    stats = {k for k in ckpt["net"] if k.endswith(("running_mean", "running_var"))}
    assert numel(s["params"]) == sum(v.numel() for k, v in ckpt["net"].items() if k not in stats)
    assert numel(s["batch_stats"]) == sum(ckpt["net"][k].numel() for k in stats)
    assert numel(s["opt_state"]) == sum(v.numel() for v in ckpt["optimizer"]["momentum"].values())
    tsgd = topt.SmartSGD(net, CFG, SPE)
    apply_state(ckpt, net, tsgd)  # strict: no key missing or left over
    assert tsgd.step_count == 2 and all(b.abs().sum() > 0 for b in tsgd.buffers.values())


def test_head_momentum_is_box_obj_cls(run):
    s = run["restored"]
    mom = flax_state_to_torch(s)["optimizer"]["momentum"]
    heads = _heads(t_build(NC, "n", device="cpu"))
    assert len(heads) == 3
    for head in heads:
        leaves = s["opt_state"]["momentum_buf"]
        for part in head.split("."):
            leaves = leaves[part]
        kernel = np.concatenate([leaves[f"{p}_kernel"] for p in ("box", "obj", "cls")], -1)
        bias = np.concatenate([leaves[f"{p}_bias"] for p in ("box", "obj", "cls")])
        assert np.array_equal(mom[f"{head}.conv.weight"].numpy(), kernel.transpose(3, 2, 0, 1))
        assert np.array_equal(mom[f"{head}.conv.bias"].numpy(), bias)
        assert np.abs(bias).sum() > 0


def _first_leaf(tree: dict):
    """(the dict that holds the first leaf of ``tree`` in key order, its key)."""
    k = sorted(tree)[0]
    return _first_leaf(tree[k]) if isinstance(tree[k], dict) else (tree, k)


def _plant(s: dict, fault: str) -> None:
    mom = s["opt_state"]["momentum_buf"]
    if fault == "unknown parameter leaf":
        _first_leaf(s["params"])[0]["extra"] = np.zeros(1, np.float32)
    elif fault == "unknown batch stat":
        _first_leaf(s["batch_stats"])[0]["count"] = np.zeros(1, np.float32)
    elif fault == "unknown state key":
        s["rng"] = np.zeros(2, np.uint32)
    elif fault == "unknown optimizer key":
        s["opt_state"]["nu"] = mom
    elif fault == "momentum missing a leaf":
        d, k = _first_leaf(mom)
        del d[k]
    elif fault == "momentum with another path":
        mom["renamed"] = mom.pop(sorted(mom)[0])
    elif fault == "momentum of another shape":
        d, k = _first_leaf(mom)
        d[k] = np.zeros(1, np.float32)
    elif fault == "step not a scalar":
        s["step"] = np.zeros(2, np.int32)
    elif fault == "step not an integer":
        s["step"] = np.float32(2.0)


@pytest.mark.parametrize("fault", [
    "unknown parameter leaf", "unknown batch stat", "unknown state key", "unknown optimizer key",
    "momentum missing a leaf", "momentum with another path", "momentum of another shape",
    "step not a scalar", "step not an integer"])
def test_a_tree_that_is_not_a_train_state_raises(run, fault):
    s = copy.deepcopy(run["restored"])
    _plant(s, fault)
    with pytest.raises((KeyError, ValueError)):
        flax_state_to_torch(s)


def test_round_trip_is_bitwise_both_ways(run, tmp_path):
    s = run["restored"]
    back = torch_to_flax_state(flax_state_to_torch(s), NC)
    assert jax.tree.structure(back) == jax.tree.structure(s)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(s)):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    ckpt = flax_state_to_torch(s)
    again = flax_state_to_torch(torch_to_flax_state(ckpt, NC))
    assert again["optimizer"]["step_count"] == ckpt["optimizer"]["step_count"]
    for part in ("net", "momentum"):
        x = again["net"] if part == "net" else again["optimizer"]["momentum"]
        y = ckpt["net"] if part == "net" else ckpt["optimizer"]["momentum"]
        assert set(x) == set(y) and all(torch.equal(x[k], y[k]) for k in y)
    # the layout is the one Orbax restores without a target
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(tmp_path / "ck", run["state"])
    ckptr.wait_until_finished()
    got = jax.tree.map(np.asarray, ckptr.restore(tmp_path / "ck"))
    assert jax.tree.structure(got) == jax.tree.structure(back)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(back)))


# ----------------------------------------------------------------- (b), (c)

def _port_steps(ckpt: dict, dtype=torch.float32):
    """The port's two steps on batches 2 and 3 from ``ckpt``, in ``dtype``
    (in f64 the network, its BatchNorm and SmartSGD; the loss's own f32
    casts stay): -> (their metrics, the net, the optimizer)."""
    net = t_build(NC, "n", device="cpu").to(dtype)
    tsgd = topt.SmartSGD(net, CFG, SPE)
    apply_state(ckpt, net, tsgd)
    tstep = t_make_step(net, t_anchors(), TShape(IMG, IMG), tsgd)
    metrics = []
    for i in (2, 3):
        images, boxes, labels, mask = (torch.from_numpy(a) for a in _batch(i))
        metrics.append(tstep(TBatch(images.to(dtype), boxes.to(dtype), labels, mask)))
    return metrics, net, tsgd


def _resume(ckpt: dict, metrics: list, end: dict, jax64: dict) -> None:
    """Two port steps from ``ckpt`` against JAX's ``metrics`` and ``end``
    state; ``jax64``: JAX's f64 momentum from the same start."""
    got_metrics, net, tsgd = _port_steps(ckpt)
    for i, tm, want in zip((2, 3), got_metrics, metrics):
        for name in ("total", "box", "obj", "cls"):
            np.testing.assert_allclose(float(getattr(tm, name)), want[name], rtol=1e-4, err_msg=f"{name} step {i}")
        assert float(tm.lr) == pytest.approx(want["lr"], rel=1e-6), f"lr step {i}"
    want = flax_state_to_torch(end)
    got = net.state_dict()
    for name, v in want["net"].items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
    worst, widest = (0.0, ""), (0.0, "")
    for name, v in want["optimizer"]["momentum"].items():
        j = v.numpy().astype(np.float64)
        jax_gap = np.abs(j - jax64[name]).max()
        got = tsgd.buffers[name].numpy()
        worst = max(worst, ((np.abs(got - j) / (1e-5 + 2 * jax_gap + 1e-4 * np.abs(j))).max(), name))
        widest = max(widest, (jax_gap, name))
        np.testing.assert_allclose(got, j, atol=1e-5 + 2 * jax_gap, rtol=1e-4,
                                   err_msg=f"momentum {name}: JAX's f32 lies {jax_gap} from its f64")
    print(f"momentum: worst share of its limit {worst[0]:.4f} ({worst[1]}); JAX's f32 at most "
          f"{widest[0]:.3g} from its f64 ({widest[1]})")
    assert tsgd.step_count == want["optimizer"]["step_count"]


def test_momentum_witness(run):
    """The measurement behind (b)'s momentum gate: JAX's f32 buffers lie
    outside atol 1e-5 + rtol 1e-4 of JAX's f64 buffers (so the gate needs
    JAX's own slack), the port's f32 buffers inside it, and the port's f64
    buffers agree with JAX's f64 ones to atol 1e-7 + rtol 1e-6."""
    start, _, end, jax64 = run["resumed"]["warmup"]
    _, _, tsgd = _port_steps(flax_state_to_torch(start))
    _, _, exact = _port_steps(flax_state_to_torch(start), torch.float64)
    jax_mom = flax_state_to_torch(end)["optimizer"]["momentum"]

    def outside(buffers, atol=1e-5, rtol=1e-4):
        return [k for k, v in buffers.items()
                if (np.abs(v.numpy().astype(np.float64) - jax64[k]) > atol + rtol * np.abs(jax64[k])).any()]

    port_out, jax_out = outside(tsgd.buffers), outside(jax_mom)
    print(f"tensors outside atol 1e-5 + rtol 1e-4 of JAX's f64 momentum: port {port_out}, JAX {jax_out}; "
          f"the port's f64 at most {max(np.abs(v.numpy() - jax64[k]).max() for k, v in exact.buffers.items()):.3g} "
          f"from JAX's f64")
    assert not port_out and jax_out
    assert not outside(exact.buffers, 1e-7, 1e-6)


@pytest.mark.parametrize("at", list(RESUME))
def test_resume_matches_jax(run, at):
    start, metrics, end, jax64 = run["resumed"][at]
    assert int(start["step"]) == RESUME[at]
    assert (RESUME[at] <= topt.SmartSGD(t_build(NC, "n", device="cpu"), CFG, SPE).nw) == (at == "warmup")
    _resume(flax_state_to_torch(start), metrics, end, jax64)


def _zero_momentum(ckpt, start, monkeypatch):
    ckpt["optimizer"]["momentum"] = {k: torch.zeros_like(v) for k, v in ckpt["optimizer"]["momentum"].items()}


def _step_zero(ckpt, start, monkeypatch):
    ckpt["optimizer"]["step_count"] = 0


def _head_order(ckpt, start, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(convert, "_HEAD_PARTS", ("cls", "obj", "box"))
        ckpt["optimizer"]["momentum"] = convert._tensors(
            convert._params_to_torch(start["opt_state"]["momentum_buf"]))
    heads = [f"{h}.conv.weight" for h in _heads(t_build(NC, "n", device="cpu"))]
    right = flax_state_to_torch(start)["optimizer"]["momentum"]
    assert all(ckpt["optimizer"]["momentum"][h].shape == right[h].shape for h in heads)


def _decay_lost(ckpt, start, monkeypatch):
    """The conv kernels' buffers put in the BatchNorm group: updated without
    their weight decay, in every dtype the port runs."""
    group_params = topt.group_params
    monkeypatch.setattr(topt, "group_params", lambda net: {
        k: topt.GROUP_NORM if g == topt.GROUP_DECAY else g for k, g in group_params(net).items()})


FAULTS = {"momentum_zeroed": (_zero_momentum, None), "step_reset_to_0": (_step_zero, None),
          "head_momentum_reordered": (_head_order, None), "kernels_without_weight_decay": (_decay_lost, "momentum")}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fail_the_resume(run, fault, monkeypatch):
    start, metrics, end, jax64 = run["resumed"]["past_warmup"]
    ckpt = flax_state_to_torch(start)
    plant, match = FAULTS[fault]
    plant(ckpt, start, monkeypatch)
    with pytest.raises(AssertionError, match=match):
        _resume(ckpt, metrics, end, jax64)


# ----------------------------------------------------------------- (d)

def _tool():
    spec = importlib.util.spec_from_file_location("orbax_to_torch", ROOT / "tools" / "orbax_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_orbax_checkpoints_resume_through_from_config(run, tmp_path, capsys):
    step, best = 37, 0.375  # 16 steps an epoch (64 fake images, B=4): epoch 2
    state = run["state"]._replace(step=jnp.asarray(step, jnp.int32))
    jck = JCheckpointManager(tmp_path / "jax" / "checkpoints")
    jck.save_last(state)
    assert jck.maybe_save_best(state, {"map": best})
    jck.wait_until_finished()
    meta = json.loads((tmp_path / "jax" / "checkpoints" / "meta.json").read_text())
    assert meta["best_value"] == best

    out = tmp_path / "port"
    tool = _tool()
    for name in ("last", "best"):
        assert tool.main([str(tmp_path / "jax" / "checkpoints" / name), str(out / "checkpoints" / name)]) == 0
    assert "meta.json carried" in capsys.readouterr().out
    want = flax_state_to_torch(_restored(state))
    for name in ("last", "best"):
        got = load_state(out / "checkpoints" / name)
        assert got["optimizer"]["step_count"] == step
        assert all(torch.equal(got["net"][k], v) for k, v in want["net"].items())
        assert all(torch.equal(got["optimizer"]["momentum"][k], v) for k, v in want["optimizer"]["momentum"].items())

    def compose(*extra):
        return t_engine.compose(ROOT / "configs", "train", SMALL + [f"paths.output_dir={out}", *extra])

    with pytest.raises(IsADirectoryError, match="tools/orbax_to_torch.py"):
        Trainer.from_config(compose(f"ckpt_path={tmp_path / 'jax' / 'checkpoints' / 'last'}"))
    t = Trainer.from_config(compose(f"ckpt_path={out / 'checkpoints' / 'last'}"))
    assert t.steps_per_epoch == 16
    assert t.epoch == step // t.steps_per_epoch == 2  # JAX trainer.py:984-985
    assert t.ckpt.best_value == meta["best_value"]
    assert t.optimizer.step_count == step
    assert all(torch.equal(v, want["net"][k]) for k, v in t.net.state_dict().items())
    assert all(torch.equal(v, want["optimizer"]["momentum"][k]) for k, v in t.optimizer.buffers.items())
    jsgd = jopt.SmartSGD(_jcfg(t.optimizer.config), t.steps_per_epoch)
    hp = t.optimizer.hyper_table(t.optimizer.step_count, 1)[0].tolist()
    assert hp == pytest.approx([float(v) for v in jsgd.hyperparams(jnp.asarray(step, jnp.int32))], rel=1e-6)


def test_space_to_depth_stem_checkpoint_converts_unchanged(run, tmp_path):
    """A checkpoint of a JAX training option, the space-to-depth stem: its
    state is the plain stem's tree, so the tool converts it to the plain
    stem's tensors, and the port's network from them gives the JAX option's
    outputs (``tests/test_torch_model.py``'s tolerance, 1e-4)."""
    shape, jsgd = JShape(IMG, IMG), jopt.SmartSGD(_jcfg(CFG), SPE)
    s2d_net = j_build(NC, "n", stem_space_to_depth=True)
    s2d = create_train_state(s2d_net, jax.random.PRNGKey(0), shape, jsgd)._replace(step=jnp.asarray(37, jnp.int32))
    plain = create_train_state(j_build(NC, "n"), jax.random.PRNGKey(0), shape, jsgd)._replace(step=s2d.step)
    jck = JCheckpointManager(tmp_path / "jax" / "checkpoints")
    jck.save_last(s2d)
    jck.wait_until_finished()
    out = tmp_path / "port" / "checkpoints" / "last"
    assert _tool().main([str(tmp_path / "jax" / "checkpoints" / "last"), str(out)]) == 0
    got, want = load_state(out), flax_state_to_torch(_restored(plain))
    assert got["optimizer"]["step_count"] == 37
    for part in ("net", "momentum"):
        x = got["net"] if part == "net" else got["optimizer"]["momentum"]
        y = want["net"] if part == "net" else want["optimizer"]["momentum"]
        assert set(x) == set(y) and all(torch.equal(x[k], y[k]) for k in y), part

    images = np.random.default_rng(7).random((2, IMG, IMG, 3), np.float32)
    jout = jax.jit(lambda v, x: s2d_net.apply(v, x, train=False))(
        {"params": s2d.params, "batch_stats": s2d.batch_stats}, images)
    net = t_build(NC, "n", device="cpu")
    net.load_state_dict(got["net"], strict=True)
    with torch.no_grad():
        tout = net.eval()(torch.from_numpy(images))
    for tl, jl in zip(tout.levels(), jout.levels()):
        np.testing.assert_allclose(tl.raw.numpy(), np.asarray(jl.raw), atol=1e-4, rtol=1e-4)

    t = Trainer.from_config(t_engine.compose(ROOT / "configs", "train", SMALL + [
        f"paths.output_dir={tmp_path / 'port'}", "model.net.stem_space_to_depth=true", f"ckpt_path={out}"]))
    assert t.optimizer.step_count == 37 and t.epoch == 37 // t.steps_per_epoch == 2
    assert all(torch.equal(v, want["net"][k]) for k, v in t.net.state_dict().items())
