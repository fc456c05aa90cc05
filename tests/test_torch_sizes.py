"""Port parity at yolov5m and yolov5l, the sizes the other parity tests do
not build. yolov5l is the default network (``configs/nn/networks/yv5.yaml``:
deepen 1.0, widen 1.0), the one ``cli.train`` builds without ``experiment=``;
yolov5m is spelled ``model.net.deepen_factor=0.67
model.net.widen_factor=0.75``. Its C3 stacks hold 2/4/6/2 (m) and 3/6/9/3
(l) bottlenecks and its widths reach 768 and 1024 channels.

On the CPU, f32 on both sides, torch held to one thread. Tolerances:
  * the parameter counts at nc 10 and 80, and every converted key and
    shape: exact, against the JAX package's ``build_network`` (the shapes of
    its ``init``, evaluated abstractly);
  * the forward from converted flax variables, with randomised BatchNorm
    statistics as in ``tests/test_torch_model.py``, at 64 px, B=2: in eval
    mode that file's atol/rtol 1e-4; in train mode, where f32 rounding
    alone passes 1e-4 at these depths, the port's f64 forward within 1e-9
    of JAX's f64 one and the port's f32 forward within 1e-4 plus twice
    JAX's own f32 distance of JAX's f64 one (measured and argued at
    ``test_train_forward_and_running_stats_match_flax``). The train-mode
    references run flax's two-pass batch variance: flax's default
    ``E[x^2] - E[x]^2`` in f32 loses digits where a channel's mean is large
    against its spread
    (``tests/test_torch_runtime.py::test_f64_step_backs_the_two_pass_reference``);
  * one training step of the default network through ``Trainer.from_config``
    against the JAX ``Trainer(cfg)`` at ``tests/test_torch_runtime.py``'s
    small overrides without ``experiment=yv5n`` and its widen override (64
    px, B=2, f32, the plain stem, fake images seeded by a stable digest of
    the sample id, flax's two-pass variance): the first host-fed batch
    byte-equal, the losses rtol 1e-4 of JAX's f32 step, every parameter and
    BatchNorm statistic after the step atol 1e-5 + rtol 1e-4 (that file's)
    of JAX's step run in f64 (x64 on, every float leaf and input f64). At
    l's depth JAX's own f32 step lies outside that tolerance of its f64 step
    (measured on an x86-64 CPU: 21 tensors, up to 6.4x the tolerance, the
    stem's BatchNorm bias and early running means, whose updates are small
    differences), while the port's f32 step lies inside it (worst 0.59x),
    so the f32 steps cannot be held to each other at it;
    ``test_default_network_step_matches_jax`` asserts that order too;
  * the whole training state of yolov5l (parameters, BatchNorm statistics,
    momentum, step) through ``models/convert.py``'s ``flax_state_to_torch``
    and ``torch_to_flax_state``: bitwise both ways;
  * a head of another anchor count (``num_anchors_per_cell=2``): split into
    JAX's box | obj | cls leaves of that count, bitwise back, and refused
    by the converter told three anchors a cell.
"""

import hashlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_cib_torch.config import engine as t_engine
from object_detection_cib_torch.models import convert
from object_detection_cib_torch.models.convert import flax_state_to_torch, flax_to_torch, torch_to_flax_state
from object_detection_cib_torch.models.yolov5 import build_network as t_build
from object_detection_cib_torch.train.trainer import Trainer
from object_detection_cib_tpu.config import engine as j_engine
from object_detection_cib_tpu.models.yolov5 import build_network as j_build
from object_detection_cib_tpu.train.trainer import Trainer as JTrainer

ROOT = Path(__file__).resolve().parents[1]
IMG, BATCH, NC = 64, 2, 10
ATOL = RTOL = 1e-4
SIZES = {"m": ("model.net.deepen_factor=0.67", "model.net.widen_factor=0.75"), "l": ()}
# tests/test_torch_runtime.py's SMALL without experiment=yv5n and model.net.widen_factor=0.25, at B=2
DEFAULT_NET = ["dataset_name=fake", "trainer=cpu", "model.net.dtype=null", "data.batch_size=2",
               "data.target_image_size=64", "data.num_workers=1", "data.max_targets=40",
               "callbacks.model_summary=null", "logger=csv", "print_config=False",
               "model.net.stem_space_to_depth=false", "model.val_nms_max_candidates=256"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These small CPU runs gain little from torch's intra-op threads, and
    beside other test workers those threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _two_pass_variance(mp: pytest.MonkeyPatch):
    """flax's BatchNorm with its two-pass batch variance while ``mp`` lives."""
    import flax.linen.normalization as fnorm

    stats = fnorm._compute_stats
    mp.setattr(fnorm, "_compute_stats", lambda *a, **k: stats(*a, **{**k, "use_fast_variance": False}))


def _stable_hash(key) -> int:
    """A digest of the sample id, the same in every process (``hash`` of a
    ``str`` is salted per process), for the fake images of both readers."""
    return int.from_bytes(hashlib.blake2b(str(key).encode(), digest_size=8).digest(), "little")


def _abstract_variables(size: str, nc: int, **kw):
    jnet = j_build(nc, size, **kw)
    return jax.eval_shape(lambda k, x: jnet.init(k, x, train=False), jax.random.PRNGKey(0),
                          jnp.zeros((1, IMG, IMG, 3)))


def _randomise_stats(variables, seed: int = 0) -> dict:
    """``tests/test_torch_model.py``'s: the running statistics drawn, so that
    BatchNorm's conversion is exercised."""
    rng = np.random.default_rng(seed)

    def randomise(path, v):
        if path[-1].key == "mean":
            return rng.normal(0, 0.2, v.shape).astype(np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        return v

    variables = jax.tree.map(np.asarray, variables)
    return {"params": variables["params"],
            "batch_stats": jax.tree_util.tree_map_with_path(randomise, variables["batch_stats"])}


# ------------------------------------------------------- counts and keys

@pytest.mark.parametrize("nc", [10, 80])
@pytest.mark.parametrize("size", ["m", "l"])
def test_param_count_and_converted_keys_match_jax(size, nc):
    abstract = _abstract_variables(size, nc)
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(abstract["params"]))
    net = t_build(nc, size, device="cpu")
    assert sum(p.numel() for p in net.parameters()) == want
    sd = flax_to_torch(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), abstract))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in net.state_dict().items()}


# ------------------------------------------------- the default network, one step

@pytest.fixture(scope="module")
def default_pair(tmp_path_factory):
    """The JAX ``Trainer(cfg)`` and the port's ``Trainer.from_config(cfg)`` of
    the default network, the JAX initial variables as numpy copies, and
    one train step of each from them on the first host-fed batch."""
    from object_detection_cib_torch.data import reader as t_reader
    from object_detection_cib_tpu.data import reader as j_reader

    root = tmp_path_factory.mktemp("default_net")
    overrides = [*DEFAULT_NET, f"paths.output_dir={root / 'jax'}"]
    jcfg = j_engine.compose(ROOT / "configs", "train", overrides)
    assert t_engine.compose(ROOT / "configs", "train", overrides) == jcfg
    with pytest.MonkeyPatch.context() as mp:
        for mod in (t_reader, j_reader):
            mp.setattr(mod, "hash", _stable_hash, raising=False)
        _two_pass_variance(mp)
        jt = JTrainer(jcfg)
        t = Trainer.from_config(t_engine.compose(ROOT / "configs", "train",
                                                 [*DEFAULT_NET, f"paths.output_dir={root / 'port'}"]))
        state = jt.state
        init_state = jax.tree.map(lambda a: np.array(a, copy=True), state)  # the jitted step donates ``state``
        init = jax.tree.map(lambda a: np.array(a, copy=True), {"params": state.params,
                                                                "batch_stats": state.batch_stats})
        t.net.load_state_dict(flax_to_torch(init))
        feed = iter(jt._train_prefetcher())
        jb = jax.tree.map(lambda a: np.array(a, copy=True), next(feed))
        feed.close()
        tb, _ = next(t._train_batches(1))
        tb = type(tb)(*(x.clone() for x in tb))
        jstate, jm = jt.train_step(state, jb)
        tm = t.train_step(tb)
        with jax.enable_x64(True):
            # a new function to trace: jit caches the f32 trace of ``_train_step_raw``
            js64, jm64 = jax.jit(lambda s, b: jt._train_step_raw(s, b))(*jax.tree.map(_f64, (init_state, jb)))
            f64 = _state_dict(js64)
        assert all(v.dtype == np.float64 for v in f64.values())
        yield dict(jt=jt, t=t, init=init, jb=jb, tb=tb, jm=jm, tm=tm, jstate=jstate, jm64=jm64, f64=f64)


def _f64(x):
    x = np.asarray(x)
    return jnp.asarray(x, jnp.float64) if np.issubdtype(x.dtype, np.floating) else jnp.asarray(x)


def _state_dict(jstate) -> dict:
    """The port's ``state_dict`` of a JAX train state's parameters and
    BatchNorm statistics as numpy arrays of their own dtype."""
    return _named({"params": jstate.params, "batch_stats": jstate.batch_stats})


def _named(variables) -> dict:
    """flax variables -> the port's names, numpy arrays of their own dtype
    (``flax_to_torch`` casts to f32)."""
    tree = jax.tree.map(np.asarray, variables)
    sd = convert._params_to_torch(tree["params"])
    for path, v in convert._flatten(tree["batch_stats"]).items():
        sd[".".join(path[:-1] + (convert._BN_STATS[path[-1]],))] = v
    return sd


def _worst_share_of_tolerance(got: dict, ref: dict) -> float:
    """max over every element of |got - ref| / (1e-5 + 1e-4 |ref|): 1 is the
    edge of the tolerance."""
    return max(float((np.abs(got[k].astype(np.float64) - r) / (1e-5 + 1e-4 * np.abs(r))).max())
               for k, r in ref.items())


def test_default_network_is_yolov5l(default_pair):
    jt, t = default_pair["jt"], default_pair["t"]
    assert (jt.net.deepen_factor, jt.net.widen_factor) == (1.0, 1.0)
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(default_pair["init"]["params"]))
    assert sum(p.numel() for p in t.net.parameters()) == want == sum(
        p.numel() for p in t_build(NC, "l", device="cpu").parameters())


def test_default_network_step_matches_jax(default_pair):
    jb, tb, jm, tm = (default_pair[k] for k in ("jb", "tb", "jm", "tm"))
    for name in ("images", "boxes", "labels", "mask"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)
    for name in ("total", "box", "obj", "cls"):
        np.testing.assert_allclose(float(getattr(tm, name)), float(getattr(jm, name)), rtol=1e-4, err_msg=name)
    assert tm.lr == pytest.approx(float(jm.lr), rel=1e-6)
    assert int(tm.assign_drop) == int(jm.assign_drop) == 0
    for name in ("total", "box", "obj", "cls"):
        np.testing.assert_allclose(float(getattr(tm, name)), float(getattr(default_pair["jm64"], name)), rtol=1e-4,
                                   err_msg=name)
    want = default_pair["f64"]
    got = {k: v.detach().numpy() for k, v in default_pair["t"].net.state_dict().items()}
    assert set(got) == set(want)
    for name, v in want.items():
        np.testing.assert_allclose(got[name], v, atol=1e-5, rtol=1e-4, err_msg=name)
    jstate = default_pair["jstate"]
    err = {"port": _worst_share_of_tolerance(got, want), "jax_f32": _worst_share_of_tolerance(_state_dict(jstate), want)}
    print(f"worst |step - JAX's f64 step| / (1e-5 + 1e-4 |f64 step|): {err}")
    assert err["jax_f32"] > err["port"], err
    assert default_pair["t"].optimizer.step_count == int(jstate.step) == 1


def test_training_state_round_trip_is_bitwise_at_l(default_pair):
    """JAX's state after the step (momentum live) through the port's layout
    and back, and the port's own checkpoint through JAX's and back."""
    jstate = default_pair["jstate"]
    s = jax.tree.map(np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats,
                                  "opt_state": {"momentum_buf": jstate.opt_state.momentum_buf},
                                  "step": jstate.step})
    back = torch_to_flax_state(flax_state_to_torch(s), NC)
    assert jax.tree.structure(back) == jax.tree.structure(s)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(s)):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    t = default_pair["t"]
    ckpt = {"net": t.net.state_dict(), "optimizer": t.optimizer.state_dict()}
    again = flax_state_to_torch(torch_to_flax_state(ckpt, NC))
    assert again["optimizer"]["step_count"] == ckpt["optimizer"]["step_count"] == 1
    for x, y in ((again["net"], ckpt["net"]), (again["optimizer"]["momentum"], ckpt["optimizer"]["momentum"])):
        assert set(x) == set(y) and all(torch.equal(x[k], y[k]) for k in y)
    assert any(bool(v.abs().sum() > 0) for v in ckpt["optimizer"]["momentum"].values())


# ---------------------------------------------------------------- forward

@pytest.fixture(scope="module", params=list(SIZES))
def flax_sized(request):
    """(flax network, variables with randomised statistics, images) at m,
    from a jitted ``init``; at l, the default network's JAX trainer's."""
    images = np.random.default_rng(1).random((BATCH, IMG, IMG, 3), np.float32)
    if request.param == "l":
        pair = request.getfixturevalue("default_pair")
        return pair["jt"].net, _randomise_stats(pair["init"]), images
    jnet = j_build(NC, request.param)
    variables = jax.jit(lambda k, x: jnet.init(k, x, train=False))(jax.random.PRNGKey(0),
                                                                   jnp.zeros((1, IMG, IMG, 3)))
    return jnet, _randomise_stats(variables), images


def _port(variables, jnet) -> torch.nn.Module:
    net = t_build(NC, {"deepen_factor": jnet.deepen_factor, "widen_factor": jnet.widen_factor}, device="cpu")
    net.load_state_dict(flax_to_torch(variables), strict=True)
    return net


def _assert_heads_close(t_out, j_out):
    for tl, jl in zip(t_out.levels(), j_out.levels()):
        assert tuple(tl.raw.shape) == jl.raw.shape
        np.testing.assert_allclose(tl.raw.detach().numpy(), np.asarray(jl.raw), atol=ATOL, rtol=RTOL)


def test_eval_forward_matches_flax(flax_sized):
    jnet, variables, images = flax_sized
    want = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(variables, images)
    with torch.no_grad():
        got = _port(variables, jnet).eval()(torch.from_numpy(images))
    _assert_heads_close(got, want)


def _train_forward(jnet, variables, images, dtype):
    """JAX's train-mode heads and new running statistics (the port's names),
    in ``dtype``: f64 with x64 on and every float leaf and input f64."""
    with jax.enable_x64(dtype == np.float64):
        cast = lambda a: jnp.asarray(a, dtype)  # noqa: E731
        # a new function to trace: jit caches the trace of an earlier lambda
        out, mutated = jax.jit(lambda v, x: jnet.apply(v, x, train=True, mutable=["batch_stats"]))(
            jax.tree.map(cast, variables), cast(images))
        heads = [np.asarray(level.raw, np.float64) for level in out.levels()]
        stats = _named({"params": {}, "batch_stats": mutated["batch_stats"]})
    return heads, {k: np.asarray(v, np.float64) for k, v in stats.items()}


def _port_train_forward(variables, jnet, images, dtype):
    net = _port(variables, jnet).to(dtype).train()
    with torch.no_grad():
        heads = [level.raw.double().numpy() for level in net(torch.from_numpy(images).to(dtype)).levels()]
    return heads, {k: v.double().numpy() for k, v in net.state_dict().items() if k.endswith(("_mean", "_var"))}


def test_train_forward_and_running_stats_match_flax(flax_sized, monkeypatch):
    """In train mode f32 rounding alone passes 1e-4 at these depths: at 64
    px, B=2, the deepest stages' BatchNorm takes its statistics over 8
    values a channel, and dividing by their small spread magnifies the
    rounding of every layer before it (measured on an x86-64 CPU, the largest
    distance of JAX's and the port's f32 heads from JAX's f64 heads: m
    1.91e-4 and 2.04e-4, l 5.50e-4 and 6.95e-4; eval mode stays inside
    1e-4; the port's f64 heads lie within 1e-12 of JAX's). So the port's
    f64 forward is held to JAX's f64 forward within 1e-9, and the port's f32
    forward to JAX's f64 one within the file's tolerance plus twice JAX's
    own f32 distance from it, per head and per statistic."""
    jnet, variables, images = flax_sized
    _two_pass_variance(monkeypatch)
    ref_heads, ref_stats = _train_forward(jnet, variables, images, np.float64)
    j32_heads, j32_stats = _train_forward(jnet, variables, images, np.float32)
    p64_heads, p64_stats = _port_train_forward(variables, jnet, images, torch.float64)
    p32_heads, p32_stats = _port_train_forward(variables, jnet, images, torch.float32)
    assert set(p32_stats) == set(ref_stats)
    for got, ref in zip(p64_heads, ref_heads):
        np.testing.assert_allclose(got, ref, atol=1e-9, rtol=1e-9)
    for k, ref in ref_stats.items():
        np.testing.assert_allclose(p64_stats[k], ref, atol=1e-9, rtol=1e-9, err_msg=k)
    worst = {}
    for i, (got, j32, ref) in enumerate(zip(p32_heads, j32_heads, ref_heads)):
        slack = 2 * float(np.abs(j32 - ref).max())
        worst[f"head {i}"] = (float(np.abs(got - ref).max()), slack / 2)
        np.testing.assert_allclose(got, ref, atol=ATOL + slack, rtol=RTOL, err_msg=f"head {i}")
    for k, ref in ref_stats.items():
        slack = 2 * float(np.abs(j32_stats[k] - ref).max())
        np.testing.assert_allclose(p32_stats[k], ref, atol=1e-5 + slack, rtol=1e-4, err_msg=k)
    print(f"train-mode heads, (port f32, JAX f32) largest distance from JAX f64: {worst}")


# ------------------------------------------------ another anchor count (C.4)

def test_heads_of_two_anchors_a_cell_round_trip_and_three_are_refused():
    """A network of ``num_anchors_per_cell=2``: its state goes to JAX's
    layout of a two-anchor network (every path and shape of JAX's, each
    head's box | obj | cls of 8 | 2 | 20 outputs), bitwise back; the
    converter told three anchors a cell (its default) refuses the heads,
    whose 30 outputs a fixed split would cut into 12 | 3 | 15."""
    net = t_build(NC, "n", num_anchors_per_cell=2, device="cpu")
    rng = np.random.default_rng(0)
    sd = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)) for k, v in net.state_dict().items()}
    momentum = {k: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
                for k, p in net.named_parameters()}
    ckpt = {"net": sd, "optimizer": {"step_count": 7, "momentum": momentum}}
    flax = torch_to_flax_state(ckpt, NC, num_anchors_per_cell=2)
    abstract = _abstract_variables("n", NC, num_anchors_per_cell=2)
    for tree in (flax["params"], flax["opt_state"]["momentum_buf"]):
        assert jax.tree.structure(tree) == jax.tree.structure(abstract["params"])
        assert [a.shape for a in jax.tree.leaves(tree)] == [a.shape for a in jax.tree.leaves(abstract["params"])]
    assert [flax["params"]["ll_head"][f"{p}_bias"].shape[0] for p in ("box", "obj", "cls")] == [8, 2, 20]
    back = flax_state_to_torch(flax)
    assert back["optimizer"]["step_count"] == 7
    for x, y in ((back["net"], sd), (back["optimizer"]["momentum"], momentum)):
        assert set(x) == set(y) and all(torch.equal(x[k], y[k]) for k in y)
    with pytest.raises(ValueError, match="num_anchors_per_cell=3"):
        torch_to_flax_state(ckpt, NC)
    with pytest.raises(ValueError, match="num_classes=9"):
        torch_to_flax_state(ckpt, 9, num_anchors_per_cell=2)
