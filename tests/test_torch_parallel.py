"""Port parity: data-parallel training and validation over ranks (the JAX
package's ``parallel/`` and its single-process mesh).

Two gloo ranks on the CPU (three for the sharded corpus's uneven case),
spawned by the port's launcher (``parallel/distributed.py:launch``) with a
free port, an ``init_process_group`` timeout of 60 s and a join timeout;
each rank holds torch to one thread. yolov5n at 64 px, a global batch of 4
(6 over three ranks). One spawn of each group size runs every rank-side
check (``_rank_checks``); the tests read its results. Tolerances:
  * the helpers, ``shard_indices``/``FixedSampler`` and the rank layout
    against the JAX functions' contracts: exact;
  * each rank's batches against the rows of the 1-rank batches: bitwise,
    for the device pipeline with the corpus on the card and host-fed, and
    the host pipeline, each with mosaic, with mixup 0.5 and without mosaic;
    the sharded corpus against the replicated one: bitwise;
  * three steps at 2 ranks against 1 rank at the same global batch, in
    f64: every parameter and BatchNorm statistic rtol 1e-9 (atol 1e-12 for
    values at 0). The loss is computed in f32 by design (``train/loss.py``
    casts to f32, as the JAX loss does), so the losses, which sum in
    another order over two ranks, agree to rtol 1e-6. A per-rank mean in
    place of the global reductions is off by O(1)
    (``test_local_reductions_would_be_caught``). In f32: losses rtol 1e-4,
    parameters and BatchNorm statistics atol 1e-5 + rtol 1e-4
    (``tests/test_torch_train.py``'s);
  * one 2-rank step against JAX's step on a 2-device mesh
    (``jit_train_step(..., make_mesh(2))``) from converted weights on the
    same batch, JAX with flax's two-pass variance: the f32 tolerances;
  * the BatchNorm autograd function against autograd of the 1-rank module
    on the concatenated batch, f64: rtol 1e-10, atol 1e-12;
  * the merged 2-rank ``results_dict`` and predictions against 1 rank's:
    equal;
  * ``cli.train.main`` with ``trainer.num_devices=2``: the run files once,
    the checkpoint restored bitwise on both ranks.
"""

import hashlib
import math
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_cib_torch.cli import train as t_cli
from object_detection_cib_torch.config import engine as t_engine
from object_detection_cib_torch.core.types import FeatureShape, default_anchors
from object_detection_cib_torch.data import device_pipeline as tdp
from object_detection_cib_torch.data import reader as t_reader
from object_detection_cib_torch.data import samplers as tsamplers
from object_detection_cib_torch.data.host_augment import AugParams
from object_detection_cib_torch.data.synthetic import build_fake_manifest
from object_detection_cib_torch.models.convert import flax_to_torch
from object_detection_cib_torch.models.layers import BatchNorm, sync_batchnorm
from object_detection_cib_torch.models.yolov5 import build_network
from object_detection_cib_torch.parallel import distributed as tdist
from object_detection_cib_torch.parallel import mesh as tmesh
from object_detection_cib_torch.train import checkpoint as tck
from object_detection_cib_torch.train.optim import OptimizerConfig, SmartSGD
from object_detection_cib_torch.train.steps import Batch, make_train_step
from object_detection_cib_torch.train.trainer import Trainer, num_devices_from_cfg
from object_detection_cib_tpu.core.types import default_anchors as j_anchors
from object_detection_cib_tpu.data import samplers as jsamplers
from object_detection_cib_tpu.models.yolov5 import build_network as j_build
from object_detection_cib_tpu.parallel import distributed as jdist
from object_detection_cib_tpu.parallel import mesh as jmesh
from object_detection_cib_tpu.train import optim as jopt
from object_detection_cib_tpu.train.steps import Batch as JBatch
from object_detection_cib_tpu.train.steps import create_train_state, jit_train_step
from object_detection_cib_tpu.train.steps import make_train_step as j_make_step

ROOT = Path(__file__).resolve().parents[1]
S, B, NC, STEPS = 64, 4, 3, 3
N_TRAIN, N_VAL = 24, 10
TIMEOUT, JOIN = 60, 300  # init_process_group's timeout; the whole spawn's


def _stable_hash(key) -> int:
    """A digest of the sample id, the same in every process (``hash`` of a
    ``str`` is salted per process), for the host reader's fake images."""
    return int.from_bytes(hashlib.blake2b(str(key).encode(), digest_size=8).digest(), "little")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_reader, "hash", _stable_hash, raising=False)
        yield
    torch.set_num_threads(n)


def _infos(n_train=N_TRAIN):
    return (build_fake_manifest(num_images=n_train, num_classes=NC, image_size=S, seed=2),
            build_fake_manifest(num_images=N_VAL, num_classes=NC, image_size=S, seed=1))


def _np(batch) -> dict:
    return {k: v.numpy().copy() for k, v in batch._asdict().items()}


# --------------------------------------------------------- what a rank runs

def _steps(mesh, dtype, seed=3, sharding="replicated", n=STEPS):
    """``n`` steps of the step loop over the corpus on the card with mosaic
    and mixup 0.5: (metrics summed over the ranks per step, state, batches)."""
    info, _ = _infos()
    pipe = tdp.DeviceDataPipeline(info, S, B, AugParams(), max_targets=40, seed=seed, device="cpu",
                                  feed_dtype=dtype, mesh=mesh, corpus_sharding=sharding, mixup_prob=0.5)
    net = build_network(NC, "n", device="cpu", seed=5).to(dtype)
    step = make_train_step(net, default_anchors(), FeatureShape(S, S), SmartSGD(net, OptimizerConfig(), 6),
                           mesh=mesh)
    ms, batches = [], []
    for batch, _ in pipe.epoch(n):
        batches.append(_np(batch))
        m = step(batch)
        v = torch.stack([m.total, m.box, m.obj, m.cls, m.assign_drop.to(m.total.dtype)]).double()
        if mesh is not None:
            tdist.all_reduce_sum_(v, mesh.group)
        ms.append(v.numpy())
    return dict(metrics=np.array(ms), batches=batches,
                state={k: v.detach().double().numpy().copy() for k, v in net.state_dict().items()})


def _fused_steps(mesh, dtype=torch.float32, seed=3, n=STEPS):
    """The same as ``_steps`` through the fused epoch (eager on the CPU)."""
    info, _ = _infos()
    pipe = tdp.DeviceDataPipeline(info, S, B, AugParams(), max_targets=40, seed=seed, device="cpu",
                                  feed_dtype=dtype, mesh=mesh, mixup_prob=0.5)
    net = build_network(NC, "n", device="cpu", seed=5).to(dtype)
    opt = SmartSGD(net, OptimizerConfig(), 6)
    step = make_train_step(net, default_anchors(), FeatureShape(S, S), opt, mesh=mesh)
    fn = pipe.build_fused_epoch_fn(lambda b, hp: step(b, hp), stack_metrics=True)
    fn(pipe.epoch_host_arrays(n), opt.hyper_table(0, n))
    return {k: v.detach().double().numpy().copy() for k, v in net.state_dict().items()}


def _one_step(mesh, state, batch):
    """One f32 step from ``state`` on this rank's rows of the global ``batch``."""
    net = build_network(NC, "n", device="cpu", seed=0)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    step = make_train_step(net, default_anchors(), FeatureShape(S, S),
                           SmartSGD(net, OptimizerConfig(max_epochs=10), 10), mesh=mesh)
    rows = tmesh.batch_sharding(mesh, batch["images"].shape[0])
    m = step(Batch(*(torch.from_numpy(batch[k][rows]) for k in ("images", "boxes", "labels", "mask"))))
    v = torch.stack([m.total, m.box, m.obj, m.cls]).double()
    if mesh is not None:
        tdist.all_reduce_sum_(v, mesh.group)
    return dict(metrics=v.numpy(), lr=float(m.lr),
                state={k: v.detach().numpy().copy() for k, v in net.state_dict().items()})


def _bn(mesh, x, dy):
    """A ``BatchNorm`` on this rank's rows of ``x`` (its global statistics
    with a group): (output, dx, dweight and dbias summed over the ranks,
    running statistics)."""
    bn = BatchNorm(x.shape[1]).double()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[1]))
    sync_batchnorm(bn, None if mesh is None else mesh.group)
    rows = tmesh.batch_sharding(mesh, x.shape[0])
    xt = torch.from_numpy(x[rows]).requires_grad_(True)
    y = bn(xt)
    y.backward(torch.from_numpy(dy[rows]))
    g = torch.cat([bn.weight.grad, bn.bias.grad])
    if mesh is not None:
        tdist.all_reduce_sum_(g, mesh.group)
    return dict(y=y.detach().numpy(), dx=xt.grad.numpy(), dwb=g.numpy(),
                running=np.concatenate([bn.running_mean.numpy(), bn.running_var.numpy()]))


FEEDS = {  # name: Trainer keywords
    "device_cache_mosaic": dict(pipeline="device", device_cache=True),
    "device_cache_mixup": dict(pipeline="device", device_cache=True, mixup_prob=0.5),
    "device_cache_no_mosaic": dict(pipeline="device", device_cache=True, use_mosaic=False),
    "host_fed_mosaic": dict(pipeline="device", device_cache=False),
    "host_fed_mixup": dict(pipeline="device", device_cache=False, mixup_prob=0.5),
    "host_fed_no_mosaic": dict(pipeline="device", device_cache=False, use_mosaic=False),
    "host_mosaic": dict(pipeline="host", use_mosaic=True),
    "host_mixup": dict(pipeline="host", use_mosaic=True, mixup_prob=0.5),
    "host_no_mosaic": dict(pipeline="host", use_mosaic=False),
}


def _trainer(mesh, n_train=N_TRAIN, batch_size=B, **kw):
    info, val = _infos(n_train)
    return Trainer(info, val, size="n", image_size=S, batch_size=batch_size, max_targets=40, seed=7,
                   dtype=None, device="cpu", fake_mode=True, num_workers=1, max_epochs=4, mesh=mesh, **kw)


def _feed_batches(mesh, n=2) -> dict:
    out = {}
    for name, kw in FEEDS.items():
        t = _trainer(mesh, **kw)
        out[name] = [_np(b) for b, _ in t._train_batches(n)]
    return out


def _sharded_batches(mesh, n_train, batch_size, n=2) -> dict:
    """The batches of the replicated and the sharded corpus, mixup 0.5."""
    info, _ = _infos(n_train)
    out = {}
    for sharding in ("replicated", "sharded") if mesh is not None else ("replicated",):
        pipe = tdp.DeviceDataPipeline(info, S, batch_size, AugParams(), max_targets=40, seed=4, device="cpu",
                                      feed_dtype=torch.float32, mesh=mesh, corpus_sharding=sharding,
                                      mixup_prob=0.5)
        out[sharding] = [_np(b) for b, _ in pipe.epoch(n)]
        if sharding == "sharded":
            out["held_rows"] = int(pipe.corpus.shape[0])
    return out


def _validation(mesh) -> dict:
    """mAP through both validation feeds, and the predictions."""
    out = {}
    for feed, kw in (("cache", dict(val_device_cache=True)), ("host", dict(val_device_cache=False))):
        t = _trainer(mesh, pipeline="device", device_cache=True, **kw)
        out[feed] = t.validate()
        if feed == "host":
            out["predict"] = t.predict()
            out["val_rows"] = t.val_indices.tolist()
    return out


def _hyper_table():
    net = build_network(NC, "n", device="cpu", seed=5)
    return SmartSGD(net, OptimizerConfig(), 6).hyper_table(0, 20).numpy()


def _helpers(mesh) -> dict:
    data = bytes(range(mesh.rank * 3 + 1))
    return dict(gathered=tdist.allgather_bytes(data, mesh), main=tdist.is_main_process(), hyper=_hyper_table(),
                zero_only=tdist.rank_zero_only(lambda: "ran")(), host_info=tdist.host_info()[:2],
                per_host=tdist.per_host_batch_size(8), mesh=(mesh.size, mesh.rank, mesh.backend))


def _rank_checks(mesh, jobs: dict) -> dict:
    """Every rank-side check of one spawn, by job name."""
    torch.set_num_threads(1)
    t_reader.hash = _stable_hash
    out = {}
    if "helpers" in jobs:
        out["helpers"] = _helpers(mesh)
    if "steps" in jobs:
        out["steps_f64"] = _steps(mesh, torch.float64)
        out["steps_f32"] = _steps(mesh, torch.float32)
        out["fused_f32"] = _fused_steps(mesh)
    if "one_step" in jobs:
        out["one_step"] = _one_step(mesh, *jobs["one_step"])
    if "bn" in jobs:
        out["bn"] = _bn(mesh, *jobs["bn"])
    if "feeds" in jobs:
        out["feeds"] = _feed_batches(mesh)
    if "sharded" in jobs:
        out["sharded"] = _sharded_batches(mesh, *jobs["sharded"])
    if "validation" in jobs:
        out["validation"] = _validation(mesh)
    return out


# --------------------------------------------------------------- the spawns

def _jax_init_state():
    jnet = j_build(NC, "n")
    jsgd = jopt.SmartSGD(jopt.OptimizerConfig(max_epochs=10), steps_per_epoch=10)
    return jnet, jsgd, create_train_state(jnet, jax.random.PRNGKey(0), FeatureShape(S, S), jsgd)


def _global_batch(seed=20):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((B, 10, 4), np.float32)
    labels = np.zeros((B, 10), np.int32)
    mask = np.zeros((B, 10), bool)
    for b in range(B):
        for t in range(rng.integers(1, 10)):
            x, y = rng.uniform(0, S - 20, 2)
            w, h = rng.uniform(3, 40, 2)
            boxes[b, t] = [x, y, min(x + w, S - 1), min(y + h, S - 1)]
            labels[b, t] = rng.integers(0, NC)
            mask[b, t] = True
    images = rng.random((B, S, S, 3), np.float32)
    return dict(images=images, boxes=boxes, labels=labels, mask=mask)


@pytest.fixture(scope="module")
def jax_pair():
    """JAX's initial weights as the port's state dict, and a global batch."""
    _, _, state = _jax_init_state()
    tree = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    return {k: v.numpy().copy() for k, v in flax_to_torch(tree).items()}, _global_batch()


@pytest.fixture(scope="module")
def bn_inputs():
    rng = np.random.default_rng(9)
    x = rng.normal(2.0, 0.3, (4, 5, 6, 7))
    return x, rng.normal(0.0, 1.0, x.shape)


@pytest.fixture(scope="module")
def two_ranks(jax_pair, bn_inputs):
    jobs = dict(helpers=True, steps=True, one_step=jax_pair, bn=bn_inputs, feeds=True,
                sharded=(25, B), validation=True)
    return tdist.launch(_rank_checks, 2, (jobs,), device_type="cpu", timeout_s=TIMEOUT, join_timeout_s=JOIN)


@pytest.fixture(scope="module")
def three_ranks():
    return tdist.launch(_rank_checks, 3, (dict(sharded=(25, 6)),), device_type="cpu", timeout_s=TIMEOUT,
                        join_timeout_s=JOIN)


# ----------------------------------------------------- (a) the helpers, (b)

def test_helpers_single_process_match_jax_contracts():
    assert tdist.is_main_process() is jdist.is_main_process() is True
    assert tdist.rank_zero_only(lambda: 3)() == jdist.rank_zero_only(lambda: 3)() == 3
    assert tdist.allgather_bytes(b"abc") == jdist.allgather_bytes(b"abc") == [b"abc"]
    assert tdist.host_info()[:2] == jdist.host_info()[:2] == (0, 1)
    assert tdist.per_host_batch_size(8) == jdist.per_host_batch_size(8) == 8
    assert tdist.maybe_initialize_from_env() is jdist.maybe_initialize_from_env() is False
    assert tdist.initialize_multihost() is False
    assert tdist.backend_for("cuda") == "nccl" and tdist.backend_for("cpu") == "gloo"
    m = tmesh.make_mesh()
    assert (m.size, m.rank, m.group) == (1, 0, None)


def test_helpers_on_two_ranks(two_ranks):
    want = [bytes(range(1)), bytes(range(4))]  # unequal lengths, rank order
    for r, res in enumerate(two_ranks):
        h = res["helpers"]
        assert h["gathered"] == want
        assert h["main"] is (r == 0) and h["zero_only"] == ("ran" if r == 0 else None)
        assert h["host_info"] == (r, 2) and h["per_host"] == 4 and h["mesh"] == (2, r, "gloo")
        np.testing.assert_array_equal(h["hyper"], _hyper_table())  # SmartSGD's table: every rank's is one


@pytest.mark.parametrize("n", [8, 10])
def test_batch_sharding_matches_jax_mesh(n):
    jm = jmesh.make_mesh(2)
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    placed = jax.device_put(x, jmesh.batch_sharding(jm)) if n % 2 == 0 else None
    for r in range(2):
        mesh = tmesh.DataMesh(2, r, torch.device("cpu"))
        if placed is None:
            with pytest.raises(ValueError, match="do not divide"):
                tmesh.batch_sharding(mesh, n)
            continue
        shard = next(s for s in placed.addressable_shards if s.device == jm.devices[r, 0])
        got = tmesh.shard_batch_pytree(Batch(*(torch.from_numpy(x),) * 4), mesh)
        assert all(np.array_equal(t.numpy(), np.asarray(shard.data)) for t in got)


@pytest.mark.parametrize("n,hosts", [(10, 2), (11, 3), (7, 4)])
def test_shard_indices_and_fixed_sampler_match_jax(n, hosts):
    idx = np.random.default_rng(n).permutation(n)
    for h in range(hosts):
        got = tsamplers.shard_indices(idx, h, hosts)
        np.testing.assert_array_equal(got, jsamplers.shard_indices(idx, h, hosts))
        ts, js = tsamplers.FixedSampler(got), jsamplers.FixedSampler(got)
        assert len(ts) == len(js)
        np.testing.assert_array_equal(ts.epoch_indices(), js.epoch_indices())
    joined = np.concatenate([tsamplers.shard_indices(idx, h, hosts) for h in range(hosts)])
    assert sorted(joined.tolist()) == list(range(n))


# ------------------------------------------------------------- (c) batches

@pytest.fixture(scope="module")
def one_rank_feeds():
    return _rank_checks(None, dict(feeds=True))["feeds"]


@pytest.mark.parametrize("feed", list(FEEDS))
def test_rank_batches_are_rows_of_one_rank_batches(two_ranks, one_rank_feeds, feed):
    whole = one_rank_feeds[feed]
    assert len(whole) == 2
    for r, res in enumerate(two_ranks):
        for i, got in enumerate(res["feeds"][feed]):
            for k, v in got.items():
                np.testing.assert_array_equal(v, whole[i][k][r * 2:(r + 1) * 2], err_msg=f"{feed} {k} step {i}")


# ------------------------------------------- (d) two ranks against one rank

@pytest.fixture(scope="module")
def one_rank_steps():
    return dict(f64=_steps(None, torch.float64), f32=_steps(None, torch.float32))


def test_two_rank_steps_equal_one_rank_f64(two_ranks, one_rank_steps):
    want = one_rank_steps["f64"]
    for res in two_ranks:
        got = res["steps_f64"]
        np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=1e-6)
        assert set(got["state"]) == set(want["state"])
        for k, v in want["state"].items():
            np.testing.assert_allclose(got["state"][k], v, rtol=1e-9, atol=1e-12, err_msg=k)
        for i, b in enumerate(got["batches"]):
            r = two_ranks.index(res)
            np.testing.assert_array_equal(b["images"], want["batches"][i]["images"][r * 2:(r + 1) * 2])


def test_two_rank_steps_equal_one_rank_f32(two_ranks, one_rank_steps):
    want = one_rank_steps["f32"]
    for res in two_ranks:
        got = res["steps_f32"]
        np.testing.assert_allclose(got["metrics"][:, :4], want["metrics"][:, :4], rtol=1e-4)
        np.testing.assert_array_equal(got["metrics"][:, 4], want["metrics"][:, 4])
        for k, v in want["state"].items():
            np.testing.assert_allclose(got["state"][k], v, atol=1e-5, rtol=1e-4, err_msg=k)


def test_ranks_hold_the_same_state(two_ranks):
    for key in ("steps_f64", "steps_f32"):
        a, b = (res[key]["state"] for res in two_ranks)
        assert all(np.array_equal(a[k], b[k]) for k in a), key


def test_fused_epoch_on_ranks_equals_the_step_loop(two_ranks):
    for res in two_ranks:
        want, got = res["steps_f32"]["state"], res["fused_f32"]
        assert all(np.array_equal(got[k], want[k]) for k in want)


def test_local_reductions_would_be_caught(two_ranks, jax_pair):
    """A step with this rank's reductions only (BatchNorm statistics, the
    loss's denominators and the gradient over rank 0's rows alone) lands
    far from the global step, more than 100x farther than the 2-rank step
    does: the parity above would catch a per-rank mean."""
    state, batch = jax_pair
    whole = _one_step(None, state, batch)["state"]
    local = _one_step(None, state, {k: v[:2] for k, v in batch.items()})["state"]
    ranked = two_ranks[0]["one_step"]["state"]
    far = max(float(np.abs(local[k] - v).max()) for k, v in whole.items())
    near = max(float(np.abs(ranked[k] - v).max()) for k, v in whole.items())
    assert far > 100 * near, (far, near)


# ------------------------------------------------- (e) against JAX's mesh

def test_two_rank_step_matches_jax_two_device_mesh(two_ranks, jax_pair):
    import flax.linen.normalization as fnorm

    _, batch = jax_pair
    jnet, jsgd, state = _jax_init_state()
    stats = fnorm._compute_stats
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnorm, "_compute_stats", lambda *a, **k: stats(*a, **{**k, "use_fast_variance": False}))
        step = jit_train_step(j_make_step(jnet, j_anchors(), FeatureShape(S, S), jsgd), jmesh.make_mesh(2))
        state, jm = step(state, JBatch(*(jnp.asarray(batch[k]) for k in ("images", "boxes", "labels", "mask"))))
    want = flax_to_torch(jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
    for res in two_ranks:
        got = res["one_step"]
        np.testing.assert_allclose(got["metrics"], [float(jm.total), float(jm.box), float(jm.obj), float(jm.cls)],
                                   rtol=1e-4)
        assert got["lr"] == pytest.approx(float(jm.lr), rel=1e-6)
        assert set(got["state"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got["state"][k], v.numpy(), atol=1e-5, rtol=1e-4, err_msg=k)


# ------------------------------------------------------------ (f) BatchNorm

def test_batchnorm_gradient_equals_autograd_of_one_rank(two_ranks, bn_inputs):
    want = _bn(None, *bn_inputs)
    for r, res in enumerate(two_ranks):
        got = res["bn"]
        rows = slice(r * 2, (r + 1) * 2)
        np.testing.assert_allclose(got["y"], want["y"][rows], rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(got["dx"], want["dx"][rows], rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(got["dwb"], want["dwb"], rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(got["running"], want["running"], rtol=1e-12)


# --------------------------------------------------- (g) the sharded corpus

@pytest.mark.parametrize("ranks", [2, 3])
def test_sharded_corpus_equals_replicated(two_ranks, three_ranks, ranks):
    results = two_ranks if ranks == 2 else three_ranks
    per = math.ceil(25 / ranks)  # 25 images do not divide over either
    for res in results:
        got = res["sharded"]
        assert got["held_rows"] == per
        for a, b in zip(got["sharded"], got["replicated"], strict=True):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sharded_corpus_rows_are_one_rank_rows(three_ranks):
    whole = _sharded_batches(None, 25, 6)["replicated"]
    for r, res in enumerate(three_ranks):
        for i, got in enumerate(res["sharded"]["sharded"]):
            for k, v in got.items():
                np.testing.assert_array_equal(v, whole[i][k][r * 2:(r + 1) * 2], err_msg=k)


# ------------------------------------------------------ (h) the merged mAP

def test_merged_map_and_predictions_equal_one_rank(two_ranks):
    want = _validation(None)
    assert not all(math.isnan(v) or v == 0 for v in want["cache"].values())
    for r, res in enumerate(two_ranks):
        got = res["validation"]
        assert got["val_rows"] == list(range(r, N_VAL, 2))
        assert got["cache"] == want["cache"] and got["host"] == want["host"]
        assert got["predict"] == want["predict"]


# ------------------------------------------------------ (i) the CLI, resume

CLI = ["experiment=yv5n", "dataset_name=fake", "trainer=cpu", "model.net.dtype=null",
       "model.net.widen_factor=0.25", "data.batch_size=4", "data.target_image_size=64", "data.max_targets=40",
       "data.num_workers=1", "data.pipeline=device", "data.device_cache=True", "callbacks.model_summary=null",
       "logger=csv", "print_config=False", "model.val_nms_max_candidates=256", "data.fake_num_images=16",
       "debug=fdr", "hydra=static", "extras.enforce_tags=False"]


def _restored(mesh, cfg):
    torch.set_num_threads(1)
    t = Trainer.from_config(cfg, mesh)
    return dict(net={k: v.numpy().copy() for k, v in t.net.state_dict().items()},
                momentum={k: v.numpy().copy() for k, v in t.optimizer.buffers.items()},
                step=t.optimizer.step_count)


def test_cli_two_ranks_train_write_once_and_resume(tmp_path):
    one, two = tmp_path / "one", tmp_path / "two"
    m1 = t_cli.main(CLI + [f"paths.output_dir={one}"])
    m2 = t_cli.main(CLI + [f"paths.output_dir={two}", "trainer.num_devices=2"])
    assert m1.keys() == m2.keys() and "map" in m2
    for f in ("checkpoints/last", "checkpoints/best", "checkpoints/meta.json", "csv/metrics.csv",
              "hparams.json"):
        assert (two / f).is_file(), f
    assert len((two / "csv/metrics.csv").read_text().splitlines()) == len(
        (one / "csv/metrics.csv").read_text().splitlines())
    assert (two / "hparams.json").read_text() == (one / "hparams.json").read_text()
    cfg = t_engine.compose(ROOT / "configs", "train", CLI + [
        f"paths.output_dir={tmp_path / 'resume'}", "trainer.num_devices=2", "train=False", "test=True",
        f"ckpt_path={two / 'checkpoints' / 'last'}"])
    saved = tck.load_state(two / "checkpoints" / "last")
    for res in tdist.launch(_restored, 2, (cfg,), device_type="cpu", timeout_s=TIMEOUT, join_timeout_s=JOIN):
        assert res["step"] == saved["optimizer"]["step_count"] == 1
        assert all(np.array_equal(v, saved["net"][k].numpy()) for k, v in res["net"].items())
        assert all(np.array_equal(v, saved["optimizer"]["momentum"][k].numpy()) for k, v in res["momentum"].items())


# ------------------------------------------------------------ (j) refusals

def test_refusals():
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        _trainer(tmesh.DataMesh(3, 0, torch.device("cpu"), group=object(), backend="gloo"))
    with pytest.raises(ValueError, match="cards are visible"):
        num_devices_from_cfg({"platform": None, "num_devices": torch.cuda.device_count() + 1})
    with pytest.raises(NotImplementedError, match="DP x SP"):
        tmesh.make_mesh(2, num_model=2)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_mesh(2)
    gloo_card = SimpleNamespace(corpus=torch.zeros(1), device=torch.device("cuda"),
                                mesh=tmesh.DataMesh(2, 0, torch.device("cuda"), object(), "gloo"))
    with pytest.raises(ValueError, match="gloo backend cannot be captured"):
        tdp.FusedEpoch(gloo_card, lambda b, hp: None)
    with pytest.raises(ValueError, match="needs device_cache=True and a mesh"):
        _trainer(None, pipeline="device", device_cache=True, corpus_sharding="sharded")
    assert num_devices_from_cfg({"platform": "cpu", "num_devices": None}) == 1
    assert num_devices_from_cfg({"platform": "cpu", "num_devices": 8}) == 8
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        tdist.launch(_fails_on_rank_one, 2, device_type="cpu", timeout_s=TIMEOUT, join_timeout_s=JOIN)


def _fails_on_rank_one(mesh):
    if mesh.rank == 1:
        raise ValueError("planted")
    return mesh.rank


def test_mesh_configs_compose():
    for name, want in (("mesh", None), ("mesh_sim", 8)):
        cfg = t_engine.compose(ROOT / "configs", "train", [f"trainer={name}"])
        assert cfg["trainer"]["num_devices"] == want
    assert t_engine.compose(ROOT / "configs", "train", ["trainer=mesh_sim"])["trainer"]["platform"] == "cpu"
