"""Port parity: DP x SP spatial sharding (the JAX package's ``make_mesh(
num_model > 1)`` with ``jit_train_step(spatial=True)`` and ``make_train_step(
head_sharding=)``; JAX's own tests are ``tests/test_spatial_sharding.py``).

Gloo ranks on the CPU, spawned by the port's launcher: one 2-rank group
(the ``(1, 2)`` mesh, beside the same ranks as a ``(2, 1)`` data-parallel
mesh) and one 4-rank group (the ``(2, 2)`` and ``(1, 4)`` meshes), each
launched once for the module; each rank holds torch to one thread. yolov5n
at 128 px (the stride-32 level keeps 2 rows a band at two bands), a global
batch of 4 from numpy seeds, the JAX initial weights converted by
``models/convert.py:flax_to_torch``. Tolerances:
  * the halo exchange alone, for every row of its table (the stem 6/2/2,
    every 3x3/2, every 3x3/1, each SPPF pool 5/1/2) at 2 and 4 bands: a
    banded conv or pool, forward, input gradient and (summed over the
    bands) weight gradient, against the unsharded op, f64, within 1e-12;
    hypothesis draws channels, band heights (a multiple of the stride, at
    least the guard's 2 rows) and widths, the same draws on every rank
    (``derandomize``; a drawn case never raises, so no rank shrinks alone);
  * three spatial steps in f64 at ``(1, 2)`` and ``(2, 2)`` against the
    port's one-process step: every parameter and running statistic within
    1e-10. The loss is computed in f32 by design (``train/loss.py``), so a
    loss summed over two data ranks' f32 shares is held within 1e-10 of the
    port's data-parallel step on the same two data ranks and within rtol
    1e-6 of one process (``tests/test_torch_parallel.py``'s f64 rule); at
    ``(1, 2)`` every model rank computes the one process's loss, within
    1e-10;
  * the ``(1, 2)`` spatial step in f32 against ``jax.jit(make_train_step)``
    of the JAX package on one device, one step from the same weights and
    batch (flax's two-pass variance, as the port's data-parallel parity
    does): JAX's ``test_dp_sp_matches_single_device`` bounds, loss rel 1e-5
    and every parameter within 1e-4; JAX's own spatial compile is
    ``slow``-marked and is not run here;
  * a heads' gather whose backward summed over the model ranks gives every
    gradient ``M`` times the one process's (rtol 1e-9), which the parity
    above catches;
  * the guard's cases beside JAX's ``test_spatial_guard_rejects_thin_shards``:
    H = 64 and 96 over two bands raise JAX's message, word for word, and
    H = 128 runs;
  * ``remat_policy="conv_out"`` at ``(1, 2)``: bitwise the step without
    remat, with the same halo exchanges (the recompute sends nothing);
  * a spatial mesh handed to ``Trainer`` or ``DeviceDataPipeline`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import HealthCheck, Phase, given, settings
from hypothesis import strategies as st
from torch import nn

from object_detection_cib_torch.core.types import FeatureShape, default_anchors
from object_detection_cib_torch.data import device_pipeline as tdp
from object_detection_cib_torch.data.host_augment import AugParams
from object_detection_cib_torch.data.synthetic import build_fake_manifest
from object_detection_cib_torch.models.convert import flax_to_torch
from object_detection_cib_torch.models.layers import _maxpool_same, conv2d
from object_detection_cib_torch.models.yolov5 import build_network
from object_detection_cib_torch.parallel import distributed as tdist
from object_detection_cib_torch.parallel import mesh as tmesh
from object_detection_cib_torch.parallel import spatial as tspatial
from object_detection_cib_torch.train.optim import OptimizerConfig, SmartSGD
from object_detection_cib_torch.train.steps import Batch, make_train_step
from object_detection_cib_torch.train.trainer import Trainer
from object_detection_cib_tpu.core.types import default_anchors as j_anchors
from object_detection_cib_tpu.models.yolov5 import build_network as j_build
from object_detection_cib_tpu.parallel import mesh as jmesh
from object_detection_cib_tpu.train import optim as jopt
from object_detection_cib_tpu.train.steps import Batch as JBatch
from object_detection_cib_tpu.train.steps import create_train_state, jit_train_step
from object_detection_cib_tpu.train.steps import make_train_step as j_make_step

S, B, T, NC, STEPS = 128, 4, 10, 3, 3
TIMEOUT, JOIN = 60, 400  # init_process_group's timeout; the whole spawn's
HALO_EXAMPLES = 12
LAYERS = {  # the halo table: kind, kernel, stride, padding
    "stem 6/2/2": ("conv", 6, 2, 2),
    "3x3/2": ("conv", 3, 2, 1),
    "3x3/1": ("conv", 3, 1, 1),
    "SPPF pool 5/1/2": ("pool", 5, 1, 2),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    boxes = np.zeros((B, T, 4), np.float32)
    labels = np.zeros((B, T), np.int32)
    mask = np.zeros((B, T), bool)
    for b in range(B):
        for t in range(rng.integers(1, T)):
            x, y = rng.uniform(0, S - 40, 2)
            w, h = rng.uniform(6, 80, 2)
            boxes[b, t] = [x, y, min(x + w, S - 1), min(y + h, S - 1)]
            labels[b, t] = rng.integers(0, NC)
            mask[b, t] = True
    images = rng.random((B, S, S, 3), np.float32)
    return dict(images=images, boxes=boxes, labels=labels, mask=mask)


BATCHES = [_batch(20 + i) for i in range(STEPS)]


def _state(net) -> dict:
    return {k: v.detach().double().numpy().copy() for k, v in net.state_dict().items()}


# --------------------------------------------------------- what a rank runs

def _halo_errors(sp: tspatial.Spatial, layer: str) -> dict:
    """The largest gaps of the banded op against the unsharded one over
    hypothesis's draws: forward, input gradient, weight gradient."""
    kind, k, s, p = LAYERS[layer]
    above, below = tspatial.conv_reach(k, s, p)
    worst = dict(y=0.0, dx=0.0, dw=0.0, examples=0)

    @settings(max_examples=HALO_EXAMPLES, derandomize=True, database=None, deadline=None,
              suppress_health_check=list(HealthCheck), phases=[Phase.generate])
    @given(n=st.integers(1, 2), c=st.integers(1, 6), units=st.integers(-(-2 // s), 8 // s),
           w=st.integers(k, 12), seed=st.integers(0, 2**16))
    def case(n, c, units, w, seed):
        h = units * s  # a band: a multiple of the stride, at least the guard's 2 rows
        g = torch.Generator().manual_seed(seed)
        x = torch.randn((n, c, sp.size * h, w), generator=g, dtype=torch.float64)
        band = slice(sp.rank * h, (sp.rank + 1) * h)
        xf, xb = x.clone().requires_grad_(), x[:, :, band].clone().requires_grad_()
        if kind == "conv":
            conv = nn.Conv2d(c, c + 1, k, s, p, bias=False).double()
            with torch.no_grad():
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=g, dtype=torch.float64))
            yf = conv2d(xf, conv)
            dy = torch.randn(yf.shape, generator=g, dtype=torch.float64)
            yf.backward(dy)
            dw_full = conv.weight.grad.clone()
            conv.weight.grad = None
            yb = conv2d(sp.exchange(xb, above, below), conv, pad_rows=False)
        else:
            yf = _maxpool_same(xf, k)
            dy = torch.randn(yf.shape, generator=g, dtype=torch.float64)
            yf.backward(dy)
            yb = _maxpool_same(xb, k, sp)
        out_band = slice(sp.rank * h // s, (sp.rank + 1) * h // s)
        yb.backward(dy[:, :, out_band])
        worst["y"] = max(worst["y"], float((yb - yf[:, :, out_band]).abs().max()))
        worst["dx"] = max(worst["dx"], float((xb.grad - xf.grad[:, :, band]).abs().max()))
        if kind == "conv":
            dw = conv.weight.grad.clone()
            dist.all_reduce(dw, group=sp.group)
            worst["dw"] = max(worst["dw"], float((dw - dw_full).abs().max()))
        worst["examples"] += 1

    case()
    return worst


def _steps(mesh, state: dict, dtype=torch.float64, n: int = STEPS, **step_kw) -> dict:
    """``n`` steps of the port's step from ``state`` on this rank's rows (and
    band, under a model axis) of ``BATCHES``: the metrics summed over the
    data ranks, the halo exchanges and all-reduces issued, the gradients
    after the last step, the state."""
    net = build_network(NC, "n", device="cpu", seed=0)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    net = net.to(dtype)
    step = make_train_step(net, default_anchors(), FeatureShape(S, S),
                           SmartSGD(net, OptimizerConfig(max_epochs=10), 10), mesh=mesh, **step_kw)
    spatial = mesh is not None and mesh.model_size > 1
    metrics, halos, reduces = [], tspatial.HaloCounts.calls, tdist.all_reduce_sum_.calls
    for b in BATCHES[:n]:
        batch = Batch(*(torch.from_numpy(b[k]) for k in ("images", "boxes", "labels", "mask")))
        if mesh is not None:
            batch = tmesh.shard_batch_pytree(batch, mesh, spatial=spatial)
        m = step(batch._replace(images=batch.images.to(dtype)))
        v = torch.stack([m.total, m.box, m.obj, m.cls, m.assign_drop.to(m.total.dtype)]).double()
        if mesh is not None:
            tdist.all_reduce_sum_(v, mesh.group)
        metrics.append(v.numpy())
    return dict(metrics=np.array(metrics), halos=tspatial.HaloCounts.calls - halos,
                reduces=tdist.all_reduce_sum_.calls - reduces, state=_state(net),
                grads={k: p.grad.detach().double().numpy().copy() for k, p in net.named_parameters()})


class _SummedGather(tspatial._GatherBands):
    """The heads' gather with the backward of
    ``torch.distributed.nn.functional.all_gather``: the gradient summed over
    the model ranks, then this rank's slice."""

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.sp.group)
        return g.narrow(ctx.dim, ctx.sp.rank * ctx.rows, ctx.rows), None, None


def _summed_gather_step(mesh, state) -> dict:
    gather = tspatial.Spatial.gather_rows
    tspatial.Spatial.gather_rows = lambda self, x, dim: _SummedGather.apply(x, self, dim)
    try:
        return _steps(mesh, state, n=1)
    finally:
        tspatial.Spatial.gather_rows = gather


def _layout(mesh) -> dict:
    ranks = lambda g: dist.get_process_group_ranks(g)  # noqa: E731
    b = BATCHES[0]
    rows = tmesh.shard_batch_pytree(Batch(*(torch.from_numpy(b[k]) for k in ("images", "boxes", "labels", "mask"))),
                                    mesh, spatial=True)
    return dict(axes=(mesh.size, mesh.rank, mesh.model_size, mesh.model_rank, mesh.world_rank, mesh.is_main),
                data=ranks(mesh.group), model=ranks(mesh.model_group), world=ranks(mesh.world),
                rows={k: v.numpy().copy() for k, v in rows._asdict().items()})


def _rank_checks(mesh, state: dict, jobs: tuple) -> dict:
    """Every rank-side check of one spawn: ``mesh`` is the group's
    data-parallel mesh; each job names a ``(data, model)`` mesh over it."""
    torch.set_num_threads(1)
    out = {}
    meshes = {}
    for job, (nd, nm) in jobs:
        key = (nd, nm)
        if key not in meshes:
            meshes[key] = mesh if nm == 1 else tmesh.make_mesh(nd, nm, device="cpu")
        m = meshes[key]
        if job == "halo":
            out[("halo", nm)] = {layer: _halo_errors(tspatial.spatial_of(m), layer) for layer in LAYERS}
        elif job == "layout":
            out[("layout", key)] = _layout(m)
        elif job == "steps":
            out[("steps", key)] = _steps(m, state)
        elif job == "f32":
            out[("f32", key)] = _steps(m, state, torch.float32, n=1)
        elif job == "remat":
            out[("remat", key)] = {p: _steps(m, state, n=1, remat_policy=p) for p in (None, "conv_out")}
        elif job == "summed":
            out[("summed", key)] = _summed_gather_step(m, state)
    return out


# --------------------------------------------------------------- the spawns

def _jax_init_state():
    jnet = j_build(NC, "n")
    jsgd = jopt.SmartSGD(jopt.OptimizerConfig(max_epochs=10), steps_per_epoch=10)
    return jnet, jsgd, create_train_state(jnet, jax.random.PRNGKey(0), FeatureShape(S, S), jsgd)


@pytest.fixture(scope="module")
def state():
    """JAX's initial weights as the port's state dict."""
    _, _, st0 = _jax_init_state()
    tree = jax.tree.map(np.asarray, {"params": st0.params, "batch_stats": st0.batch_stats})
    return {k: v.numpy().copy() for k, v in flax_to_torch(tree).items()}


@pytest.fixture(scope="module")
def two_ranks(state):
    jobs = (("halo", (1, 2)), ("layout", (1, 2)), ("steps", (1, 2)), ("steps", (2, 1)), ("f32", (1, 2)),
            ("remat", (1, 2)), ("summed", (1, 2)))
    return tdist.launch(_rank_checks, 2, (state, jobs), device_type="cpu", timeout_s=TIMEOUT, join_timeout_s=JOIN)


@pytest.fixture(scope="module")
def four_ranks(state):
    jobs = (("halo", (1, 4)), ("layout", (2, 2)), ("steps", (2, 2)))
    return tdist.launch(_rank_checks, 4, (state, jobs), device_type="cpu", timeout_s=TIMEOUT, join_timeout_s=JOIN)


@pytest.fixture(scope="module")
def one_process(state):
    return dict(f64=_steps(None, state), f32=_steps(None, state, torch.float32, n=1))


def _ranks(two_ranks, four_ranks, mesh):
    return two_ranks if mesh[0] * mesh[1] == 2 else four_ranks


# ------------------------------------------------------ (i) the halo exchange

@pytest.mark.parametrize("layer", list(LAYERS))
@pytest.mark.parametrize("bands", [2, 4])
def test_halo_exchange_equals_the_unsharded_op(two_ranks, four_ranks, bands, layer):
    for res in two_ranks if bands == 2 else four_ranks:
        got = res[("halo", bands)][layer]
        assert got["examples"] == HALO_EXAMPLES
        assert max(got["y"], got["dx"], got["dw"]) <= 1e-12, got


def test_halo_reach_of_every_layer_of_the_table():
    assert [tspatial.conv_reach(*LAYERS[name][1:]) for name in LAYERS] == [(2, 2), (1, 0), (1, 1), (2, 2)]


# ------------------------------------------------- the mesh and the batch

@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_mesh_is_jax_row_major_grid_and_batch_is_rows_and_bands(two_ranks, four_ranks, mesh):
    nd, nm = mesh
    whole = BATCHES[0]
    for r, res in enumerate(_ranks(two_ranks, four_ranks, mesh)):
        got = res[("layout", mesh)]
        d, m = divmod(r, nm)
        assert got["axes"] == (nd, d, nm, m, r, r == 0)
        assert got["data"] == [i * nm + m for i in range(nd)]
        assert got["model"] == [d * nm + j for j in range(nm)]
        assert got["world"] == list(range(nd * nm))
        rows, band = slice(d * B // nd, (d + 1) * B // nd), slice(m * S // nm, (m + 1) * S // nm)
        np.testing.assert_array_equal(got["rows"]["images"], whole["images"][rows][:, band])
        for k in ("boxes", "labels", "mask"):
            np.testing.assert_array_equal(got["rows"][k], whole[k][rows])


# ----------------------------------------- (ii) the step against one process

@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_spatial_steps_equal_one_process_f64(two_ranks, four_ranks, one_process, mesh):
    want = one_process["f64"]
    dp = two_ranks[0][("steps", (2, 1))]  # the same two data ranks without a model axis
    for res in _ranks(two_ranks, four_ranks, mesh):
        got = res[("steps", mesh)]
        assert got["halos"] > 0
        if mesh[0] == 1:
            np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=1e-10, atol=0)
        else:  # two data ranks' f32 loss shares, summed
            np.testing.assert_allclose(got["metrics"], dp["metrics"], rtol=1e-10, atol=0)
            np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=1e-6, atol=0)
        assert set(got["state"]) == set(want["state"])
        for k, v in want["state"].items():
            np.testing.assert_allclose(got["state"][k], v, rtol=0, atol=1e-10, err_msg=k)


def test_ranks_hold_the_same_state(two_ranks, four_ranks):
    for mesh in ((1, 2), (2, 2)):
        states = [res[("steps", mesh)]["state"] for res in _ranks(two_ranks, four_ranks, mesh)]
        for s in states[1:]:
            assert all(np.array_equal(s[k], v) for k, v in states[0].items()), mesh


# ------------------------------------------------ (iii) against JAX, f32

def test_spatial_step_matches_jax_single_device(two_ranks, state):
    """JAX's step (``jax.jit(make_train_step(...))``, the function JAX's
    spatial step is held equal to) from its initial weights on one device,
    with flax's two-pass variance, on the batch the port's ranks shard."""
    import flax.linen.normalization as fnorm

    jnet, jsgd, st0 = _jax_init_state()
    stats = fnorm._compute_stats
    b = BATCHES[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnorm, "_compute_stats", lambda *a, **k: stats(*a, **{**k, "use_fast_variance": False}))
        st1, jm = jax.jit(j_make_step(jnet, j_anchors(), FeatureShape(S, S), jsgd))(
            st0, JBatch(*(jnp.asarray(b[k]) for k in ("images", "boxes", "labels", "mask"))))
    want = flax_to_torch(jax.tree.map(np.asarray, {"params": st1.params, "batch_stats": st1.batch_stats}))
    for res in two_ranks:
        got = res[("f32", (1, 2))]
        assert got["metrics"][0, 0] == pytest.approx(float(jm.total), rel=1e-5)
        assert int(got["metrics"][0, 4]) == int(jm.assign_drop)
        assert set(got["state"]) == set(want)
        for k, v in want.items():
            assert np.abs(got["state"][k] - v.double().numpy()).max() < 1e-4, k


# ----------------------------------------- (iv) a summing gather is caught

def test_a_gather_that_sums_its_backward_would_be_caught(two_ranks, state):
    """Every model rank computes the same loss from the gathered heads; a
    gather whose backward summed the gradient over the model ranks (as
    ``torch.distributed.nn.functional.all_gather``'s does) makes every
    gradient ``num_model`` times the one process's, where the spatial step
    lands within 1e-10 of it."""
    one = _steps(None, state, n=1)["grads"]
    for res in two_ranks:
        good, bad = res[("remat", (1, 2))][None]["grads"], res[("summed", (1, 2))]["grads"]
        near = max(float(np.abs(good[k] - v).max()) for k, v in one.items())
        far = max(float(np.abs(bad[k] - v).max()) for k, v in one.items())
        assert near < 1e-10 and far > 1e6 * max(near, 1e-16), (near, far)
        for k, v in one.items():
            np.testing.assert_allclose(bad[k], 2 * v, rtol=1e-9, atol=1e-12, err_msg=k)


# ------------------------------------------------------------ (v) the guard

def _jax_guard_message(img: int) -> str:
    """JAX's ``test_spatial_guard_rejects_thin_shards`` case: the message of
    ``jit_train_step(spatial=True)`` on a (4, 2) mesh for height ``img``."""
    jnet = j_build(NC, "n")
    jsgd = jopt.SmartSGD(jopt.OptimizerConfig(max_epochs=10), steps_per_epoch=10)
    mesh = jmesh.make_mesh(num_data=4, num_model=2)
    step = jit_train_step(j_make_step(jnet, j_anchors(), FeatureShape(img, img), jsgd), mesh, spatial=True)
    batch = JBatch(jnp.zeros((8, img, img, 3)), jnp.asarray([[[4.0, 4.0, 40.0, 40.0]]] * 8),
                   jnp.zeros((8, 1), jnp.int32), jnp.ones((8, 1), bool))
    with pytest.raises(ValueError, match="rows per shard") as e:
        step(None, batch)
    return str(e.value)


@pytest.mark.parametrize("img", [64, 96])
def test_spatial_guard_rejects_thin_bands_with_jax_message(img):
    """H = 64 leaves the stride-32 level 1 row a band, H = 96 does not divide;
    the step raises before anything is exchanged (the groups here are
    stand-ins that any collective would fail on)."""
    fake = object()
    mesh = tmesh.DataMesh(1, 0, torch.device("cpu"), fake, "gloo", 1, 2, 0, fake, fake)
    net = build_network(NC, "n", device="cpu", seed=0)
    step = make_train_step(net, default_anchors(), FeatureShape(img, img), SmartSGD(net, OptimizerConfig(), 10),
                           mesh=mesh)
    band = Batch(torch.zeros((2, img // 2, img, 3)), torch.tensor([[[4.0, 4.0, 40.0, 40.0]]] * 2),
                 torch.zeros((2, 1), dtype=torch.int32), torch.ones((2, 1), dtype=torch.bool))
    with pytest.raises(ValueError, match="rows per shard") as e:
        step(band)
    assert str(e.value) == _jax_guard_message(img)


def test_spatial_guard_passes_at_two_rows_a_band(two_ranks):
    """H = 128 over two bands: 2 rows a band at stride 32, the boundary the
    guard allows; the steps above ran there."""
    assert S == 128 and all(res[("steps", (1, 2))]["metrics"].shape == (STEPS, 5) for res in two_ranks)


# ------------------------------------------------------------- (vi) remat

def test_remat_conv_out_equals_no_remat_spatial(two_ranks):
    for res in two_ranks:
        base, got = res[("remat", (1, 2))][None], res[("remat", (1, 2))]["conv_out"]
        np.testing.assert_array_equal(got["metrics"], base["metrics"])
        assert all(np.array_equal(got["state"][k], v) for k, v in base["state"].items())
        assert all(np.array_equal(got["grads"][k], v) for k, v in base["grads"].items())
        assert got["halos"] == base["halos"] > 0  # the recompute sends nothing
        assert got["reduces"] > base["reduces"]  # it does recompute the statistics


# ---------------------------------------------------------- (vii) refusals

def test_a_spatial_mesh_is_refused_by_the_trainer_and_the_pipeline():
    fake = object()
    mesh = tmesh.DataMesh(1, 0, torch.device("cpu"), fake, "gloo", 1, 2, 0, fake, fake)
    info = build_fake_manifest(num_images=8, num_classes=NC, image_size=64, seed=0)
    with pytest.raises(ValueError, match="model axis"):
        Trainer(info, info, size="n", image_size=64, batch_size=4, device="cpu", fake_mode=True, mesh=mesh)
    with pytest.raises(ValueError, match="model axis"):
        tdp.DeviceDataPipeline(info, 64, 4, AugParams(), device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_mesh(1, 2, device="cpu")
