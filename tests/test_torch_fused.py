"""Port parity: the fused epoch (the JAX package's default device-cache
loop) — ``epoch_host_arrays``, ``build_fused_epoch_fn``, SmartSGD's
hyperparameter table, ``Trainer._fused_config`` and dispatch-ahead.

On the CPU, where the fused epoch runs its step function eagerly (on the
card the same function is a CUDA graph: ``tests/test_torch_cuda.py``). The
fake corpus at 64 px, B = 4 (B = 8 for the trainer runs), torch held to one
thread. Tolerances:
  * the epoch plan against JAX's ``epoch_host_arrays`` (its keys aside),
    ``consumed_plan_log`` and ``_fused_config`` against JAX's: exact;
  * the fused epoch against JAX's ``build_fused_epoch_fn`` with the
    augmentation drawing nothing (no mosaic, ``AugParams.no_aug()``: the
    letterbox and an identity affine, so JAX's keys and the port's
    generator give the same batches), a checksum step: rtol 1e-6 (the JAX
    test's); the checksum is integer arithmetic (pixels x 255 and boxes x
    16, rounded), exact in f32 on both sides whatever order they sum in;
  * the fused epoch against the port's own step loop: bitwise (the same
    ops in the same order);
  * the hyperparameter table against JAX's ``SmartSGD.hyperparams``: f32
    exact at every step of two epochs across the warm-up's end;
  * dispatch-ahead on and off, and the fused epoch against the step loop,
    through ``Trainer.from_config`` (the JAX package's
    ``test_fused_dispatch_ahead_equivalence``, in f32 on the CPU): bitwise
    parameters, equal mAP, metrics, CSV log and sampler files.
"""

import csv
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_cib_torch.config import engine as t_engine
from object_detection_cib_torch.core.types import FeatureShape
from object_detection_cib_torch.core.types import default_anchors
from object_detection_cib_torch.data import device_pipeline as tdp
from object_detection_cib_torch.data import samplers as tsamplers
from object_detection_cib_torch.data.host_augment import AugParams as TAug
from object_detection_cib_torch.data.synthetic import build_fake_manifest as t_manifest
from object_detection_cib_torch.models.yolov5 import build_network
from object_detection_cib_torch.ops import graph as tgraph
from object_detection_cib_torch.train import checkpoint as tck
from object_detection_cib_torch.train import optim as topt
from object_detection_cib_torch.train.steps import make_train_step
from object_detection_cib_torch.train.trainer import METRIC_ROWS, Trainer
from object_detection_cib_tpu.config import engine as j_engine
from object_detection_cib_tpu.data import device_pipeline as jdp
from object_detection_cib_tpu.data import samplers as jsamplers
from object_detection_cib_tpu.data.host_augment import AugParams as JAug
from object_detection_cib_tpu.data.synthetic import build_fake_manifest as j_manifest
from object_detection_cib_tpu.train import optim as jopt
from object_detection_cib_tpu.train.trainer import Trainer as JTrainer

ROOT = Path(__file__).resolve().parents[1]
S, B, N, MAXT = 64, 4, 24, 40


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sampler(mod, info, kind):
    if kind is None:
        return None
    return {"class_aware": lambda: mod.ClassAwareSampler(info, seed=0),
            "repeat_factor": lambda: mod.RepeatFactorSampler(info)}[kind]()


def _jax_pipe(seed=3, sampler=None, aug=None, **kw):
    info = j_manifest(num_images=N, num_classes=3, image_size=S, seed=2)
    return jdp.DeviceDataPipeline(info, target_size=S, batch_size=B, aug_params=aug or JAug(),
                                  max_targets=MAXT, seed=seed, fake_mode=True, device_cache=True,
                                  corpus_layout="planar", sampler=_sampler(jsamplers, info, sampler), **kw)


def _port_pipe(seed=3, sampler=None, aug=None, max_targets=MAXT, **kw):
    info = t_manifest(num_images=N, num_classes=3, image_size=S, seed=2)
    return tdp.DeviceDataPipeline(info, S, B, aug or TAug(), max_targets=max_targets, seed=seed, device="cpu",
                                  sampler=_sampler(tsamplers, info, sampler), **kw)


MODES = {"mosaic": {}, "no_mosaic": dict(use_mosaic=False), "mixup": dict(mixup_prob=0.5)}


# ------------------------------------------------------- (a) the epoch plan

@pytest.mark.parametrize("sampler", [None, "class_aware", "repeat_factor"])
@pytest.mark.parametrize("mode", list(MODES))
def test_epoch_host_arrays_match_jax(mode, sampler):
    jp, tp = _jax_pipe(sampler=sampler, **MODES[mode]), _port_pipe(sampler=sampler, **MODES[mode])
    for _ in range(2):  # the sampler, its pool and pyrng advance alike
        jxs, txs = jp.epoch_host_arrays()[:-1], tp.epoch_host_arrays()  # JAX's keys are not compared
        assert len(txs) == len(jxs) == (2 if mode == "mixup" else 1)
        for t, j in zip(txs, jxs):
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert len(tp.consumed_plan_log) == len(jp.consumed_plan_log) == 2
    for got, want in zip(tp.consumed_plan_log, jp.consumed_plan_log):
        np.testing.assert_array_equal(got, want)


def test_epoch_host_arrays_cut_and_check_the_plan():
    tp = _port_pipe()
    (full,) = tp.epoch_host_arrays()
    (cut,) = _port_pipe().epoch_host_arrays(max_steps=2)
    np.testing.assert_array_equal(cut.numpy(), full.numpy()[:2])
    assert tp.consumed_plan_log[-1].shape == full.shape  # the whole plan is logged
    host_fed = _port_pipe(device_cache=False)
    with pytest.raises(RuntimeError, match="device_cache=True"):
        host_fed.build_fused_epoch_fn(lambda b: b.labels.sum())
    with pytest.raises(ValueError, match="on the card"):
        tp.build_fused_epoch_fn(lambda b: b.labels.sum(), graph=True)


# ------------------------------------------------------- (b) _fused_config

SMALL = ["experiment=yv5n", "dataset_name=fake", "trainer=cpu", "model.net.dtype=null",
         "model.net.widen_factor=0.25", "data.batch_size=4", "data.target_image_size=64",
         "data.num_workers=1", "data.max_targets=40", "callbacks.model_summary=null", "logger=csv",
         "print_config=False", "data.fake_num_images=16"]
DEVICE = ["data.pipeline=device", "data.device_cache=True"]
CONFIGS = {
    "defaults": (DEVICE, True),
    "fused_epoch_false": (DEVICE + ["data.fused_epoch=False"], False),
    "fast_dev_run": (DEVICE + ["trainer.fast_dev_run=True"], False),
    "overfit_batches": (DEVICE + ["trainer.overfit_batches=2"], False),
    "limit_train_batches": (DEVICE + ["trainer.limit_train_batches=0.5"], False),
    "profiler": (DEVICE + ["debug=profiler"], False),
    "profiler_alone": (DEVICE + ["trainer.profiler=torch"], True),
    "host_pipeline": ([], False),
    "device_cache_false": (["data.pipeline=device", "data.device_cache=False"], False),
}


@pytest.mark.parametrize("case", list(CONFIGS))
def test_fused_config_matches_jax(tmp_path, case):
    extra, want = CONFIGS[case]
    overrides = SMALL + [f"paths.output_dir={tmp_path}", *extra]
    cfg = t_engine.compose(ROOT / "configs", "train", overrides)
    assert cfg == j_engine.compose(ROOT / "configs", "train", overrides)
    jax_says = JTrainer._fused_config(SimpleNamespace(cfg=cfg))
    t = Trainer.from_config(cfg)
    # the port's one departure: its profiler traces the fused epoch, where
    # the JAX rule takes the step loop for it (``debug=profiler`` still
    # gets the step loop here, from its debug_nans, in fit)
    departs = case.startswith("profiler")
    assert t._fused_config() == (want or departs) and jax_says == (want and not departs)
    assert (t.fused_pipelined, t.fused_dispatch_ahead) == (True, True)  # configs/data/default.yaml


# ------------------------------------- (c) against the JAX package's fused epoch

def _jax_checksum(state, batch):
    s = (jnp.sum(jnp.round(batch.images.astype(jnp.float32) * 255.0).astype(jnp.int32))
         + jnp.sum(jnp.round(batch.boxes * 16.0).astype(jnp.int32) * batch.mask[..., None])
         + jnp.sum(batch.labels)).astype(jnp.float32)
    return state + s, s


def _checksum(batch, *rows):
    return (torch.round(batch.images.float() * 255.0).to(torch.int32).sum()
            + (torch.round(batch.boxes * 16.0).to(torch.int32) * batch.mask[..., None]).sum()
            + batch.labels.sum()).float()


@pytest.mark.parametrize("pipelined", [False, True])
def test_fused_epoch_matches_jax_where_augment_draws_nothing(pipelined):
    kw = dict(use_mosaic=False)
    jp, tp = _jax_pipe(aug=JAug.no_aug(), **kw), _port_pipe(aug=TAug.no_aug(), **kw)
    images, *rest = tp.device_arrays  # what both epochs gather from; JAX keeps this corpus NHWC
    for t, j in zip([images.permute(0, 2, 3, 1)] + rest, jp.device_arrays, strict=True):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jfn = jp.build_fused_epoch_fn(_jax_checksum, pipelined=pipelined, stack_metrics=True)
    tfn = tp.build_fused_epoch_fn(_checksum, pipelined=pipelined, stack_metrics=True)
    for _ in range(2):
        _, jflat = jfn(jnp.zeros(()), jp.device_arrays, jp.epoch_host_arrays())
        tflat = tfn(tp.epoch_host_arrays())
        assert tflat.shape == (2, N // B) and tflat.dtype == torch.float32
        np.testing.assert_allclose(tflat.numpy(), np.asarray(jflat), rtol=1e-6)
        assert tflat[0].min() > 0


# ------------------------------------------- (d) against the port's step loop

@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_fused_epoch_matches_iterator_stream(mode, pipelined):
    """JAX ``test_fused_epoch_matches_iterator_stream``: the fused epoch's
    batches are the step loop's, same draws and plan, over two epochs."""
    ref, fused = _port_pipe(**MODES[mode]), _port_pipe(**MODES[mode])
    fn = fused.build_fused_epoch_fn(_checksum, pipelined=pipelined)
    for epoch in range(2):
        want = [(_checksum(b), ovf) for b, ovf in ref.epoch()]
        (sums, ovfs) = fn(fused.epoch_host_arrays())
        assert sums.shape == (N // B,) == (len(want),)
        np.testing.assert_array_equal(sums.numpy(), torch.stack([w for w, _ in want]).numpy())
        np.testing.assert_array_equal(ovfs.numpy(), torch.stack([o for _, o in want]).numpy())
        if epoch:
            assert not torch.equal(sums, first)
        first = sums
    assert torch.equal(fused.gen.get_state(), ref.gen.get_state())  # nothing drawn past the epochs


def test_fused_epoch_pipelined_matches_plain():
    a, b = _port_pipe(seed=5, mixup_prob=0.5), _port_pipe(seed=5, mixup_prob=0.5)
    sums_a, ovf_a = a.build_fused_epoch_fn(_checksum)(a.epoch_host_arrays())
    sums_b, ovf_b = b.build_fused_epoch_fn(_checksum, pipelined=True)(b.epoch_host_arrays())
    assert torch.equal(sums_a, sums_b) and torch.equal(ovf_a, ovf_b)


def test_fused_epoch_stack_metrics():
    """One f32[n_leaves + 1, steps] matrix, leaves in the JAX package's
    order (dict keys sorted), overflow last, equal to the unstacked form."""
    def step(batch):
        s = batch.images.float().sum()
        return {"b": s * 2.0, "a": s, "c": batch.labels.sum(), "d": 0.5}

    a, b = _port_pipe(seed=4, max_targets=4), _port_pipe(seed=4, max_targets=4)
    ms, ovf = a.build_fused_epoch_fn(step)(a.epoch_host_arrays())
    flat = b.build_fused_epoch_fn(step, stack_metrics=True)(b.epoch_host_arrays())
    assert list(ms) == ["a", "b", "c", "d"] and flat.shape == (5, N // B)
    want = torch.stack([ms["a"], ms["b"], ms["c"], ms["d"], ovf.float()])
    assert torch.equal(flat, want) and ovf.sum() > 0 and torch.equal(ms["d"], torch.full((N // B,), 0.5))


def _tiny_train(seed=0):
    net = build_network(3, "n", device="cpu", seed=1, dtype=None)
    opt = topt.SmartSGD(net, topt.OptimizerConfig(max_epochs=10), N // B)
    step = make_train_step(net, default_anchors(), FeatureShape(S, S), opt)
    pipe = _port_pipe(seed=seed, feed_dtype=torch.float32, max_targets=6)
    return net, opt, step, pipe


@pytest.mark.parametrize("pipelined", [False, True])
def test_fused_epoch_trains_as_the_step_loop(pipelined):
    """A real train step with SmartSGD's table: the metric matrix (rows
    total, box, obj, cls, lr, assign_drop, overflow) and every parameter
    and statistic bitwise the step loop's, over two epochs."""
    net_a, opt_a, step_a, pipe_a = _tiny_train()
    net_b, opt_b, step_b, pipe_b = _tiny_train()
    fn = pipe_b.build_fused_epoch_fn(step_b, pipelined=pipelined, stack_metrics=True)
    for _ in range(2):
        table = opt_a.hyper_table(opt_a.step_count, N // B)
        want = torch.stack([tdp.metric_column(step_a(b, table[i]), ovf)
                            for i, (b, ovf) in enumerate(pipe_a.epoch())], 1)
        step0 = opt_b.step_count
        got = fn(pipe_b.epoch_host_arrays(), opt_b.hyper_table(step0, N // B))
        assert torch.equal(got, want) and got.shape == (len(METRIC_ROWS) + 1, N // B)
        lrs = [np.float32(opt_b.hyperparams(step0 + i)[1]) for i in range(N // B)]
        np.testing.assert_array_equal(got[METRIC_ROWS.index("lr")].numpy(), lrs)
        assert got[-1].sum() > 0  # max_targets 6 drops targets: the overflow row is live
    for (k, va), vb in zip(net_a.state_dict().items(), net_b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert all(torch.equal(opt_a.buffers[k], opt_b.buffers[k]) for k in opt_a.buffers)
    assert opt_b.step_count == opt_a.step_count == 2 * (N // B)


# --------------------------------------------------- (e) the hyperparameters

@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_hyper_table_matches_jax(schedule):
    """80 steps an epoch and 1.5 warm-up epochs: nw = 120 lies inside the
    two epochs, so the table crosses the warm-up's end."""
    spe, warm = 80, topt.WarmupParams(warmup_epochs=1.5)
    t_opt = topt.SmartSGD(torch.nn.Linear(2, 2), topt.OptimizerConfig(schedule=schedule, max_epochs=5,
                                                                      warmup=warm), spe)
    j_opt = jopt.SmartSGD(jopt.OptimizerConfig(schedule=schedule, max_epochs=5,
                                               warmup=jopt.WarmupParams(warmup_epochs=1.5)), spe)
    assert t_opt.nw == j_opt.nw == 120
    table = t_opt.hyper_table(0, 2 * spe)
    assert table.shape == (2 * spe, 3) and table.dtype == torch.float32
    want = np.asarray([[np.float32(v) for v in j_opt.hyperparams(jnp.asarray(s, jnp.int32))]
                       for s in range(2 * spe)], np.float32)
    np.testing.assert_array_equal(table.numpy(), want)
    np.testing.assert_array_equal(t_opt.hyper_table(spe, spe).numpy(), want[spe:])
    assert want[119, 2] != want[121, 2]  # the momentum's warm-up ends inside the table


# --------------------------------------------------------- launch accounting

def test_launches_in_a_capture_are_counted_by_replay():
    """``count_launch`` adds at once outside a capture and to the capturing
    graph's tally inside one; each replay adds the tally (a stand-in graph:
    capture itself needs the card)."""
    def kernel():
        pass

    kernel.launches = 0
    tgraph.count_launch(kernel)
    assert kernel.launches == 1
    tgraph._capture.tally = tally = {}
    try:
        tgraph.count_launch(kernel)
        tgraph.count_launch(kernel)
    finally:
        tgraph._capture.tally = None
    assert kernel.launches == 1 and tally == {kernel: 2}
    g = object.__new__(tgraph.CapturedGraph)
    g.graph, g.launches, g.replays = SimpleNamespace(replay=lambda: None), tally, 0
    for _ in range(3):
        g.replay()
    assert kernel.launches == 1 + 3 * 2 and g.replays == 3


# ------------------------------------------------ (f) dispatch-ahead, the trainer

def _run(tmp_path, sub, *extra):
    out = tmp_path / sub
    overrides = ["experiment=yv5n", "dataset_name=fake", "data.fake_mode=True", "trainer=cpu",
                 "model.net.dtype=null", "data.batch_size=8", "data.target_image_size=64",
                 "data.max_targets=40", "data.num_workers=2", "data.pipeline=device", "data.device_cache=True",
                 f"paths.output_dir={out}", f"callbacks.model_checkpoint.dirpath={out}/ck",
                 "callbacks.model_checkpoint.every_n_epochs=2", "callbacks.sampler_debug=True",
                 "callbacks.model_summary=null", "logger=csv", f"logger.csv.save_dir={out}/csv",
                 "trainer.max_epochs=4", "trainer.check_val_every_n_epoch=4", "model.net.widen_factor=0.25",
                 "seed=11", "print_config=False", *extra]
    t = Trainer.from_config(t_engine.compose(ROOT / "configs", "train", overrides))
    saves = []
    real_save = t.ckpt.save_last

    def save_last(snap):
        saves.append((t.epoch, tck._clone(snap.to_host())))
        real_save(snap)

    t.ckpt.save_last = save_last
    metrics = t.fit()
    return t, metrics, saves, out


def _timing(key: str) -> bool:
    """A key of a timing (images_per_sec, the fused loop's stage ms), which
    no two runs share."""
    return key == "images_per_sec" or key.startswith("stage_ms")


def _csv_rows(out: Path):
    rows = list(csv.DictReader(open(out / "csv" / "metrics.csv")))
    return [{k: v for k, v in r.items() if not _timing(k)} for r in rows]


def _no_timing(m):
    return {k: v for k, v in m.items() if not _timing(k)}


def test_fused_dispatch_ahead_equivalence(tmp_path):
    """The JAX package's ``test_fused_dispatch_ahead_equivalence``: epoch
    k+1 enqueued before epoch k's fetch reorders nothing. Dispatch-ahead on
    and off, and the step loop, give bitwise equal parameters, the same
    mAP, metrics, CSV log and sampler files; the checkpoint of the
    epoch-2 boundary (taken before epoch 3 was enqueued) holds epoch 2's
    state."""
    runs = {sub: _run(tmp_path, sub, *extra) for sub, extra in (
        ("ahead", ["data.fused_dispatch_ahead=True"]), ("plain", ["data.fused_dispatch_ahead=False"]),
        ("steps", ["data.fused_epoch=False"]))}
    t_a = runs["ahead"][0]
    assert t_a._fused_config() and not runs["steps"][0]._fused_config()
    assert [len(m["total"]) for m in t_a.epoch_metrics] == [8, 8, 8, 8]
    for sub in ("plain", "steps"):
        t_b, m_b, saves_b, out_b = runs[sub]
        for (k, va), vb in zip(t_a.net.state_dict().items(), t_b.net.state_dict().values()):
            assert torch.equal(va, vb), (sub, k)
        assert _no_timing(runs["ahead"][1]) == _no_timing(m_b) and "map" in m_b
        for ea, eb in zip(map(_no_timing, t_a.epoch_metrics), map(_no_timing, t_b.epoch_metrics), strict=True):
            assert ea.keys() == eb.keys() and all(np.array_equal(ea[k], eb[k]) for k in ea), sub
        assert _csv_rows(runs["ahead"][3]) == _csv_rows(out_b)
        for e in range(4):
            name = f"sampler_stats_epoch{e}.json"
            assert (runs["ahead"][3] / name).read_text() == (out_b / name).read_text()
        # the saves: after epochs 2 and 4, the first from the boundary snapshot
        saves_a = runs["ahead"][2]
        assert [e for e, _ in saves_a] == [e for e, _ in saves_b] == [2, 4]
        for (_, sa), (_, sb) in zip(saves_a, saves_b):
            assert sa["optimizer"]["step_count"] == sb["optimizer"]["step_count"]
            for k, v in sa["net"].items():
                assert torch.equal(v, sb["net"][k]), (sub, k)
            for k, v in sa["optimizer"]["momentum"].items():
                assert torch.equal(v, sb["optimizer"]["momentum"][k]), (sub, k)
    first = runs["ahead"][2][0][1]
    assert first["optimizer"]["step_count"] == 2 * t_a.steps_per_epoch
    assert not all(torch.equal(v, t_a.net.state_dict()[k]) for k, v in first["net"].items())
    assert json.loads((runs["ahead"][3] / "sampler_stats_epoch3.json").read_text())
