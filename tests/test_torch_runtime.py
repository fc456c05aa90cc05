"""Port parity: the runtime — ``Trainer.from_config``, one host-fed step,
``fit``'s control flow, early stopping, checkpoints and resume, loggers.

At a small size on the CPU: yolov5n (``model.net.widen_factor=0.25``), 64
px, B = 4, ``trainer=cpu``, ``model.net.dtype=null`` (f32 on both sides),
``data.num_workers=1`` (the host dataset's stream is reproducible with one
thread). Tolerances:
  * ``Trainer.from_config`` against the JAX ``Trainer(cfg)``: exact;
  * the first host-fed batch: byte-equal; one train step from converted
    weights: losses rtol 1e-4, every parameter and BatchNorm statistic atol
    1e-5 + rtol 1e-4 (``tests/test_torch_train.py``'s). The fake images of
    both packages are seeded by a stable digest of the sample id (``hash``
    of a ``str`` is salted per process), so every run sees the same batch.
    The JAX step runs with flax's two-pass batch variance
    (``use_fast_variance=False``) and the plain 6x6/2 stem: flax's default
    ``E[x^2] - E[x]^2`` in f32 loses digits on mosaic batches, whose fill
    regions give channels a large mean and a small variance, and the
    space-to-depth stem sums in another order; both are the same function
    in exact arithmetic. ``test_f64_step_backs_the_two_pass_reference``
    keeps the witness: against the port's f64 step (the network, its
    BatchNorm and SmartSGD in f64; the loss's own f32 casts stay), the
    port's f32 step is within the tolerance and the default-variance JAX
    step more than 10x farther;
  * fit's counts, early stopping, checkpoints, resume and the CSV file:
    exact; TensorBoard scalars read back equal.
The counts of ``fit`` are held against the JAX trainer's formulas
(``object_detection_cib_tpu/train/trainer.py:979-980, :1134-1138,
:790-797, :911-917, :1228``) with a stand-in train step, which leaves the
control flow and the feeds as they are and skips the network's backward.
"""

import csv
import hashlib
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from object_detection_cib_torch.config import engine as t_engine
from object_detection_cib_torch.models.convert import flax_to_torch
from object_detection_cib_torch.train import checkpoint as tck
from object_detection_cib_torch.train.steps import StepMetrics
from object_detection_cib_torch.train.trainer import Trainer, plan_instance_counts
from object_detection_cib_torch.utils import loggers as tlog
from object_detection_cib_tpu.config import engine as j_engine
from object_detection_cib_tpu.train.trainer import Trainer as JTrainer
from object_detection_cib_tpu.utils import loggers as jlog

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs"
SMALL = ["experiment=yv5n", "dataset_name=fake", "trainer=cpu", "model.net.dtype=null",
         "model.net.widen_factor=0.25", "data.batch_size=4", "data.target_image_size=64",
         "data.num_workers=1", "data.max_targets=40", "callbacks.model_summary=null", "logger=csv",
         "print_config=False", "model.net.stem_space_to_depth=false", "model.val_nms_max_candidates=256"]
DEVICE = ["data.pipeline=device", "data.device_cache=True"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These small CPU runs gain little from torch's intra-op threads, and
    beside other test workers those threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compose(engine, out: Path, *extra):
    return engine.compose(CONFIGS, "train", SMALL + [f"paths.output_dir={out}", *extra])


def _port(tmp_path, *extra) -> Trainer:
    return Trainer.from_config(_compose(t_engine, tmp_path, *extra))


# ---------------------------------------------------- from_config, one step

RECIPES = {
    "default": (),
    "class_aware_weights_offset5": ("experiment=imbalance/class_aware/default", "+data.sampler.seed=7",
                                    "use_loss_weights=True", "assigners.offset_capacity=5"),
}


def _stable_hash(key) -> int:
    """A digest of the sample id, the same in every process (``hash`` of a
    ``str`` is salted per process), for the fake images of both readers."""
    return int.from_bytes(hashlib.blake2b(str(key).encode(), digest_size=8).digest(), "little")


@pytest.fixture(scope="module", params=list(RECIPES))
def pair(request, tmp_path_factory):
    """(JAX Trainer(cfg), port Trainer.from_config(cfg), recipe, flax's own
    ``_compute_stats``) for one recipe. While the fixture lives, the fake
    images of both packages are seeded by a stable digest of the sample id,
    and the JAX BatchNorm computes flax's two-pass variance."""
    import flax.linen.normalization as fnorm

    from object_detection_cib_torch.data import reader as t_reader
    from object_detection_cib_tpu.data import reader as j_reader

    extra = RECIPES[request.param]
    root = tmp_path_factory.mktemp(request.param)
    jcfg = _compose(j_engine, root / "jax", *extra)
    assert _compose(t_engine, root / "jax", *extra) == jcfg
    stats = fnorm._compute_stats
    with pytest.MonkeyPatch.context() as mp:
        for mod in (t_reader, j_reader):
            mp.setattr(mod, "hash", _stable_hash, raising=False)
        mp.setattr(fnorm, "_compute_stats", lambda *a, **k: stats(*a, **{**k, "use_fast_variance": False}))
        yield JTrainer(jcfg), _port(root / "port", *extra), request.param, stats


def _levels(anchors):
    return [(a.stride, a.as_array().tolist()) for a in anchors.levels()]


def test_from_config_matches_jax(pair):
    jt, t, recipe, _ = pair
    mcfg = jt.cfg["model"]
    assert tuple(t.optimizer.config) == tuple(jt.optimizer.config)
    assert t.optimizer.nw == jt.optimizer.nw and t.steps_per_epoch == jt.steps_per_epoch == 16
    assert tuple(t.loss_params) == tuple(jt.loss_params)
    assert _levels(t.anchors) == _levels(jt.anchors)
    assert t.evaluator.nms == dict(conf_thres=float(mcfg.get("val_nms_conf_threshold", 0.001)),
                                   iou_thres=float(mcfg.get("val_nms_iou_threshold", 0.6)),
                                   max_det=300, max_nms=int(mcfg.get("val_nms_max_candidates", 2048)))
    assert (t.assign_threshold, t.assign_offset_capacity) == (jt.assign_threshold, jt.assign_offset_capacity)
    assert t.assign_offset_capacity == (5 if recipe != "default" else 3)
    if jt.class_weights is None:
        assert t.class_weights is None
    else:
        np.testing.assert_array_equal(t.class_weights.numpy(), np.asarray(jt.class_weights))
    assert (t.classes, t.batch_size, t.max_targets, t.num_workers, t.image_shape, t.max_epochs) == (
        jt.classes, jt.batch_size, jt.max_targets, jt.num_workers, jt.image_shape, jt.max_epochs)
    assert type(t.sampler).__name__ == type(jt.sampler).__name__
    assert (t.ckpt.monitor, t.ckpt.mode, t.ckpt_every_n_epochs) == (jt.ckpt.monitor, jt.ckpt.mode,
                                                                    jt.ckpt_every_n_epochs)
    assert (t.early_stopping.patience, t.sampler_debug) == (jt.es_patience, jt.sampler_debug)
    assert t.prefetcher is not None and t.pipeline is None  # configs/data/default.yaml: pipeline host
    hp = json.loads((t.out_dir / "hparams.json").read_text())
    assert hp == json.loads((jt.out_dir / "hparams.json").read_text())


def _torch_state(jstate) -> dict:
    """The port's ``state_dict`` of a JAX train state, as numpy copies."""
    tree = jax.tree.map(lambda a: np.array(a, copy=True),
                        {"params": jstate.params, "batch_stats": jstate.batch_stats})
    return {k: v.numpy() for k, v in flax_to_torch(tree).items()}


@pytest.fixture(scope="module")
def first_step(pair):
    """The first batch of both host feeds and one train step of each
    package from the JAX trainer's initial weights, converted."""
    jt, t, _, _ = pair
    state = jt.state
    init_state = jax.tree.map(lambda a: np.array(a, copy=True), state)  # the jitted step donates ``state``
    init = _torch_state(state)
    t.net.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    feed = iter(jt._train_prefetcher())
    jb = jax.tree.map(lambda a: np.array(a, copy=True), next(feed))
    feed.close()
    tb, _ = next(t._train_batches(1))
    tb = type(tb)(*(x.clone() for x in tb))
    jstate, jm = jt.train_step(state, jb)
    tm = t.train_step(tb)
    return dict(init=init, init_state=init_state, jb=jb, tb=tb, jm=jm, tm=tm, jax=_torch_state(jstate),
                port={k: v.detach().numpy().copy() for k, v in t.net.state_dict().items()},
                jstep=int(jstate.step))


def test_first_host_fed_step_matches_jax(pair, first_step):
    _, t, _, _ = pair
    jb, tb, jm, tm = (first_step[k] for k in ("jb", "tb", "jm", "tm"))
    for name in ("images", "boxes", "labels", "mask"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)
    for name in ("total", "box", "obj", "cls"):
        np.testing.assert_allclose(float(getattr(tm, name)), float(getattr(jm, name)), rtol=1e-4, err_msg=name)
    assert tm.lr == pytest.approx(float(jm.lr), rel=1e-6)
    assert int(tm.assign_drop) == int(jm.assign_drop) == 0
    want, got = first_step["jax"], first_step["port"]
    assert set(got) == set(want)
    for name, v in want.items():
        np.testing.assert_allclose(got[name], v, atol=1e-5, rtol=1e-4, err_msg=name)
    assert t.optimizer.step_count == first_step["jstep"] == 1


def _worst_share_of_tolerance(got: dict, ref: dict) -> float:
    """max over every element of |got - ref| / (1e-5 + 1e-4 |ref|): 1 is the
    edge of the parity tolerance."""
    return max(float((np.abs(got[k].astype(np.float64) - r) / (1e-5 + 1e-4 * np.abs(r))).max())
               for k, r in ref.items())


def test_f64_step_backs_the_two_pass_reference(pair, first_step, monkeypatch):
    """Why the JAX reference above runs flax's two-pass batch variance: on
    the same batch from the same weights, the port's f32 step lies within
    the parity tolerance of the port's f64 step, while the JAX step with
    flax's default ``E[x^2] - E[x]^2`` variance lies farther from it than
    the port's f32 step does, and farther than the two-pass JAX step."""
    import copy

    import flax.linen.normalization as fnorm

    from object_detection_cib_torch.train.optim import SmartSGD
    from object_detection_cib_torch.train.steps import make_train_step

    jt, t, _, flax_stats = pair
    init = first_step["init"]
    net = copy.deepcopy(t.net).double()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    opt = SmartSGD(net, t.optimizer.config, t.steps_per_epoch)
    step = make_train_step(net, t.anchors, t.image_shape, opt, t.loss_params,
                           None if t.class_weights is None else t.class_weights.double(),
                           t.assign_threshold, t.assign_offset_capacity, t.assign_compact_slots)
    tb = first_step["tb"]
    step(type(tb)(tb.images.double(), tb.boxes.double(), tb.labels, tb.mask))
    f64 = {k: v.detach().numpy() for k, v in net.state_dict().items()}

    monkeypatch.setattr(fnorm, "_compute_stats", flax_stats)  # flax as it ships
    # a new function to trace: jit caches the trace of ``_train_step_raw``
    jstate, _ = jax.jit(lambda s, b: jt._train_step_raw(s, b))(first_step["init_state"], first_step["jb"])
    fast = _torch_state(jstate)

    port = first_step["port"]
    for name, v in f64.items():
        np.testing.assert_allclose(port[name], v, atol=1e-5, rtol=1e-4, err_msg=name)
    err = {name: _worst_share_of_tolerance(got, f64)
           for name, got in (("port", port), ("jax_two_pass", first_step["jax"]), ("jax_fast", fast))}
    print(f"worst |step - f64 step| / (1e-5 + 1e-4 |f64 step|): {err}")
    assert err["jax_fast"] > 10 * err["port"] and err["jax_fast"] > err["jax_two_pass"], err


# ------------------------------------------------------- fit's control flow

def _stub(t: Trainer, counts: dict):
    """Count train steps (a stand-in step that only moves the step count) and
    eval-step batches (the real eval step)."""
    zero = torch.zeros(())

    def step(batch, hp=None):
        counts["train"] += 1
        counts.setdefault("images", []).append(batch.images)
        t.optimizer.step_count += 1
        return StepMetrics(zero, zero, zero, zero, 0.0, torch.zeros((), dtype=torch.int64))

    real_eval = t.evaluator.eval_step

    def eval_step(images):
        counts["val"] += 1
        return real_eval(images)

    t.train_step = step
    t.evaluator.eval_step = eval_step
    real_validate = t.validate

    def validate():
        counts["validations"] += 1
        return real_validate()

    t.validate = validate


def _jax_counts(spe, val_batches, *, max_epochs, fdr=False, limit=None, limit_val=None, val_every=1,
                overfit=None):
    """(train steps per epoch, validations, val batches per validation), as
    the JAX trainer computes them (:979-980, :1134-1138, :1228, :790-797)."""
    epochs = 1 if fdr else max_epochs
    n = 1 if fdr else (max(int(spe * float(limit)), 1) if limit else spe)
    if overfit:
        n = min(int(overfit), n)
    nv = 1 if fdr else (max(int(val_batches * float(limit_val)), 1) if limit_val else val_batches)
    validations = sum(1 for e in range(epochs) if (e + 1) % val_every == 0 or fdr)
    return [n] * epochs, validations, nv


FIT_CASES = {
    "fast_dev_run": (["trainer.fast_dev_run=True"], dict(max_epochs=300, fdr=True)),
    "limit_fractions": (["trainer.max_epochs=2", "trainer.limit_train_batches=0.4",
                         "trainer.limit_val_batches=0.5"], dict(max_epochs=2, limit=0.4, limit_val=0.5)),
    "limit_preset": (["debug=limit"], dict(max_epochs=3, limit=0.01, limit_val=0.05)),
    "check_val_every_2_of_3": (["trainer.max_epochs=3", "trainer.check_val_every_n_epoch=2"],
                               dict(max_epochs=3, val_every=2)),
    "overfit_3": (["trainer.max_epochs=2", "trainer.overfit_batches=3"], dict(max_epochs=2, overfit=3)),
}


@pytest.mark.parametrize("feed", ["device_cache", "host"])
@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_counts_match_jax_formulas(tmp_path, case, feed):
    extra, kw = FIT_CASES[case]
    feed_ov = DEVICE if feed == "device_cache" else []
    debug = [o for o in extra if o.startswith("debug=")]
    t = _port(tmp_path, *(debug + ["data.fake_num_images=20"] + feed_ov
                          + [o for o in extra if not o.startswith("debug=")]))
    counts = {"train": 0, "val": 0, "validations": 0}
    _stub(t, counts)
    t.fit()
    per_epoch, validations, nv = _jax_counts(5, 5, **kw)  # 20 train and 20 val images
    assert [len(m["total"]) for m in t.epoch_metrics] == per_epoch
    assert counts["train"] == sum(per_epoch) and t.optimizer.step_count == sum(per_epoch)
    assert counts["validations"] == validations
    assert counts["val"] == validations * nv
    assert (t.val_cache is not None) == (feed == "device_cache")
    if case == "overfit_3":  # the same three batches, replayed
        imgs = counts["images"]
        assert all(imgs[i] is imgs[i + 3] for i in range(3))
    assert (t.out_dir / "checkpoints" / "last").exists()


def test_c1_validation_cadence_and_fractions(tmp_path):
    """C1: ``check_val_every_n_epoch=2`` over 2 epochs validates once, and
    ``limit_*_batches`` are JAX's fractions, not counts."""
    t = _port(tmp_path, *DEVICE, "data.fake_num_images=20", "trainer.max_epochs=2",
              "trainer.check_val_every_n_epoch=2", "trainer.limit_train_batches=0.5",
              "trainer.limit_val_batches=0.5")
    counts = {"train": 0, "val": 0, "validations": 0}
    _stub(t, counts)
    m = t.fit()
    assert counts == {"train": 4, "val": 2, "validations": 1, "images": counts["images"]}
    assert "map" in m and len(t.epoch_metrics) == 2
    with pytest.raises(ValueError, match="horizon"):
        t.fit(max_epochs=3)
    assert t.fit() == {}  # at the horizon


def test_plain_fit_keeps_its_integer_step_cap(tmp_path):
    t = _port(tmp_path, *DEVICE, "trainer.max_epochs=1")
    counts = {"train": 0, "val": 0, "validations": 0}
    _stub(t, counts)
    t.fit(epoch_steps=3)
    assert counts["train"] == 3 and counts["validations"] == 1


def test_log_every_n_steps_reads_the_epoch_copy(tmp_path):
    """The loggers get every n-th step's losses, as the train step returned
    them, from the one per-epoch copy; the overflow warning logs the drops."""
    t = _port(tmp_path, *DEVICE, "data.fake_num_images=24", "trainer.max_epochs=2",
              "trainer.log_every_n_steps=4", "trainer.check_val_every_n_epoch=2", "data.max_targets=4")
    t.fit()
    rows = list(csv.DictReader(open(t.out_dir / "csv" / "metrics.csv")))
    steps = [int(r["step"]) for r in rows if r.get("total")]
    assert steps == [4, 8, 12]
    for r in rows:
        if r.get("total"):
            e, i = divmod(int(r["step"]) - 1, t.steps_per_epoch)
            assert float(r["total"]) == float(t.epoch_metrics[e]["total"][i])
            assert float(r["lr"]) == float(t.epoch_metrics[e]["lr"][i])
    dropped = [float(r["targets_dropped"]) for r in rows if r.get("targets_dropped")]
    assert dropped == [float(m["targets_dropped"]) for m in t.epoch_metrics] and sum(dropped) > 0
    assert sum(1 for r in rows if r.get("map")) == 1


def test_sampler_debug_files_count_the_trained_plan(tmp_path):
    t = _port(tmp_path, "experiment=imbalance/class_aware/default", *DEVICE, "+data.sampler.seed=7",
              "data.fake_num_images=24", "trainer.max_epochs=2", "trainer.limit_train_batches=0.5",
              "callbacks.sampler_debug=True", "trainer.check_val_every_n_epoch=5")
    plans = []
    real = t.pipeline._epoch_plan

    def spy():
        out = real()
        plans.append(t.pipeline.consumed_plan_log[-1])
        return out

    t.pipeline._epoch_plan = spy
    _stub(t, {"train": 0, "val": 0, "validations": 0})
    t.fit()
    for epoch in range(2):
        got = json.loads((t.out_dir / f"sampler_stats_epoch{epoch}.json").read_text())
        assert got == plan_instance_counts(t.train_info, plans[epoch][:3]) and sum(got.values()) > 0


def test_profiler_traces_the_window(tmp_path):
    t = _port(tmp_path, *DEVICE, "debug=profiler", "data.fake_num_images=24", "trainer.profile_start_step=1",
              "trainer.profile_steps=2", "trainer.check_val_every_n_epoch=5")
    _stub(t, {"train": 0, "val": 0, "validations": 0})
    t.fit()
    trace = t.out_dir / "profile" / "steps_1-3.pt.trace.json"
    assert json.loads(trace.read_text())["traceEvents"]
    assert t.debug_nans and not torch.is_anomaly_enabled()  # anomaly mode only inside fit


def test_predict_over_the_host_feed(tmp_path):
    t = _port(tmp_path, "train=False", "data.fake_num_images=8")
    out = t.predict(tmp_path / "predictions.json")
    assert len(out) == len(t.val_info.samples) == 8
    assert json.loads((tmp_path / "predictions.json").read_text()) == out
    assert set(out[0]) == {"boxes", "scores", "classes"} and t.pipeline is None and t.prefetcher is None
    with pytest.raises(RuntimeError, match="without a training set"):
        t.fit()


REFUSED = {
    "model.remat_policy=conv_out": "model.remat_policy",
    "trainer.num_devices=2": "trainer.num_devices",  # two ranks: cli.train launches them
    "data.corpus_sharding=sharded": "data.corpus_sharding",  # the host pipeline has no corpus to shard
    "data.warp_pallas=False": "data.warp_pallas",
    "trainer.platform=mps": "trainer.platform",
}


@pytest.mark.parametrize("override", list(REFUSED))
def test_unported_keys_raise_naming_the_key(tmp_path, override):
    with pytest.raises((NotImplementedError, ValueError), match=REFUSED[override].replace(".", r"\.")):
        _port(tmp_path, override)


def test_flat_corpus_layout_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="corpus_layout='flat'"):
        _port(tmp_path, *DEVICE, "data.corpus_layout=flat")


def test_ignored_keys_are_named(tmp_path, capsys):
    _port(tmp_path, "trainer.max_epochs=1")
    out = capsys.readouterr().out
    for key in ("model.net.stem_space_to_depth", "trainer.compile_cache", "trainer.deterministic"):
        assert key in out
    for key in ("data.fused_epoch", "data.fused_pipelined", "data.fused_dispatch_ahead"):
        assert key not in out  # acted on: they select the loop (tests/test_torch_fused.py)


# --------------------------------------------------------- early stopping

def _es_trainer(tmp_path, values, monkeypatch, *es):
    """A tiny trainer whose validate replays ``values`` (the JAX package's
    ``tests/test_sampler_debug_es.py`` arrangement)."""
    t = _port(tmp_path, *DEVICE, "data.fake_num_images=8", f"trainer.max_epochs={len(values)}",
              "callbacks=early_stopping", *es)
    _stub(t, {"train": 0, "val": 0, "validations": 0})
    seen = []

    def fake_validate():
        seen.append(len(seen))
        return {"map": float(values[len(seen) - 1])}

    monkeypatch.setattr(t, "validate", fake_validate)
    return t, seen


ES_CASES = {
    "patience_max_mode": ([0.5, 0.4, 0.4, 0.4, 0.9, 0.9], ["callbacks.early_stopping.patience=3"], 4),
    "min_delta": ([0.5, 0.52, 0.54, 0.56, 0.9], ["callbacks.early_stopping.patience=2",
                                                  "callbacks.early_stopping.min_delta=0.1"], 3),
    "min_mode": ([0.5, 0.4, 0.6, 0.6, 0.3, 0.3], ["callbacks.early_stopping.patience=2",
                                                  "callbacks.early_stopping.mode=min"], 4),
    "check_finite": ([0.5, float("nan"), 0.9, 0.9], ["callbacks.early_stopping.patience=10",
                                                      "callbacks.early_stopping.check_finite=True"], 2),
}


@pytest.mark.parametrize("case", list(ES_CASES))
def test_early_stopping(tmp_path, monkeypatch, case):
    values, es, checks = ES_CASES[case]
    t, seen = _es_trainer(tmp_path, values, monkeypatch, *es)
    t.fit()
    assert len(seen) == checks and t.epoch == checks


def test_early_stopping_drains_the_checkpoint_writer(tmp_path, monkeypatch):
    t, seen = _es_trainer(tmp_path, [0.5, 0.4, 0.4], monkeypatch, "callbacks.early_stopping.patience=2")
    drained = []
    orig = tck.CheckpointManager.wait_until_finished
    monkeypatch.setattr(tck.CheckpointManager, "wait_until_finished",
                        lambda self: (drained.append(1), orig(self))[1])
    t.fit()
    assert len(seen) == 3 and drained
    state = tck.load_state(t.ckpt.directory / "last")
    assert state["optimizer"]["step_count"] == t.optimizer.step_count == 3 * t.steps_per_epoch


# ------------------------------------------------------------ checkpoints

@pytest.fixture
def net_opt():
    from object_detection_cib_torch.models.yolov5 import build_network
    from object_detection_cib_torch.train.optim import OptimizerConfig, SmartSGD

    net = build_network(3, "n", device="cpu", seed=1)
    opt = SmartSGD(net, OptimizerConfig(max_epochs=10), 10)
    g = torch.Generator().manual_seed(0)
    for b in opt.buffers.values():
        b.copy_(torch.randn(b.shape, generator=g))
    for name, buf in net.named_buffers():
        buf.add_(torch.rand(buf.shape, generator=g))
    opt.step_count = 7
    return net, opt


def _state(net, opt):
    return ({k: v.clone() for k, v in net.state_dict().items()},
            {k: v.clone() for k, v in opt.buffers.items()}, opt.step_count)


def _clobber(net, opt):
    with torch.no_grad():
        for t in list(net.state_dict().values()) + list(opt.buffers.values()):
            t.mul_(0).sub_(1)
    opt.step_count = 0


def _equal(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a[:2], b[:2]) for k in x) and a[2] == b[2]


def test_save_restore_roundtrip(tmp_path, net_opt):
    net, opt = net_opt
    want = _state(net, opt)
    cm = tck.CheckpointManager(tmp_path / "ck")
    cm.save_last(tck.Snapshot(net, opt))
    _clobber(net, opt)
    cm.restore(net, opt, "last")
    assert _equal(_state(net, opt), want)
    _clobber(net, opt)
    tck.restore_checkpoint(tmp_path / "ck" / "last", net, opt)  # the ckpt_path flag
    assert _equal(_state(net, opt), want)
    with pytest.raises(IsADirectoryError, match="Orbax"):
        tck.restore_checkpoint(tmp_path / "ck", net, opt)


def test_best_tracking(tmp_path, net_opt):
    net, opt = net_opt
    cm = tck.CheckpointManager(tmp_path / "ck", monitor="map", mode="max")
    snap = tck.Snapshot(net, opt)
    assert cm.maybe_save_best(snap, {"map": 0.3})
    assert not cm.maybe_save_best(snap, {"map": 0.2})
    assert cm.maybe_save_best(snap, {"map": 0.5})
    assert cm.best_value == 0.5
    cm.wait_until_finished()
    assert json.loads((tmp_path / "ck" / "meta.json").read_text()) == {"best_value": 0.5, "monitor": "map"}
    cm2 = tck.CheckpointManager(tmp_path / "ck", monitor="map", mode="max")
    assert cm2.best_value == 0.5
    assert not cm2.maybe_save_best(snap, {"map": 0.4})
    assert (tmp_path / "ck" / "best").is_file() and not (tmp_path / "ck" / "last").exists()


def test_missing_monitor_ignored(tmp_path, net_opt):
    cm = tck.CheckpointManager(tmp_path / "ck")
    assert not cm.maybe_save_best(tck.Snapshot(*net_opt), {"loss": 1.0})


def test_background_save_reads_the_snapshot_not_the_live_state(tmp_path, net_opt):
    """The optimizer updates in place right after ``save_last``: the file
    still holds the values at the save."""
    net, opt = net_opt
    want = _state(net, opt)
    cm = tck.CheckpointManager(tmp_path / "ck")
    cm.save_last(tck.Snapshot(net, opt))
    _clobber(net, opt)  # in place, before the writer has run
    cm.wait_until_finished()
    cm.restore(net, opt)
    assert _equal(_state(net, opt), want)


def test_background_saves_queue_in_order(tmp_path, net_opt):
    net, opt = net_opt
    cm = tck.CheckpointManager(tmp_path / "ck")
    cm.save_last(tck.Snapshot(net, opt))
    with torch.no_grad():
        for p in net.parameters():
            p.add_(1)
    opt.step_count += 1
    second = _state(net, opt)
    cm.save_last(tck.Snapshot(net, opt))
    cm.wait_until_finished()
    _clobber(net, opt)
    cm.restore(net, opt)
    assert _equal(_state(net, opt), second)


def test_resume_goes_on_from_the_checkpoint(tmp_path):
    """After ``ckpt_path``, the step count and the lr of every next step equal
    the uninterrupted run's."""
    common = (*DEVICE, "data.fake_num_images=8", "trainer.max_epochs=2", "trainer.check_val_every_n_epoch=2")
    whole = _port(tmp_path / "whole", *common)
    whole.fit()
    first = _port(tmp_path / "first", *common)
    first.fit(max_epochs=1)
    last = tmp_path / "first" / "checkpoints" / "last"
    saved = tck.load_state(last)
    resumed = _port(tmp_path / "resumed", *common, f"ckpt_path={last}")
    assert resumed.epoch == 1 and resumed.optimizer.step_count == saved["optimizer"]["step_count"] == 2
    for k, v in resumed.net.state_dict().items():
        assert torch.equal(v, saved["net"][k])
    for k, v in resumed.optimizer.buffers.items():
        assert torch.equal(v, saved["optimizer"]["momentum"][k])
    resumed.fit()
    assert len(resumed.epoch_metrics) == 1 and resumed.optimizer.step_count == 4
    np.testing.assert_array_equal(resumed.epoch_metrics[0]["lr"], whole.epoch_metrics[1]["lr"])


# ---------------------------------------------------------------- loggers

CALLS = [({"loss": 1.0}, 0), ({"loss": 0.5, "map": 0.1}, 1), ({"box": 0.25}, 5), ({"loss": 1 / 3}, 7)]


def test_csv_file_is_jax_byte_for_byte(tmp_path):
    for mod, d in ((tlog, tmp_path / "t"), (jlog, tmp_path / "j")):
        lg = mod.CSVLogger(d)
        for m, s in CALLS[:2]:
            lg.log(m, s)
        lg = mod.CSVLogger(d)  # resume-append: a new logger on the same file
        for m, s in CALLS[2:]:
            lg.log(m, s)
    got = (tmp_path / "t" / "metrics.csv").read_bytes()
    assert got == (tmp_path / "j" / "metrics.csv").read_bytes() and got.count(b"\n") == 5


def test_tensorboard_scalars_equal_jax(tmp_path):
    """Both loggers in one process: building the port's leaves tensorboard
    bound as ``torch.utils.tensorboard`` binds it (here to TensorFlow, which
    the JAX logger's summaries need), with no stub of its own."""
    tlg = tlog.TensorBoardLogger(tmp_path / "t")
    assert "tensorboard.compat.notf" not in sys.modules
    jlg = jlog.TensorBoardLogger(tmp_path / "j")
    for lg in (tlg, jlg):
        for m, s in CALLS:
            lg.log(m, s)
    tlg.finalize()
    jlg.writer.close()
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    from tensorboard.util import tensor_util

    def scalars(d):
        ea = EventAccumulator(str(d))
        ea.Reload()
        return {tag: [(e.step, float(tensor_util.make_ndarray(e.tensor_proto))) for e in ea.Tensors(tag)]
                for tag in ea.Tags()["tensors"]}

    got = scalars(tmp_path / "t")
    assert got == scalars(tmp_path / "j") and set(got) == {"loss", "map", "box"}


@pytest.fixture
def no_clients(monkeypatch):
    """The wandb and mlflow clients made absent, whatever is installed."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "mlflow", None)


def test_wandb_offline_run_dir_matches_jax(tmp_path, no_clients):
    for mod, d in ((tlog, tmp_path / "t"), (jlog, tmp_path / "j")):
        lg = mod.WandbLogger(d, project="proj", name="t1", tags=["a"])
        for m, s in CALLS:
            lg.log(m, s)
        lg.finalize()
    rel = Path("wandb/offline-run-t1/files")
    for name in ("wandb-history.jsonl",):
        assert (tmp_path / "t" / rel / name).read_bytes() == (tmp_path / "j" / rel / name).read_bytes()
    meta = [json.loads((tmp_path / s / rel / "wandb-metadata.json").read_text()) for s in "tj"]
    assert [{k: v for k, v in m.items() if k != "startedAt"} for m in meta][0] == {
        "project": "proj", "name": "t1", "tags": ["a"], "group": ""} == {
        k: v for k, v in meta[1].items() if k != "startedAt"}


def test_mlflow_filestore_layout_matches_jax(tmp_path, no_clients):
    def layout(mod, root):
        uri = f"file:{root}"
        lg = mod.MLflowLogger(uri, experiment_name="exp-a", run_name="r1")
        for m, s in CALLS:
            lg.log(m, s)
        lg.finalize()
        mod.MLflowLogger(uri, experiment_name="exp-a", run_name="r2").finalize()
        (exp,) = [d for d in root.iterdir() if d.name.isdigit()]
        runs = sorted((d for d in exp.iterdir() if d.is_dir()),
                      key=lambda d: (d / "tags" / "mlflow.runName").read_text())
        metrics = {p.name: [line.split()[1:] for line in p.read_text().splitlines()]
                   for p in sorted((runs[0] / "metrics").iterdir())}
        keys = [[line.split(":")[0] for line in (r / "meta.yaml").read_text().splitlines()] for r in runs]
        return exp.name, (exp / "meta.yaml").read_text().replace(str(root), ""), metrics, keys, [
            "status: 3" in (r / "meta.yaml").read_text() for r in runs]

    got = layout(tlog, tmp_path / "t")
    assert got == layout(jlog, tmp_path / "j") and got[2]["loss"][0] == ["1.0", "0"]


def test_build_loggers_fall_back_to_no_op(tmp_path, no_clients, monkeypatch):
    cfg = {"csv": {"save_dir": str(tmp_path / "csv")}, "wandb": {"save_dir": str(tmp_path)},
           "mlflow": {"tracking_uri": f"file:{tmp_path}/mlruns"}, "other": {}}
    out = tlog.build_loggers(cfg)
    assert [type(lg).__name__ for lg in out] == ["CSVLogger", "WandbLogger", "MLflowLogger", "NoOpLogger"]
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # tensorboard not installed
    with pytest.warns(UserWarning, match="logger 'tensorboard' unavailable"):
        (lg,) = tlog.build_loggers({"tensorboard": {"save_dir": str(tmp_path / "tb")}})
    assert isinstance(lg, tlog.NoOpLogger)
    with pytest.warns(UserWarning, match="logger 'mlflow' unavailable"):
        (lg,) = tlog.build_loggers({"mlflow": {"tracking_uri": "http://localhost:5000"}})
    assert isinstance(lg, tlog.NoOpLogger)
