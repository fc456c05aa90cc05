"""The port's own measurement (``utils/tracing.py``) on the CPU: span
counters, the profiler entry, the fused epoch's stage stamps, the eval
step's spans, and the trainer's reads of them (the logger calls of a fit,
``images_per_sec``, ``device_epoch_walls``, ``trainer.profiler`` on the
fused loop, ``Prefetcher.wait_seconds``). The stamps on the card are
``tests/test_torch_cuda.py``'s."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from object_detection_cib_torch.config import engine as t_engine
from object_detection_cib_torch.core.types import default_anchors
from object_detection_cib_torch.models.yolov5 import build_network
from object_detection_cib_torch.train.steps import make_eval_step
from object_detection_cib_torch.train.trainer import Trainer
from object_detection_cib_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["experiment=yv5n", "dataset_name=fake", "trainer=cpu", "model.net.dtype=null",
         "model.net.widen_factor=0.25", "data.batch_size=4", "data.target_image_size=64",
         "data.num_workers=1", "data.max_targets=40", "callbacks.model_summary=null", "logger=csv",
         "print_config=False", "data.fake_num_images=16", "model.val_nms_max_candidates=256",
         "data.pipeline=device", "data.device_cache=True"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(tmp_path, *extra) -> Trainer:
    return Trainer.from_config(t_engine.compose(ROOT / "configs", "train",
                                                SMALL + [f"paths.output_dir={tmp_path}", *extra]))


def _counter(name: str) -> tracing.Counter:
    return tracing.counters().get(name, tracing.Counter(0, 0))


class _Calls:
    def __init__(self):
        self.calls = []

    def log(self, metrics, step):
        self.calls.append((step, dict(metrics)))


# ------------------------------------------------------------------- spans

def test_counters_add_up_over_nested_spans():
    tracing.reset()
    with tracing.span("outer"):
        for _ in range(3):
            with tracing.span("inner"):
                time.sleep(0.002)
    got = tracing.counters()
    assert got["inner"].calls == 3 and got["outer"].calls == 1
    assert 3 * 2_000_000 <= got["inner"].ns <= got["outer"].ns
    assert "never" not in got
    assert tracing.ms_per_call({}, got, "inner") == pytest.approx(got["inner"].ns / 3 / 1e6)
    tracing.reset()
    assert tracing.counters() == {}


def _event_names(prof) -> list:
    return [e.name for e in prof.events()]


def test_span_enters_record_function_only_under_a_running_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def spy(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    before = _counter("plain.outside")
    with tracing.span("plain.outside") as outside:
        time.sleep(0.001)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("plain.inside"):
            torch.ones(2).sum()
    assert entered == ["plain.inside"]
    names = _event_names(prof)
    assert "plain.inside" in names and "plain.outside" not in names
    # a host counter all the same, and the span's own time
    assert outside.ns >= 1_000_000 and _counter("plain.outside").ns - before.ns == outside.ns


def test_marks_do_nothing_where_no_matrix_is_installed():
    tracing.mark("forward_begin")  # the step loop, the eval step
    m = tracing.stamp_matrix(3, "cpu")
    step = torch.tensor(1, dtype=torch.int64)
    with tracing.stamping(m, step):
        tracing.mark("loss_end")
        tracing.mark("augment_begin", torch.tensor(2, dtype=torch.int64))
        tracing.mark("augment_end", torch.tensor(3, dtype=torch.int64))  # outside the matrix: dropped
    tracing.mark("loss_end")
    row = tracing.MARKS.index
    assert m[row("loss_end"), 1] > 0 and m[row("augment_begin"), 2] > 0
    assert int((m > 0).sum()) == 2
    with pytest.raises(ValueError):
        with tracing.stamping(m.float(), step):
            pass


def test_stage_ms_takes_each_stage_from_its_marks():
    s = np.zeros((len(tracing.MARKS), 3), np.int64)
    r = tracing.MARKS.index
    for i in range(3):
        t = 10_000_000 * (i + 1)
        s[r("augment_begin"), i], s[r("augment_end"), i] = t, t + 5_000_000
        s[r("forward_begin"), i], s[r("forward_end"), i] = t, t + 2_000_000
        s[r("loss_end"), i], s[r("backward_end"), i] = t + 3_000_000, t + 7_000_000
        s[r("optimizer_end"), i] = t + 7_500_000 + 1_000_000 * i
    got = tracing.stage_ms(s)
    assert got == pytest.approx({"augment": 5.0, "forward": 2.0, "loss": 1.0, "backward": 4.0, "optimizer": 1.5})
    s[r("allreduce_end")] = s[r("backward_end")] + 250_000
    got = tracing.stage_ms(s)
    assert got["allreduce"] == pytest.approx(0.25) and got["optimizer"] == pytest.approx(1.25)
    assert tracing.epoch_bounds(s) == (10_000_000, 30_000_000 + 9_500_000)
    assert tracing.epoch_bounds(np.zeros_like(s)) is None


# ------------------------------------------------------ the fused epoch

@pytest.mark.parametrize("pipelined", [True, False])
def test_fused_epoch_fills_its_stamp_matrix_in_stage_order(tmp_path, pipelined):
    t = _trainer(tmp_path)
    fn = t.pipeline.build_fused_epoch_fn(lambda b, hp: t.train_step(b, hp), pipelined=pipelined,
                                         stack_metrics=True)
    xs = t.pipeline.epoch_host_arrays()
    n = int(xs[0].shape[0])
    fn(xs, t.optimizer.hyper_table(0, n))
    s = fn.stamps.numpy()
    assert s.shape == (len(tracing.MARKS), n) and s.dtype == np.int64
    r = {m: s[i] for i, m in enumerate(tracing.MARKS)}
    assert not r["allreduce_end"].any()  # no mesh
    for m in ("augment_begin", "augment_end", "forward_begin", "forward_end", "loss_end", "backward_end",
              "optimizer_end"):
        assert (r[m] > 0).all(), m
    order = ("forward_begin", "forward_end", "loss_end", "backward_end", "optimizer_end")
    for a, b in zip(order, order[1:]):
        assert (r[a] <= r[b]).all(), (a, b)
    assert (r["augment_begin"] <= r["augment_end"]).all()
    assert (np.diff(r["optimizer_end"]) > 0).all()
    made = r["augment_end"][1:] if pipelined else r["augment_end"]  # batch i+1 is made before step i trains
    trained = r["forward_begin"][:-1] if pipelined else r["forward_begin"]
    assert (made <= trained).all()
    assert set(tracing.stage_ms(s)) == {"augment", "forward", "loss", "backward", "optimizer"}


def test_fit_logs_as_often_as_before_with_stage_ms_and_device_time(tmp_path, capsys):
    """Constraint on the loggers: one call every ``log_every_n_steps`` steps,
    one for an epoch's dropped targets, one for each validation, in that
    order, on both loops; the validation's call carries images_per_sec and
    the fused loop's stage ms, which fit's return does not."""
    extra = ("trainer.max_epochs=2", "trainer.log_every_n_steps=2")
    runs = {}
    for loop in ("fused", "steps"):
        t = _trainer(tmp_path / loop, *extra, *(["data.fused_epoch=False"] if loop == "steps" else []))
        t.loggers, t.verbose = [_Calls()], loop == "fused"
        runs[loop] = (t, t.fit(), t.loggers[0].calls)
    t, m, calls = runs["fused"]
    want = []
    for e, em in enumerate(t.epoch_metrics):
        n = len(em["total"])
        want += [(e * n + i + 1, "losses") for i in range(n) if (e * n + i + 1) % 2 == 0]
        want += [((e + 1) * n, "dropped")] if int(em["targets_dropped"]) else []
        want += [((e + 1) * n, "validation")]
    kinds = [(s, "validation" if "map" in c else "dropped" if "targets_dropped" in c else "losses")
             for s, c in calls]
    assert kinds == want
    strip = lambda c: sorted(k for k in c if not k.startswith("stage_ms."))  # noqa: E731
    assert [(s, strip(c)) for s, c in calls] == [(s, strip(c)) for s, c in runs["steps"][2]]
    val = [c for _, c in calls if "map" in c]
    assert all({f"stage_ms.{k}" for k in ("augment", "forward", "loss", "backward", "optimizer")} <= set(c)
               for c in val)
    assert m.keys() == runs["steps"][1].keys() and "images_per_sec" in m
    assert not any(k.startswith("stage_ms") for k in m)
    # images_per_sec from the epoch's stamps; device_epoch_walls between the epochs' last stamps
    assert all(set(em["stage_ms"]) == {"augment", "forward", "loss", "backward", "optimizer"}
               for em in t.epoch_metrics)
    seconds = [t._epoch_seconds(e) for e in range(2)]
    assert [c["images_per_sec"] for c in val] == pytest.approx([t.epoch_imgs[e] / seconds[e] for e in range(2)])
    last = [tracing.epoch_bounds(t._epoch_stamps[e])[1] for e in range(2)]
    assert t.device_epoch_walls() == {1: pytest.approx((last[1] - last[0]) / 1e9)}
    assert 0 < seconds[1] <= t.device_epoch_walls()[1]  # the validation between them is left out
    out = capsys.readouterr().out
    assert "device ms a step: augment" in out and "host ms a batch: forward" in out


def test_profiler_traces_the_fused_epoch(tmp_path):
    t = _trainer(tmp_path, "trainer.profiler=torch", "trainer.profile_start_step=5", "trainer.profile_steps=2",
                 "trainer.max_epochs=3", "trainer.check_val_every_n_epoch=5", "trainer.debug_nans=False")
    assert t._fused_config()
    t.fit()
    assert t._fused_fn is not None
    trace = t.out_dir / "profile" / "steps_5-7.pt.trace.json"
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "train.fetch" in names
    assert t._prof is False


def test_prefetcher_wait_seconds_is_its_own_total(tmp_path):
    """Each wait on a prefetcher's queue is the span ``feed_wait`` and adds
    to that prefetcher's ``wait_seconds`` alone: a reset of the counters and
    another prefetcher's waits leave it as it was."""
    t = _trainer(tmp_path, "data.pipeline=host", "data.device_cache=False", "trainer.max_epochs=1",
                 "trainer.check_val_every_n_epoch=5")
    tracing.reset()
    t.fit()
    train = t.prefetcher
    got = _counter("feed_wait")
    assert got.calls >= t.steps_per_epoch and train.wait_seconds > 0
    assert train.wait_seconds == pytest.approx(got.ns / 1e9)
    waited = train.wait_seconds
    tracing.reset()
    val = t.val_prefetcher()
    n = sum(1 for _ in val)
    again = _counter("feed_wait")
    assert n > 0 and again.calls == n + 1  # each batch and the queue's end
    assert val.wait_seconds == pytest.approx(again.ns / 1e9)
    assert train.wait_seconds == waited


# -------------------------------------------------------- the eval step

def test_eval_step_spans_nest_in_the_callers_span():
    torch.manual_seed(0)
    net = build_network(3, {"deepen_factor": 0.33, "widen_factor": 0.125}, dtype=None, device="cpu")
    step = make_eval_step(net, default_anchors(), max_nms=64)
    images = torch.rand(2, 64, 64, 3)
    before = tracing.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("infer.enqueue"):
            step(images)
    after = tracing.counters()
    spans = {e.name: e for e in prof.events() if e.name.startswith("infer.")}
    assert set(spans) == {"infer.enqueue", "infer.forward", "infer.decode", "infer.nms"}
    outer = spans["infer.enqueue"].time_range
    inner = [spans[k].time_range for k in ("infer.forward", "infer.decode", "infer.nms")]
    assert all(outer.start <= r.start <= r.end <= outer.end for r in inner)
    assert all(a.end <= b.start for a, b in zip(inner, inner[1:]))
    assert all(tracing.ms_per_call(before, after, k) > 0 for k in ("infer.forward", "infer.decode", "infer.nms"))
