"""The readers of the program's stage marks and eval-step spans, on
synthetic records: whole steps inside the window, the next end mark after
each start, the mesh's all-reduce mark, nothing from a program without
them; and no mark's name holds a name another reader matches."""

import re
from pathlib import Path

import pytest

from harness import registry

TRAIN = ("augment", "forward", "loss", "backward", "optimizer")
INFER = ("forward", "decode", "nms")
MARKS_CU = Path(__file__).resolve().parents[2] / "object_detection_cib_torch" / "ops" / "csrc" / "marks.cu"
# the names the accepted readers find kernels by (counts/roofline.py, train_mfu's step kernel)
MATCHED = ("gather_rows_kernel", "warp_quadrants_kernel", "hsv_planar_kernel", "pair_kernel", "scan_kernel")


def _mark(stage, a, dur=2e-6):
    return (f"(anonymous namespace)::mark_{stage}_kernel(long long*, long long const*, long long)", a, a + dur)


def _train_record(steps=5, period=0.1, mesh=False, window=0.48, forward=None):
    """Steps of ``period`` s from -0.05 s: augment 0.02 s on its own stream,
    forward 0.03 (or ``forward[i]``), loss 0.01, backward 0.04, (all-reduce
    0.002,) optimizer 0.005 (each from the end of its start mark)."""
    kernels = [("gather_rows_kernel", 0.0, 0.001)]
    for i in range(steps):
        t = -0.05 + period * i
        kernels += [_mark("augment_begin", t), _mark("augment_end", t + 2e-6 + 0.02)]
        fwd = 0.03 if forward is None else forward[i]
        ends = [("forward_begin", 0.0), ("forward_end", fwd), ("loss_end", 0.01), ("backward_end", 0.04)]
        ends += [("allreduce_end", 0.002)] if mesh else []
        ends += [("optimizer_end", 0.005)]
        for stage, dt in ends:
            t += dt
            kernels.append(_mark(stage, t))
            t += 2e-6
    return {"kind": "train", "kernels": kernels, "window_s": window, "spans": []}


@pytest.mark.parametrize("mesh", [False, True])
def test_stage_readers_take_whole_steps_inside_the_window(mesh):
    record = _train_record(mesh=mesh)
    got = {s: registry.reader(f"stage_ms.train.{s}")(record) for s in TRAIN}
    want = {"augment": 20.0, "forward": 30.0, "loss": 10.0, "backward": 40.0, "optimizer": 5.0}
    assert got == pytest.approx(want, abs=1e-6)
    # the first step's forward began before the window, the last's ends after it: neither counts
    cut = _train_record(steps=3, period=0.4, mesh=mesh, window=0.8, forward=[0.3, 0.03, 0.3])
    assert registry.reader("stage_ms.train.forward")(cut) == pytest.approx(30.0, abs=1e-6)
    assert registry.reader("stage_ms.train.loss")(cut) == pytest.approx(10.0, abs=1e-6)


def test_stage_reader_pairs_each_start_with_the_next_end():
    """A step whose end mark is missing gives no gap, and does not borrow
    the next step's."""
    record = _train_record(steps=3, window=1.0)
    record["kernels"] = [k for k in record["kernels"]
                         if not ("mark_forward_end_kernel" in k[0] and 0.05 < k[1] < 0.1)]
    assert registry.reader("stage_ms.train.forward")(record) == pytest.approx(30.0, abs=1e-6)  # not (30 + 130) / 2


def test_infer_span_readers_take_the_median_inside_the_window():
    spans = [("infer.enqueue", 0.0, 0.02), ("infer.forward", 0.001, 0.011), ("infer.decode", 0.011, 0.012),
             ("infer.nms", 0.012, 0.015), ("infer.enqueue", 0.03, 0.05), ("infer.forward", 0.031, 0.043),
             ("infer.decode", 0.043, 0.045), ("infer.nms", 0.045, 0.049), ("infer.forward", -0.01, 0.0),
             ("infer.forward", 0.06, 0.09)]
    record = {"kind": "infer", "kernels": [], "window_s": 0.08, "spans": spans}
    got = {s: registry.reader(f"enqueue_ms.infer.{s}")(record) for s in INFER}
    assert got == pytest.approx({"forward": 11.0, "decode": 1.5, "nms": 3.5})


def test_readers_give_nothing_without_the_programs_marks_or_spans():
    train = {"kind": "train", "kernels": [("gather_rows_kernel", 0.0, 0.001)], "window_s": 1.0, "spans": []}
    infer = {"kind": "infer", "kernels": [], "window_s": 1.0, "spans": [("infer.enqueue", 0.1, 0.2)]}
    for s in TRAIN:
        assert registry.reader(f"stage_ms.train.{s}")(train) is None
        assert registry.reader(f"stage_ms.train.{s}")(infer) is None
        assert registry.reader(f"stage_ms.train.{s}")(None) is None
    for s in INFER:
        assert registry.reader(f"enqueue_ms.infer.{s}")(infer) is None
        assert registry.reader(f"enqueue_ms.infer.{s}")(train) is None


def test_no_mark_holds_a_name_another_reader_matches():
    marks = re.findall(r"ODCIB_MARK\((\w+), \d+\)", MARKS_CU.read_text())
    assert len(marks) == 8
    names = [f"mark_{m}_kernel" for m in marks]
    assert not [(n, k) for n in names for k in MATCHED if k in n]
    record = _train_record()
    for metric in ("k2_gather_roofline", "k4_hsv_roofline", "k5_warp_roofline", "train_mfu"):
        with_marks = registry.reader(metric)({**record, "k5_reached": [1e7], "batch": 64, "image_size": 416,
                                              "step_kernel": "gather_rows_kernel", "step_flops": 1e12, "chips": 1})
        assert with_marks is None or with_marks > 0
    from counts.roofline import launches

    assert launches(record, "gather_rows_kernel") == 1


def test_the_stage_metrics_are_declared_for_their_cells():
    bench = registry.spec()
    for cell in ("train.yolov5s.416.b64", "train.yolov5l.416.b64"):
        assert {f"stage_ms.train.{s}" for s in TRAIN} <= set(registry.metrics_for(cell, bench, True))
    assert {f"enqueue_ms.infer.{s}" for s in INFER} <= set(registry.metrics_for("infer.yolov5s.640.b32", bench,
                                                                                  True))
