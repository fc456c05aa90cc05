"""``benchmark/run.py`` as the driver runs it: without a card it exits
non-zero before any timing and prints no result, never falling back to the
CPU; its result line has exactly the contract's keys, the numbers compared
last."""

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from _tiny import infer_cell, train_cell
from harness import infer_cell as infer, registry, train_cell as train

BENCH = Path(__file__).resolve().parents[1]


def _run_module():
    spec = importlib.util.spec_from_file_location("bench_run", BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_without_a_card_it_exits_before_timing_and_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "train.yolov5s.416.b64", "--seed",
                          str(2**31 + 5), "--seconds", "20", "--trace", "0"],
                         capture_output=True, text=True, cwd=BENCH.parent, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "no card" in out.stderr
    assert "{" not in out.stdout


def test_an_unknown_cell_is_refused():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "train.nothing", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=BENCH.parent,
                         timeout=300)
    assert out.returncode != 0 and "{" not in out.stdout


def _line(run, cell, traced):
    spec = json.loads((registry.CHECKOUT / "BENCHMARK.json").read_text())
    out = run.run(cell, 2**31 + 3, 0.2, traced, torch.device("cpu"), time.perf_counter())
    return _run_module().result(dict(cell, name=cell["name"]), out, spec, traced, "NVIDIA H100 80GB HBM3")


def test_result_line_keys_train():
    line = _line(train, train_cell(), False)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"train_img_s", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(line["checks"]) == list(train_cell()["limits"])
    json.dumps(line)


def test_result_line_keys_train_traced():
    """The traced window is one epoch inside the timed fit, started and
    stopped by the trainer's loggers."""
    line = _line(train, train_cell(), True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert "idle_share.train" in set(line["metrics"])  # the rest read kernels, which the CPU runs none of
    assert 0 < line["device"]["window_s"] and line["attempted"] == 3 * 4 * 8  # three epochs of four steps of 8
    json.dumps(line)


def test_result_line_keys_infer_traced():
    line = _line(infer, infer_cell(), True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert {"infer_mfu", "enqueue_ms.infer", "idle_share.infer"} <= set(line["metrics"])
    json.dumps(line)
