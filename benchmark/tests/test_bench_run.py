"""``benchmark/run.py`` as the driver runs it: without a card it exits
non-zero before any timing and prints no result, never falling back to the
CPU; its result line has exactly the contract's keys, the numbers compared
last."""

import importlib.util
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from _tiny import infer_cell, train4_cell, train_cell
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


def test_result_line_over_ranks_traced(few_threads):
    """Over two gloo ranks (the four-card cell's window): the global
    batch's images, the ranks' count, and rank 0's traced record with the
    global batch's FLOPs and its own rows."""
    from harness import registry

    cell = train4_cell()
    out = train.run(cell, 2**31 + 3, 0.2, True, torch.device("cpu"), time.perf_counter())
    spec = json.loads((registry.CHECKOUT / "BENCHMARK.json").read_text())
    line = _run_module().result(cell, out, spec, True, "NVIDIA H100 80GB HBM3")
    assert line["attempted"] == 3 * 4 * 8 and line["device"]["count"] == 2  # three epochs of four steps of 8
    assert {"idle_share.train"} <= set(line["metrics"]) and out["failed"] == 0
    record = out["record"]
    cfg = cell["model"]
    assert record["chips"] == 2 and record["batch"] == 4
    assert record["step_flops"] == 3 * registry.family(cfg).conv_flops(cfg, 64) * 8
    assert len(record["k5_reached"]) == 4 and out["setup_s"] > 0 and out["window_s"] > 0
    json.dumps(line)


def plant_jax_on_rank_1(trainer) -> None:
    """A hook that leaves a stub ``jax`` among rank 1's modules."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        sys.modules["jax"] = types.ModuleType("jax")


@pytest.mark.parametrize("entry", ["run", "readings"])
def test_a_rank_that_loaded_jax_gives_no_result(few_threads, entry):
    """Over two gloo ranks, one of which holds ``jax`` once its window (or
    its readings) ends, the window raises, naming it, and hands back no
    result."""
    cell, seed, cpu = train4_cell(), 2**31 + 3, torch.device("cpu")
    with pytest.raises(RuntimeError, match="rank 1: jax"):
        if entry == "run":
            train.run(cell, seed, 0.1, False, cpu, time.perf_counter(), hook=plant_jax_on_rank_1)
        else:
            train.readings(cell, [(seed, plant_jax_on_rank_1, "program")], cpu)
    assert "jax" not in sys.modules
