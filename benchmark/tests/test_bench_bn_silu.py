"""The BatchNorm + SiLU roofline: its reader on synthetic records (the
bytes, counted from the reference network's shapes through its family,
are pinned in test_bench_counts.py)."""

import pytest

from counts.peaks import HBM_BYTES
from harness import registry


def _kernel(name, a, b):
    return (f"void (anonymous namespace)::{name}_kernel(__nv_bfloat16 const*, long long, long long, int)", a, b)


def _record(kernels, kind="train", window=1.0):
    return {"kind": kind, "cell": "train.yolov5s.416.b64", "batch": 64, "image_size": 416,
            "kernels": kernels, "window_s": window}


def test_reader_counts_apply_launches_and_every_bn_silu_kernel_time():
    """Two steps of 57 layers: 114 apply launches; the time is that of all
    six kernels of a layer, forward and backward, inside the window."""
    per_layer = 64 * 10 * 9_993_984 / 57
    kernels, t = [], 0.0
    for _ in range(2 * 57):
        for name in ("bn_silu_stats", "bn_silu_stats_merge", "bn_silu_apply", "bn_silu_grad_reduce",
                     "bn_silu_grad_merge", "bn_silu_grad_input"):
            kernels.append(_kernel(name, t, t + 1e-5))
            t += 2e-5
    kernels.append(_kernel("bn_silu_apply", 0.5, 1.5))  # not wholly inside the window
    got = registry.reader("bn_silu_roofline")(_record(kernels))
    assert got == pytest.approx(100.0 * 114 * per_layer / HBM_BYTES / (114 * 6 * 1e-5))


def test_reader_gives_nothing_without_the_kernels_or_on_inference():
    read = registry.reader("bn_silu_roofline")
    plain = [("void at::native::reduce_kernel<128, 4>", 0.0, 0.1)]
    assert read(_record(plain)) is None
    assert read(_record([_kernel("bn_silu_apply", 0.0, 0.1)], kind="infer")) is None
    assert read(None) is None


def test_the_metric_is_declared_for_the_training_cells():
    bench = registry.spec()
    for cell in ("train.yolov5s.416.b64", "train.yolov5l.416.b64"):
        assert "bn_silu_roofline" in registry.metrics_for(cell, bench, True)
    assert "bn_silu_roofline" not in registry.metrics_for("infer.yolov5s.640.b32", bench, True)
    # the kernels do not run over a process group
    assert "bn_silu_roofline" not in registry.metrics_for("train4.yolov5s.416.b256", bench, True)
