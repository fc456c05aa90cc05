"""The port's own measurement: host spans, their counters, and stage marks
on the card's clock.

``span(name)`` times a host interval. It always adds the interval's host
time (``perf_counter_ns``) to a per-name counter of calls and nanoseconds,
process-wide, read by ``counters()`` and cleared by ``reset()``. Only while
a ``torch.profiler`` runs does it also enter ``record_function(name)``,
which puts the span on the profiler's clock beside the card's kernels;
outside one it costs two clock reads and a dict update. The span's own
time is its ``ns`` once it has closed. A profiler draws a
``record_function`` range on the card's rows too, over the kernels
launched inside it, and a reader of the trace may take that range for
device work. So a span encloses a kernel or copy launch only under the
``infer.`` family (the eval step's layers, which a trace reader reads as
spans); the others (``train.plan``, ``train.fetch``, ``feed_wait``)
enclose none.

``mark(stage)`` stamps a stage boundary of the fused epoch's step on the
card's clock: on the card a one-thread kernel (``ops/marks.py``, one
``__global__`` function a stage: ``mark_<stage>_kernel``) writes the card's
global timer into row ``MARKS.index(stage)`` of an int64 ``(len(MARKS),
steps)`` stamp matrix, at the column of the step counter on the device.
Enqueued on the current stream, it stamps when the work before it there
has run; inside a CUDA graph's capture it becomes a node of the graph, so
every replay stamps. On the CPU it writes the host clock into the same
cell. ``stamping(matrix, step)`` installs the matrix and the counter for
this thread (the fused epoch does, around its steps); where none is
installed (the step loop, the eval step) ``mark`` does nothing.
``stage_ms`` reduces an epoch's stamps to each stage's median ms a step,
``epoch_bounds`` to its first and last stamp.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from object_detection_cib_torch.ops import marks as _marks
from object_detection_cib_torch.ops.marks import MARKS

_ROW = {m: i for i, m in enumerate(MARKS)}
# stage: (the marks it starts from, the first that has stamps; the mark it ends at)
STAGES = {
    "augment": (("augment_begin",), "augment_end"),
    "forward": (("forward_begin",), "forward_end"),
    "loss": (("forward_end",), "loss_end"),
    "backward": (("loss_end",), "backward_end"),
    "allreduce": (("backward_end",), "allreduce_end"),
    "optimizer": (("allreduce_end", "backward_end"), "optimizer_end"),
}


class Counter(NamedTuple):
    calls: int
    ns: int


_counters: Dict[str, list] = {}
_lock = threading.Lock()
_local = threading.local()  # .stamps: (matrix, step) installed by ``stamping``


class span:
    """``with span(name) as s:`` times the block into ``name``'s counter,
    and under a running profiler also records it as
    ``record_function(name)`` (module docstring); ``s.ns`` is the block's
    host time once it has closed."""

    __slots__ = ("name", "ns", "_t0", "_rf")

    def __init__(self, name: str):
        self.name, self.ns = name, 0

    def __enter__(self) -> "span":
        self._rf = None
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.ns = dt = time.perf_counter_ns() - self._t0
        with _lock:
            c = _counters.get(self.name)
            if c is None:
                _counters[self.name] = [1, dt]
            else:
                c[0] += 1
                c[1] += dt
        if self._rf is not None:
            self._rf.__exit__(*exc)


def counters() -> Dict[str, Counter]:
    """Every span's counter so far, ``{name: Counter(calls, ns)}`` (a copy)."""
    with _lock:
        return {k: Counter(*v) for k, v in _counters.items()}


def reset() -> None:
    with _lock:
        _counters.clear()


def ms_per_call(before: Dict[str, Counter], after: Dict[str, Counter], name: str) -> Optional[float]:
    """The host ms a call of span ``name`` between two reads of ``counters()``."""
    a, b = before.get(name, Counter(0, 0)), after.get(name, Counter(0, 0))
    calls = b.calls - a.calls
    return (b.ns - a.ns) / calls / 1e6 if calls > 0 else None


# ------------------------------------------------------------------- marks
def stamp_matrix(steps: int, device) -> torch.Tensor:
    """A zeroed int64 ``(len(MARKS), steps)`` stamp matrix on ``device``."""
    return torch.zeros((len(MARKS), steps), dtype=torch.int64, device=device)


@contextlib.contextmanager
def stamping(matrix: torch.Tensor, step: torch.Tensor):
    """Install ``matrix`` and the step counter ``step`` (an int64 scalar on
    the matrix's device) for this thread's ``mark`` calls."""
    _check_step(step, matrix)
    if matrix.dtype != torch.int64 or matrix.dim() != 2 or matrix.shape[0] != len(MARKS) \
            or not matrix.is_contiguous():
        raise ValueError(f"a stamp matrix is a contiguous int64 ({len(MARKS)}, steps) tensor")
    prev = getattr(_local, "stamps", None)
    _local.stamps = (matrix, step)
    try:
        yield
    finally:
        _local.stamps = prev


def mark(stage: str, step: Optional[torch.Tensor] = None) -> None:
    """Stamp ``stage`` at the installed counter's column (or ``step``'s, an
    int64 scalar on the matrix's device); nothing where no matrix is installed."""
    cur = getattr(_local, "stamps", None)
    if cur is None:
        return
    matrix, col = cur
    if step is not None:
        _check_step(step, matrix)
        col = step
    row = _ROW[stage]
    if matrix.is_cuda:
        _marks.stamp(row, matrix, col)
    else:
        c = int(col)
        if 0 <= c < matrix.shape[1]:
            matrix[row, c] = time.perf_counter_ns()


def _check_step(step: torch.Tensor, matrix: torch.Tensor) -> None:
    if step.dtype != torch.int64 or step.numel() != 1 or step.device != matrix.device:
        raise ValueError(f"a step counter is one int64 on the stamp matrix's device ({matrix.device}), "
                         f"got {step.dtype} {tuple(step.shape)} on {step.device}")


def stage_ms(stamps: np.ndarray) -> Dict[str, float]:
    """Each stage's median ms a step over an epoch's stamps (``(len(MARKS),
    steps)``; 0 where nothing stamped): from the first of its start marks
    that has stamps to its end mark, over the steps where both stamped.
    Stages with no such step are left out."""
    s = np.asarray(stamps, dtype=np.int64)
    out = {}
    for name, (starts, end) in STAGES.items():
        b = s[_ROW[end]]
        for start in starts:
            a = s[_ROW[start]]
            if a.any():
                ok = (a > 0) & (b > 0)
                if ok.any():
                    out[name] = float(np.median(b[ok] - a[ok])) / 1e6
                break
    return out


def epoch_bounds(stamps: Optional[np.ndarray]) -> Optional[Tuple[int, int]]:
    """(first, last) stamp of an epoch in ns, or None where none stamped
    (or ``stamps`` is None)."""
    if stamps is None:
        return None
    s = np.asarray(stamps, dtype=np.int64)
    s = s[s > 0]
    return (int(s.min()), int(s.max())) if s.size else None
