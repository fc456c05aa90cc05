"""The harness's spans and the reduction of a device trace.

Spans are the harness's own, around its calls into the program's layers
(the program has none of its own yet). Outside a trace they are host-clock
intervals kept in memory; inside one they are also ``record_function``
annotations, on the profiler's clock beside the device's kernels.

A ``Trace`` runs ``torch.profiler`` (CPU and CUDA) from ``start()`` to
``stop()``, both called on one thread; the window is the annotation
``bench.window`` between them, so idle time at either end counts.
``traced(work)`` traces ``work`` between two ``synchronize`` calls; a
caller that must not drain the card's queue (a window inside a running
``fit``) calls ``start`` and ``stop`` itself, without them. The work that
was already queued then runs untraced at first, so that window starts at
the first device operation the trace holds.

The reduction: each device kernel and copy by name, the union of their
intervals inside the window (the card's busy time), and the gaps of that
union, each named by the innermost harness span open when it began, or as
the window's start or end where it touches one.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "bench.window"
PREFIXES = ("window.", "infer.", "bench.")  # the harness's span names
GAPS = 10  # the longest idle gaps kept, named
NAME_CHARS = 160  # a kernel's name is cut to this (templates make them long)


class Spans:
    """Named host-clock intervals, in memory."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            try:
                yield
            finally:
                self.items.append((name, t0, time.perf_counter()))

    def durations(self, name: str) -> List[float]:
        return [b - a for n, a, b in self.items if n == name]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Trace:
    """``torch.profiler`` from ``start()`` to ``stop()``; ``record()`` after."""

    def __init__(self, device, sync: bool = True):
        from torch.profiler import ProfilerActivity, profile

        self.on_card = torch.device(device).type == "cuda"
        self.device = device
        self.sync = sync and self.on_card
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.on_card else [])
        self.prof = profile(activities=acts, record_shapes=False)
        self._window = None

    def start(self) -> None:
        self.prof.start()
        if self.sync:
            torch.cuda.synchronize(self.device)
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> None:
        if self.sync:
            torch.cuda.synchronize(self.device)
        self._window.__exit__(None, None, None)
        self.prof.stop()

    def record(self) -> dict:
        """The trace's record (seconds from the window's start): ``window_s``,
        ``busy_s``, ``kernels`` [(name, start, end)] of every kernel and copy
        that overlaps the window, uncut, ``device_ops`` {name: seconds
        inside the window}, ``idle_gaps`` [(span, seconds)] the longest
        ``GAPS``, ``edge_idle_s`` (idle at the window's start, at its end),
        ``spans`` [(name, start, end)]."""
        from torch.autograd import DeviceType

        rows = []
        for e in self.prof.profiler.kineto_results.events():
            a = e.start_ns()
            rows.append((e.name(), e.device_type() == DeviceType.CUDA, a, a + e.duration_ns()))
        win = [r for r in rows if r[0] == WINDOW and not r[1]]
        if not win:
            raise RuntimeError("the profiler recorded no window")
        base, end = win[0][2], win[0][3]
        if not self.sync:  # from the first device operation enqueued after the start
            base = min((a for _, on_device, a, _ in rows if on_device and a >= base), default=base)
        w1 = (end - base) / 1e9
        kernels, spans = [], []
        for name, on_device, a, b in rows:
            a, b = (a - base) / 1e9, (b - base) / 1e9
            ours = name.startswith(PREFIXES)  # a harness span, which the trace also shows on the device's rows
            if on_device:
                if not ours and b > 0.0 and a < w1:
                    kernels.append((name[:NAME_CHARS], a, b))
            elif ours and name != WINDOW:
                spans.append((name, a, b))
        inside = [(n, max(a, 0.0), min(b, w1)) for n, a, b in kernels]
        busy = _union([(a, b) for _, a, b in inside])
        ops: Dict[str, float] = {}
        for name, a, b in inside:
            ops[name] = ops.get(name, 0.0) + (b - a)
        gaps, prev = [], 0.0
        for a, b in busy + [(w1, w1)]:
            if a > prev:
                gaps.append((prev, a - prev))
            prev = max(prev, b)
        named = []
        for start, length in sorted(gaps, key=lambda g: -g[1])[:GAPS]:
            open_ = [s for s in spans if s[1] <= start < s[2]]
            if start == 0.0:
                label = "window start"
            elif start + length >= w1:
                label = "window end"
            else:
                label = min(open_, key=lambda s: s[2] - s[1])[0] if open_ else "between harness calls"
            named.append((label, length))
        lead = busy[0][0] if busy else w1
        tail = w1 - busy[-1][1] if busy else 0.0
        return {"window_s": w1, "busy_s": sum(b - a for a, b in busy), "kernels": kernels, "device_ops": ops,
                "idle_gaps": named, "edge_idle_s": [lead, tail], "spans": spans}


def traced(work: Callable[[], None], device) -> dict:
    """Run ``work()`` traced between two ``synchronize`` calls; -> its record."""
    t = Trace(device)
    t.start()
    try:
        work()
    finally:
        t.stop()
    return t.record()


def breakdown(trace: dict, n: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps,
    each gap named by the harness span open at its start."""
    ops = sorted(trace["device_ops"].items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in trace["idle_gaps"][:n]]}
