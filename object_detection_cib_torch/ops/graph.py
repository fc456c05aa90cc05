"""CUDA graphs of the port's steps, and the launch counts of the kernels in them.

Each kernel wrapper counts its launches in a plain integer on the wrapper
(``gather_rows_planar.launches`` ...), which is how a run shows that its
path went through the kernel. A Python ``+= 1`` runs when the wrapper
enqueues the kernel, so under a CUDA graph it would run once, at capture
(when the card runs nothing), and never at a replay. ``count_launch`` is
the one place a wrapper counts: outside a capture it adds one to the
wrapper's count; while ``CapturedGraph`` captures, it adds one to the
graph's own tally instead, and every ``replay`` adds the whole tally to the
wrappers' counts. So a count is the number of launches that really ran.
"""

from __future__ import annotations

import gc
import threading
from typing import Callable, Dict, Iterable, Optional

import torch

_capture = threading.local()  # .tally: the launches of the graph this thread captures


def count_launch(entry) -> None:
    """Count one launch of ``entry``'s kernel (see the module docstring)."""
    tally: Optional[Dict] = getattr(_capture, "tally", None)
    if tally is None:
        entry.launches += 1
    else:
        tally[entry] = tally.get(entry, 0) + 1


class CapturedGraph:
    """``fn()`` captured once as a CUDA graph on ``stream``, replayed at will.

    The capture runs ``fn``'s Python once and its device work never: ``fn``
    must make no host-device synchronisation, and whatever it leaves on the
    host (counters, attributes) is the caller's to put right. Random draws
    from each of ``generators`` (CUDA generators) advance at every replay as
    the same draws made eagerly would (``register_generator_state``). The
    capture's error mode is ``thread_local``: other threads (a checkpoint
    writer) may go on using the card meanwhile. Python's cyclic garbage
    collector runs once before the capture and is off during it: a
    collection inside the capture would run, in the capturing thread, the
    CUDA calls that free what a dead trainer left in reference cycles (a
    graph's ``reset`` is not permitted while a stream captures), and the
    capture would fail. A capture that fails raises, naming ``name``;
    nothing runs in its place. ``launches`` holds the kernel launches the
    graph holds, by wrapper.
    """

    def __init__(self, fn: Callable[[], None], stream: torch.cuda.Stream, name: str,
                 pool=None, generators: Iterable[torch.Generator] = ()):
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)  # its cudaGraph_t stays readable (raw_cuda_graph)
        for gen in generators:
            self.graph.register_generator_state(gen)
        tally: Dict = {}
        _capture.tally = tally
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
                fn()
        except Exception as e:
            raise RuntimeError(f"capturing {name} as a CUDA graph failed: {e}") from e
        finally:
            _capture.tally = None
            if collecting:
                gc.enable()
        self.graph.instantiate()
        self.launches = tally
        self.replays = 0

    def pool(self):
        """The graph's memory pool, for another graph to share."""
        return self.graph.pool()

    def replay(self) -> None:
        """Enqueue the graph on the current stream and count its launches."""
        self.graph.replay()
        self.replays += 1
        for entry, n in self.launches.items():
            entry.launches += n
