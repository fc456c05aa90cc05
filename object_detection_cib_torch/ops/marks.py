"""Stage marks on the card's clock: the one-thread kernels of ``csrc/marks.cu``.

``MARKS`` are the stage boundaries of a fused-epoch step, the rows of a
stamp matrix and of the kernels, in the same order: the make side (the
forked stream when pipelined), then the train side; ``allreduce_end`` on a
mesh only. ``stamp`` launches row ``row``'s kernel (``mark_<stage>_kernel``)
on the matrix's current stream: it writes the card's global timer into
``matrix[row, step]``. ``utils/tracing.py:mark`` is the caller, and stamps
the host's clock on the CPU instead.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from object_detection_cib_torch.ops import build as kbuild

MARKS = ("augment_begin", "augment_end", "forward_begin", "forward_end", "loss_end", "backward_end",
         "allreduce_end", "optimizer_end")

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = kbuild.load("marks")
        lib.odcib_mark.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_void_p]
        lib.odcib_mark.restype = ctypes.c_int
        lib.odcib_mark_rows.argtypes = []
        lib.odcib_mark_rows.restype = ctypes.c_int
        if lib.odcib_mark_rows() != len(MARKS):
            raise RuntimeError(f"marks.cu knows {lib.odcib_mark_rows()} stages, MARKS {len(MARKS)}")
        _lib = lib
    return _lib


def stamp(row: int, matrix: torch.Tensor, step: torch.Tensor) -> None:
    """Enqueue row ``row``'s mark kernel: the card's clock into ``matrix``
    (a contiguous int64 ``(len(MARKS), steps)`` tensor on the card) at the
    column ``step`` (an int64 scalar beside it) holds when the kernel runs;
    a column outside the matrix writes nothing."""
    kbuild.check(_load().odcib_mark(row, matrix.data_ptr(), step.data_ptr(), matrix.shape[1],
                                    kbuild.stream_of(matrix)), "mark")
