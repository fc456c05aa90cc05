"""Bytes each kernel must move for one launch, every input byte read once
and every output byte written once, and the least time that takes."""

from __future__ import annotations

from counts.peaks import HBM_BYTES


def gather_rows(rows: int, row_bytes: int) -> int:
    """K2: ``rows`` rows of ``row_bytes`` read from the corpus and written out."""
    return 2 * rows * row_bytes


def hsv_planar(batch: int, size: int, elem_bytes: int = 2) -> int:
    """K4: (batch, 3, size, size) images read and written."""
    return 2 * batch * 3 * size * size * elem_bytes


def warp_quadrants(reached_source: int, groups: int, size: int, out_bytes: int = 2) -> int:
    """K5: the uint8 source bytes a non-zero tap reaches, its six (groups,
    4, size) 4-byte tap arrays, and the (groups, 3, size, size) output."""
    return reached_source + 6 * groups * 4 * size * 4 + groups * 3 * size * size * out_bytes


def greedy_nms(batch: int, k: int) -> int:
    """K1 (its two launches together): (batch, k) f32 boxes and the live
    mask read, the keep mask written."""
    return batch * k * (16 + 1 + 1)


def bound_ms(nbytes: int) -> float:
    """The least time that moves ``nbytes`` at the card's HBM bandwidth."""
    return nbytes / HBM_BYTES * 1e3
