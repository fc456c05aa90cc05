"""What a run may not load, in the process that prints its result and in
every rank it starts: JAX and the JAX package, compared by whole top-level
names (the port's name begins with the JAX package's)."""

from __future__ import annotations

import sys
from typing import Sequence

FORBIDDEN = ("jax", "jaxlib", "flax", "object_detection_cib_tpu")


def forbidden_modules() -> list:
    """This process's loaded modules whose top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def refuse_ranks(found: Sequence[list]) -> None:
    """Raise, naming them, where any rank (``found``: each rank's
    ``forbidden_modules()``, in rank order) loaded a forbidden module."""
    named = [f"rank {r}: {', '.join(f)}" for r, f in enumerate(found) if f]
    if named:
        raise RuntimeError(f"the ranks loaded forbidden modules ({'; '.join(named)}): no result")
