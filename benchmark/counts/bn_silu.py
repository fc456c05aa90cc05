"""The training step's BatchNorm + SiLU: the elements the reference
network's BatchNorms normalise for one image, counted from shapes on the
meta device, and the bytes a training step must move for them."""

from __future__ import annotations

from typing import Tuple

import torch

from reference.network import BatchNorm, YOLOv5

# bf16: forward x read and y written, backward x and dy read and dx written
BYTES_PER_ELEMENT = 10


def bn_elements(nc: int, deepen: float, widen: float, size: int) -> Tuple[int, int]:
    """(BatchNorm output elements for one (size x size) image, BatchNorm layers)."""
    net = YOLOv5(nc, deepen, widen).to("meta")
    seen = []
    handles = [m.register_forward_hook(lambda mod, i, out: seen.append(out.numel()))
               for m in net.modules() if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            net.eval()(torch.empty(1, size, size, 3, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return sum(seen), len(seen)


def bn_silu(nc: int, deepen: float, widen: float, size: int) -> Tuple[int, int]:
    """(the least bytes one image's BatchNorm + SiLU moves in a training
    step, BatchNorm layers)."""
    elements, layers = bn_elements(nc, deepen, widen, size)
    return BYTES_PER_ELEMENT * elements, layers
