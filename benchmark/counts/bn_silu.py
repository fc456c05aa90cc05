"""The training step's BatchNorm + SiLU: the elements a reference network's
BatchNorms normalise for one image, counted from shapes on the meta
device, and the bytes a training step must move for each."""

from __future__ import annotations

from typing import Tuple, Type

import torch

from counts.flops import hooked_forward

# bf16: forward x read and y written, backward x and dy read and dx written
BYTES_PER_ELEMENT = 10


def bn_elements(net: torch.nn.Module, size: int, kind: Type[torch.nn.Module]) -> Tuple[int, int]:
    """(BatchNorm output elements for one (size x size) image, BatchNorm
    layers): the outputs of every module of type ``kind``."""
    seen = []
    hooked_forward(net, size, kind, lambda mod, i, out: seen.append(out.numel()))
    return sum(seen), len(seen)
