"""Model FLOPs of a reference network: twice the multiply-adds of its
convolutions for one image, counted from shapes on the meta device.
A training step counts three times the forward; recomputation is never
counted."""

from __future__ import annotations

from typing import Callable, Type

import torch

TRAIN_FACTOR = 3  # forward + the two products of the backward


def hooked_forward(net: torch.nn.Module, size: int, kind: Type[torch.nn.Module], hook: Callable) -> None:
    """One eval forward of ``net`` (on the meta device) over a (1, size,
    size, 3) image, ``hook(module, inputs, output)`` on every module of
    type ``kind``."""
    handles = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, kind)]
    try:
        with torch.no_grad():
            net.eval()(torch.empty(1, size, size, 3, device="meta"))
    finally:
        for h in handles:
            h.remove()


def conv_flops(net: torch.nn.Module, size: int, kind: Type[torch.nn.Module]) -> int:
    """2 x multiply-adds of every convolution (a module of type ``kind``
    with a (cout, cin / groups, kh, kw) ``weight``) for one (size x size)
    image."""
    total = 0

    def hook(mod, inputs, out):
        nonlocal total
        cin, kh, kw = mod.weight.shape[1:]
        total += 2 * out.numel() * cin * kh * kw

    hooked_forward(net, size, kind, hook)
    return total
