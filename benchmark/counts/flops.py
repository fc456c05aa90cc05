"""Model FLOPs of the reference network: twice the multiply-adds of its
convolutions for one image, counted from shapes on the meta device.
A training step counts three times the forward; recomputation is never
counted."""

from __future__ import annotations

import torch

from reference.network import Conv, YOLOv5

TRAIN_FACTOR = 3  # forward + the two products of the backward


def conv_flops(nc: int, deepen: float, widen: float, size: int) -> int:
    """2 x multiply-adds of every convolution for one (size x size) image."""
    net = YOLOv5(nc, deepen, widen).to("meta")
    total = 0

    def hook(mod, inputs, out):
        nonlocal total
        cin, kh, kw = mod.weight.shape[1:]
        total += 2 * out.numel() * cin * kh * kw

    handles = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, Conv)]
    try:
        with torch.no_grad():
            net.eval()(torch.empty(1, size, size, 3, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return total


def parameters(nc: int, deepen: float, widen: float) -> int:
    return sum(p.numel() for p in YOLOv5(nc, deepen, widen).to("meta").parameters())

