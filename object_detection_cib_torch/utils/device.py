"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if CUDA is asked for and absent.

    Entry points default to ``"cuda"`` so that a machine without a card fails
    loudly instead of running on the CPU. Pass ``device="cpu"`` to run there.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def to_unit(images: torch.Tensor) -> torch.Tensor:
    """Pixel values in [0, 255] -> f32 in [0, 1], by an IEEE f32 division.

    The divisor is a tensor on the images' device: CUDA divides by a Python
    scalar as a multiply by its reciprocal, which differs in the last bit
    for some values, while this division is bitwise the CPU's and the JAX
    package's host ``x / 255.0``.
    """
    return images.float() / torch.full((), 255.0, device=images.device)
