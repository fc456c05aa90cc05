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
