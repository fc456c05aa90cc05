"""HSV jitter of planar images: the CUDA kernel (K4) and its plain version.

Counterpart of ``object_detection_cib_tpu/ops/pallas_hsv.py``
(``hsv_planar``). The kernel source is ``csrc/hsv.cu``, with a bf16 and an
f32 instance; the plain version is ``ops/augment.py:hsv_batch`` with
``channel_axis=1``, the function the Pallas kernel equals. The kernel moves
runs of 8 positions with 16-byte accesses where the tensors are 16-byte
aligned and H * W is a multiple of 8, and one position at a time otherwise;
it reads cv2's two division tables (``hsv_div_tables``) from shared memory
where the plain version divides.

``hsv_planar`` takes the plain version only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises, and counts the launch in
``hsv_planar.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from object_detection_cib_torch.ops import build as kbuild
from object_detection_cib_torch.ops.graph import count_launch
from object_detection_cib_torch.ops.augment import hsv_batch

_lib: Optional[ctypes.CDLL] = None
_ENTRY = {torch.bfloat16: "odcib_hsv_planar_bf16", torch.float32: "odcib_hsv_planar_f32"}


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = kbuild.load("hsv")
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def hsv_div_tables() -> tuple[torch.Tensor, torch.Tensor]:
    """cv2's 256-entry ``sdiv`` and ``hdiv`` tables (int32), as the kernel fills them.

    ``sdiv[v] = round(1044480 / v)`` and ``hdiv[d] = round(122880 / d)`` by
    the integer formula ``(2a + i) // (2i)`` (never a tie for 1 <= i <= 255),
    entry 0 = 0: what ``hsv_batch`` computes per pixel by division.
    """
    i = torch.arange(256, dtype=torch.int32)
    den = (2 * i).clamp(min=1)
    sdiv = torch.where(i > 0, (2 * 1044480 + i) // den, 0)
    hdiv = torch.where(i > 0, (2 * 122880 + i) // den, 0)
    return sdiv.to(torch.int32), hdiv.to(torch.int32)


def hsv_planar_plain(images: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``hsv_batch(images, r, channel_axis=1)``."""
    return hsv_batch(images, r, channel_axis=1)


def hsv_planar(images: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """images (B, 3, H, W) bf16/f32, r (B, 3) f32 gains -> jittered images.

    Same dtype and shape out. CPU tensors take ``hsv_planar_plain``.
    """
    if images.dim() != 4 or images.shape[1] != 3:
        raise ValueError(f"images must be (B, 3, H, W), got {tuple(images.shape)}")
    B = images.shape[0]
    if tuple(r.shape) != (B, 3) or r.dtype != torch.float32:
        raise ValueError(f"r must be ({B}, 3) float32, got {tuple(r.shape)} {r.dtype}")
    if r.device != images.device:
        raise ValueError(f"images on {images.device} but r on {r.device}")
    if images.device.type == "cpu":
        return hsv_planar_plain(images, r)
    if images.device.type != "cuda":
        raise ValueError(f"no HSV kernel for device {images.device}")
    if images.dtype not in _ENTRY:
        raise ValueError(f"no HSV kernel for dtype {images.dtype}")
    if not (images.is_contiguous() and r.is_contiguous()):
        raise ValueError("images and r must be contiguous")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel's grid limit 65535")
    out = torch.empty_like(images)
    if images.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(images.device):
        err = getattr(lib, _ENTRY[images.dtype])(
            images.data_ptr(), r.data_ptr(), out.data_ptr(), B,
            images.shape[2] * images.shape[3], kbuild.stream_of(images),
        )
    kbuild.check(err, "hsv_planar")
    count_launch(hsv_planar)
    return out


hsv_planar.launches = 0
