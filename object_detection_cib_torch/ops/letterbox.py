"""Letterbox: decoded RGB images into S x S uint8 rows; the CUDA kernel and its plain version.

The port's own kernel, not a TPU kernel's port: the JAX package letterboxes
on the host, in ``native/loader.cpp:75-118`` (``resize_bilinear``,
``resize_into_canvas``), and this module computes the same bytes. Image i
of a batch, ``hw[i] = (h, w)`` RGB bytes at ``offsets[i]`` of one byte
blob, is resized to longest side S by bilinear sampling (pixel centres,
both source taps clamped at the edges) into the top-left ``(nh, nw)``
window, or with ``center`` the centred one, of a canvas filled with 114.
``(nh, nw)`` is ``lround(h * S / max(h, w))`` in f32, at least 1 and at most
S. An image with ``h`` or ``w`` 0 (a file that failed to decode) gives a
canvas of 114 and sizes ``(0, 0)``.

``loader.cpp`` is built with ``-O3 -march=native``, and the compiler fuses
five of its multiply-adds: ``fy = fma(y + 0.5, sy, -0.5)``, the same for
``fx``, and each lerp ``a * (1 - w) + b * w`` as ``fma(a, 1 - w, b * w)``.
Both versions here do exactly that. The plain version computes a fused
multiply-add in f64 and rounds to f32 once, by rounding to odd: the product
of two f32 values is exact in f64, the sum's rounding error is recovered
exactly (two-sum) and folded into the last bit, so the one rounding to f32
that follows is correct. ``csrc/letterbox.cu`` spells the same five as
``__fmaf_rn`` under ``--fmad=false``.

The output is an ``(n, 3, S, S)`` uint8 tensor or view of any strides: the
planar corpus rows, a host-fed group, or, permuted, NHWC rows.
``letterbox`` takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises, and counts the launch in
``letterbox.launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from object_detection_cib_torch.ops import build as kbuild
from object_detection_cib_torch.ops.graph import count_launch

FILL = 114
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = kbuild.load("letterbox")
        lib.odcib_letterbox.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.odcib_letterbox.restype = ctypes.c_int
        _lib = lib
    return _lib


def content_size(h: int, w: int, target: int) -> Tuple[int, int]:
    """(nh, nw) of an (h, w) image at longest side ``target``, in f32 as
    ``loader.cpp:109-113`` computes it; (0, 0) for an empty image."""
    if h <= 0 or w <= 0:
        return 0, 0
    scale = np.float32(target) / np.float32(max(h, w))

    def side(n: int) -> int:  # lround of a non-negative f32, half away from zero
        return min(max(int(math.floor(float(np.float32(n) * scale) + 0.5)), 1), target)

    return side(h), side(w)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of f32 tensors rounded once to f32, as a fused multiply-add."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b  # exact: 24 + 24 bits
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # s + err == p + c exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)  # round to odd
    return s.float()


def _taps(n_out: int, n_src: int, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Source taps (i0, i1 clamped to [0, n_src)) and the weight of i1 for each
    of ``n_out`` output positions (``loader.cpp:78-84``)."""
    step = torch.tensor(np.float32(n_src) / np.float32(n_out), device=device)
    pos = torch.arange(n_out, device=device, dtype=torch.float32) + 0.5
    f = fma_f32(pos, step, torch.tensor(-0.5, device=device))
    i0 = torch.floor(f)
    frac = f - i0
    i0 = i0.long()
    return i0.clamp(0, n_src - 1), (i0 + 1).clamp(0, n_src - 1), frac


def resize_plain(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """(h, w, 3) uint8 -> (3, nh, nw) uint8, ``loader.cpp``'s bilinear resize."""
    h, w = img.shape[:2]
    y0, y1, wy = _taps(nh, h, img.device)
    x0, x1, wx = _taps(nw, w, img.device)
    src = img.permute(2, 0, 1).float()  # (3, h, w)
    r0, r1 = src[:, y0], src[:, y1]  # (3, nh, w)
    omx, omy = (1.0 - wx), (1.0 - wy)[:, None]
    top = fma_f32(r0[:, :, x0], omx, r0[:, :, x1] * wx)
    bot = fma_f32(r1[:, :, x0], omx, r1[:, :, x1] * wx)
    v = fma_f32(top, omy, bot * wy[:, None]).clamp(0.0, 255.0)
    return torch.floor(v.double() + 0.5).to(torch.uint8)  # lround, v >= 0


def _check(raw: torch.Tensor, offsets: torch.Tensor, hw: torch.Tensor, out: torch.Tensor) -> int:
    n = out.shape[0]
    if out.dim() != 4 or out.shape[1] != 3 or out.shape[2] != out.shape[3] or out.dtype != torch.uint8:
        raise ValueError(f"out must be an (n, 3, S, S) uint8 view, got {tuple(out.shape)} {out.dtype}")
    if raw.dim() != 1 or raw.dtype != torch.uint8:
        raise ValueError(f"raw must be a 1-D uint8 blob, got {tuple(raw.shape)} {raw.dtype}")
    if tuple(offsets.shape) != (n,) or offsets.dtype != torch.int64:
        raise ValueError(f"offsets must be ({n},) int64, got {tuple(offsets.shape)} {offsets.dtype}")
    if tuple(hw.shape) != (n, 2) or hw.dtype != torch.int32:
        raise ValueError(f"hw must be ({n}, 2) int32, got {tuple(hw.shape)} {hw.dtype}")
    for name, t in (("raw", raw), ("offsets", offsets), ("hw", hw)):
        if t.device != out.device:
            raise ValueError(f"{name} on {t.device} but out on {out.device}")
    return n


def letterbox_plain(raw: torch.Tensor, offsets: torch.Tensor, hw: torch.Tensor, out: torch.Tensor,
                    center: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``letterbox``, image by image (any device)."""
    n = _check(raw, offsets, hw, out)
    S = out.shape[-1]
    sizes = torch.zeros((n, 2), dtype=torch.int32, device=out.device)
    for i, ((h, w), off) in enumerate(zip(hw.tolist(), offsets.tolist())):
        out[i].fill_(FILL)
        nh, nw = content_size(h, w, S)
        if nh == 0:
            continue
        top, left = ((S - nh) // 2, (S - nw) // 2) if center else (0, 0)
        img = raw[off:off + h * w * 3].view(h, w, 3)
        out[i, :, top:top + nh, left:left + nw] = resize_plain(img, nh, nw)
        sizes[i, 0], sizes[i, 1] = nh, nw
    return sizes


def letterbox(raw: torch.Tensor, offsets: torch.Tensor, hw: torch.Tensor, out: torch.Tensor,
              center: bool = False) -> torch.Tensor:
    """Letterbox image i of ``raw`` (``hw[i]`` RGB bytes at ``offsets[i]``)
    into ``out[i]``, an (n, 3, S, S) uint8 view; returns (n, 2) int32 sizes on
    ``out``'s device. CPU tensors take ``letterbox_plain``."""
    n = _check(raw, offsets, hw, out)
    if out.device.type == "cpu":
        return letterbox_plain(raw, offsets, hw, out, center)
    if out.device.type != "cuda":
        raise ValueError(f"no letterbox kernel for device {out.device}")
    if not (raw.is_contiguous() and offsets.is_contiguous() and hw.is_contiguous()):
        raise ValueError("raw, offsets and hw must be contiguous")
    if n > 65535:
        raise ValueError(f"batch {n} exceeds the kernel's grid limit 65535")
    sizes = torch.empty((n, 2), dtype=torch.int32, device=out.device)
    if n == 0:
        return sizes
    lib = _load()
    with torch.cuda.device(out.device):
        err = lib.odcib_letterbox(
            raw.data_ptr(), offsets.data_ptr(), hw.data_ptr(), n, out.shape[-1], int(center),
            out.data_ptr(), *out.stride(), sizes.data_ptr(), kbuild.stream_of(out))
    kbuild.check(err, "letterbox")
    count_launch(letterbox)
    return sizes


letterbox.launches = 0
