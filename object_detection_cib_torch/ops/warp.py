"""Fused mosaic + affine warp over quadrant taps: the CUDA kernel (K5) and
its plain PyTorch version.

Counterpart of ``object_detection_cib_tpu/ops/pallas_warp.py``
(``warp_quadrants``). The TPU kernel took the x-pass as a dense
(G, 4, S, S) tap matrix ``Ax``; both tap matrices are 2-sparse, so here
both axes come as their tap scalars (``j0``, ``w0``, ``w1`` per output row
or column, from ``ops/augment.py:_tap_scalars_windowed``) and no dense
matrix is ever built. The kernel source is ``csrc/warp.cu``; it and
``warp_quadrants_plain`` round in the Pallas body's order (bf16 operands,
f32 sums, quadrants accumulated in order, ``rint(acc + 114)``), so the
three agree bit for bit.

The JAX kernel's ``S <= 512`` limit was a VMEM budget; this kernel stages
a band's taps and, per warp, one output row's source rows and y-pass in
shared memory (74,816 B a block at S = So = 416, 114,240 B at 640) and
takes any S up to 32,767 and any So. Its dead-quadrant skip was a
DMA-elision device; here a quadrant whose y-weights are zero for a row is
skipped by the whole warp, which changes no bit.

``warp_quadrants`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises, and counts the launch in
``warp_quadrants.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from object_detection_cib_torch.ops import build as kbuild
from object_detection_cib_torch.ops.graph import count_launch

FILL = 114.0

_lib: Optional[ctypes.CDLL] = None
_ENTRY = {torch.bfloat16: "odcib_warp_quadrants_bf16", torch.float32: "odcib_warp_quadrants_f32"}


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = kbuild.load("warp")
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.odcib_warp_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.odcib_warp_smem_bytes.restype = ctypes.c_int
        _lib = lib
    return _lib


def smem_bytes(S: int, So: int) -> int:
    """Dynamic shared memory of one block of the kernel at sizes S and So."""
    return _load().odcib_warp_smem_bytes(S, So)


def _taps(j: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor, n: int):
    """Clamped indices and bf16-rounded weights, zero outside [0, n)."""
    zero = torch.zeros((), dtype=torch.float32, device=j.device)
    t0 = torch.where((j >= 0) & (j < n), w0.to(torch.bfloat16).float(), zero)
    t1 = torch.where((j + 1 >= 0) & (j + 1 < n), w1.to(torch.bfloat16).float(), zero)
    return j.clamp(0, n - 1).long(), (j + 1).clamp(0, n - 1).long(), t0, t1


def warp_quadrants_plain(
    imgs: torch.Tensor,
    jx0: torch.Tensor, wx0: torch.Tensor, wx1: torch.Tensor,
    jy0: torch.Tensor, wy0: torch.Tensor, wy1: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of ``warp_quadrants`` (same arguments).

    Holds the (G, 4, 3, So, S) y-pass result in f32: a reference, never
    the fast path.
    """
    G, _, C, S, _ = imgs.shape
    So = jx0.shape[-1]
    src = imgs.float() - FILL  # integers in [-114, 141]: exact in bf16
    iy0, iy1, ty0, ty1 = _taps(jy0, wy0, wy1, S)  # (G, 4, So)
    rows0 = torch.gather(src, 3, iy0[:, :, None, :, None].expand(G, 4, C, So, S))
    rows1 = torch.gather(src, 3, iy1[:, :, None, :, None].expand(G, 4, C, So, S))
    ybl = ty0[:, :, None, :, None] * rows0 + ty1[:, :, None, :, None] * rows1
    ybl = ybl.to(torch.bfloat16).float()  # (G, 4, C, So[y], S[w])
    ix0, ix1, tx0, tx1 = _taps(jx0, wx0, wx1, S)
    col0 = torch.gather(ybl, 4, ix0[:, :, None, None, :].expand(G, 4, C, So, So))
    col1 = torch.gather(ybl, 4, ix1[:, :, None, None, :].expand(G, 4, C, So, So))
    res = tx0[:, :, None, None, :] * col0 + tx1[:, :, None, None, :] * col1
    acc = res[:, 0]
    for q in range(1, 4):
        acc = acc + res[:, q]
    return torch.round(acc + FILL).to(out_dtype)


def warp_quadrants(
    imgs: torch.Tensor,
    jx0: torch.Tensor, wx0: torch.Tensor, wx1: torch.Tensor,
    jy0: torch.Tensor, wy0: torch.Tensor, wy1: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """imgs (G, 4, 3, S, S) uint8; x taps ``jx0``/``wx0``/``wx1`` and y taps
    ``jy0``/``wy0``/``wy1``, each (G, 4, So) (int32 / f32) -> the warped
    (G, 3, So, So) ``out_dtype`` (bf16 or f32) images,
    ``rint(sum_q Wy_q (img_q - 114) Ax_q^T + 114)``.
    """
    if imgs.dim() != 5 or imgs.shape[1] != 4 or imgs.shape[2] != 3 or imgs.shape[3] != imgs.shape[4]:
        raise ValueError(f"imgs must be (G, 4, 3, S, S), got {tuple(imgs.shape)}")
    if imgs.dtype != torch.uint8:
        raise ValueError(f"imgs must be uint8, got {imgs.dtype}")
    G = imgs.shape[0]
    taps = (jx0, wx0, wx1, jy0, wy0, wy1)
    So = jx0.shape[-1]
    for t, dt in zip(taps, (torch.int32, torch.float32, torch.float32) * 2):
        if tuple(t.shape) != (G, 4, So) or t.dtype != dt or t.device != imgs.device:
            raise ValueError(f"taps must be ({G}, 4, {So}) {dt} on {imgs.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if out_dtype not in _ENTRY:
        raise ValueError(f"no warp kernel for dtype {out_dtype}")
    if imgs.device.type == "cpu":
        return warp_quadrants_plain(imgs, *taps, out_dtype=out_dtype)
    if imgs.device.type != "cuda":
        raise ValueError(f"no warp kernel for device {imgs.device}")
    if not (imgs.is_contiguous() and all(t.is_contiguous() for t in taps)):
        raise ValueError("imgs and taps must be contiguous")
    if G > 65535 or imgs.shape[-1] > 32767:
        raise ValueError(f"{G} groups or S={imgs.shape[-1]} exceed the kernel's limits "
                         "(65535 groups, S <= 32767)")
    S = imgs.shape[-1]
    out = torch.empty((G, 3, So, So), dtype=out_dtype, device=imgs.device)
    if out.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(imgs.device):
        err = getattr(lib, _ENTRY[out_dtype])(
            imgs.data_ptr(), *(t.data_ptr() for t in taps), out.data_ptr(),
            G, S, So, kbuild.stream_of(imgs),
        )
    kbuild.check(err, "warp_quadrants")
    count_launch(warp_quadrants)
    return out


warp_quadrants.launches = 0
