"""Greedy-NMS keep mask: the CUDA kernel, its plain PyTorch version, the build.

Counterpart of ``object_detection_cib_tpu/ops/pallas_nms.py``
(``pallas_greedy_nms_mask``). The kernel source is ``csrc/nms.cu``: CUDA C++
for sm_90a with a plain C interface, compiled by ``nvcc`` on first use into
``build/kernels/`` at the root of the checkout and loaded with ``ctypes``
(``ops/build.py``, shared by every kernel of the port).

``greedy_nms_mask`` takes the plain version only for tensors on the CPU; for
a CUDA tensor it launches the kernel or raises. Where the JAX package falls
back to its XLA path when K is not a multiple of 256, the kernel masks the
ragged last tile itself (a row past K is dead: it neither suppresses nor is
kept), so every K up to ``MAX_K`` goes through the kernel unpadded.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from object_detection_cib_torch.core.iou import compute_iou_pairwise
from object_detection_cib_torch.ops import build as kbuild

MAX_K = 8192  # kMaxK in csrc/nms.cu: 20 B of shared memory per box

_lib: Optional[ctypes.CDLL] = None


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/nms.cu`` (if not built yet) and return the library path.

    See ``ops/build.py``; with ``verbose`` the compiler's register and
    shared-memory report (``-Xptxas -v``) is printed.
    """
    return kbuild.build_all(["nms"], verbose=verbose)["nms"]


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = kbuild.load("nms")
        lib.odcib_greedy_nms_mask.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.odcib_greedy_nms_mask.restype = ctypes.c_int
        lib.odcib_nms_max_k.argtypes = []
        lib.odcib_nms_max_k.restype = ctypes.c_int
        if lib.odcib_nms_max_k() != MAX_K:
            raise RuntimeError("csrc/nms.cu kMaxK disagrees with ops/nms.py MAX_K")
        _lib = lib
    return _lib


def greedy_nms_mask_plain(
    boxes: torch.Tensor, live: torch.Tensor, iou_thres: float
) -> torch.Tensor:
    """Plain PyTorch version: (B, K, 4) f32 + (B, K) bool -> (B, K) bool keep.

    The Jacobi fixpoint of ``core/nms.py:_greedy_nms_mask`` in the JAX
    package: keep[i] = live[i] and not any(keep[j] and IoU(j, i) > thr, j < i)
    iterated from keep = live until it stops changing (at most K sweeps; the
    dependency graph is strictly lower-triangular). Holds the (B, K, K) IoU
    matrix, so it is the reference, never the fast path.
    """
    K = boxes.shape[1]
    iou = compute_iou_pairwise(boxes, boxes)  # [b, j, i]: j suppresses i
    thr = torch.tensor(iou_thres, dtype=torch.float32, device=boxes.device)
    later = torch.ones(K, K, dtype=torch.bool, device=boxes.device).triu(1)
    suppress = (iou > thr) & later
    keep = live
    for _ in range(K + 1):
        new = live & ~(suppress & keep[:, :, None]).any(dim=1)
        if torch.equal(new, keep):
            break
        keep = new
    return new


def greedy_nms_mask(
    boxes: torch.Tensor, live: torch.Tensor, iou_thres: float
) -> torch.Tensor:
    """Exact greedy NMS keep mask: (B, K, 4) f32 boxes, (B, K) bool -> (B, K) bool.

    Boxes are xyxy in descending-score order with the per-class offset
    applied (``core/nms.py`` does both). Suppression is IoU strictly greater
    than ``iou_thres``. CPU tensors take ``greedy_nms_mask_plain``; CUDA
    tensors launch the kernel (K <= ``MAX_K``) and count the launch in
    ``greedy_nms_mask.launches``.
    """
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"boxes must be (B, K, 4) float32, got {tuple(boxes.shape)} {boxes.dtype}")
    if live.dtype != torch.bool or tuple(live.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"live must be (B, K) bool, got {tuple(live.shape)} {live.dtype}")
    if live.device != boxes.device:
        raise ValueError(f"boxes on {boxes.device} but live on {live.device}")
    if boxes.device.type == "cpu":
        return greedy_nms_mask_plain(boxes, live, iou_thres)
    if boxes.device.type != "cuda":
        raise ValueError(f"no NMS kernel for device {boxes.device}")
    if not (boxes.is_contiguous() and live.is_contiguous()):
        raise ValueError("boxes and live must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (float4 loads)")
    B, K = live.shape
    if K > MAX_K:
        raise ValueError(f"K={K} exceeds the kernel's limit MAX_K={MAX_K}")
    keep = torch.empty_like(live)
    if B == 0 or K == 0:
        return keep
    lib = _load()
    with torch.cuda.device(boxes.device):
        err = lib.odcib_greedy_nms_mask(
            boxes.data_ptr(), live.data_ptr(), keep.data_ptr(),
            B, K, float(iou_thres), kbuild.stream_of(boxes),
        )
    kbuild.check(err, "greedy NMS")
    greedy_nms_mask.launches += 1
    return keep


greedy_nms_mask.launches = 0
