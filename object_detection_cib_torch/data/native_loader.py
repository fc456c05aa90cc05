"""ctypes bindings for the C++ loader core (native/loader.cpp).

A copy of ``object_detection_cib_tpu/data/native_loader.py`` over the same
repo-level ``native/`` library, found by the same relative path. Only
reached outside fake mode.

Builds on first use (g++ + libjpeg, both baked into the image) and degrades
gracefully to the PIL/cv2 path when unavailable. The batch entry point
decodes+resizes+letterboxes N JPEGs with std::thread — no GIL, one Python
call per batch.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libodcib.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return _LIB_PATH.exists()
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.odcib_decode_resize_pad.restype = ctypes.c_int
        lib.odcib_resize_pad_raw.restype = ctypes.c_int
        lib.odcib_pack_batch.restype = ctypes.c_int
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return get_lib() is not None


def decode_resize_pad(jpeg_bytes: bytes, target: int) -> Tuple[np.ndarray, int, int]:
    """One JPEG -> (target, target, 3) uint8 canvas + content (h, w)."""
    lib = get_lib()
    assert lib is not None
    canvas = np.empty((target, target, 3), np.uint8)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.odcib_decode_resize_pad(
        jpeg_bytes,
        ctypes.c_long(len(jpeg_bytes)),
        target,
        canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(h),
        ctypes.byref(w),
    )
    if rc:
        raise ValueError("JPEG decode failed")
    return canvas, h.value, w.value


def resize_pad_raw(img: np.ndarray, target: int) -> Tuple[np.ndarray, int, int]:
    """Raw HWC uint8 -> canvas (native bilinear resize, fill 114)."""
    lib = get_lib()
    assert lib is not None
    img = np.ascontiguousarray(img, np.uint8)
    canvas = np.empty((target, target, 3), np.uint8)
    h = ctypes.c_int()
    w = ctypes.c_int()
    lib.odcib_resize_pad_raw(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        img.shape[0],
        img.shape[1],
        target,
        canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(h),
        ctypes.byref(w),
    )
    return canvas, h.value, w.value


def pack_batch(
    jpeg_buffers: Sequence[bytes], target: int, num_threads: int = 0
) -> Tuple[np.ndarray, np.ndarray, int]:
    """N JPEGs -> (N, S, S, 3) canvases + (N, 2) content sizes, parallel.

    Returns (canvases, sizes_hw, num_failures).
    """
    lib = get_lib()
    assert lib is not None
    n = len(jpeg_buffers)
    blob = b"".join(jpeg_buffers)
    offsets = np.zeros(n, np.int64)
    lengths = np.asarray([len(b) for b in jpeg_buffers], np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    canvases = np.empty((n, target, target, 3), np.uint8)
    sizes = np.zeros((n, 2), np.int32)
    if num_threads <= 0:
        num_threads = min(os.cpu_count() or 1, 16)
    failures = lib.odcib_pack_batch(
        blob,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        n,
        target,
        num_threads,
        canvases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return canvases, sizes, int(failures)
