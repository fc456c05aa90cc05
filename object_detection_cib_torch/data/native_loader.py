"""ctypes bindings for the C++ loader core (native/loader.cpp).

A copy of ``object_detection_cib_tpu/data/native_loader.py`` over the same
repo-level ``native/`` library, found by the same relative path. Only
reached outside fake mode. The batch entry point decodes+resizes+letterboxes
N JPEGs with std::thread — no GIL, one Python call per batch.

The library is built on first use (g++ + libjpeg) by ``build``: under an
``fcntl`` lock in the git-ignored ``build/``, ``make`` runs on a copy of
``native/Makefile`` and ``native/loader.cpp`` in a temporary directory, and
the result is published with ``os.replace``. Processes that start at once
(pytest-xdist workers) therefore build once, and none ever opens a
half-written ``libodcib.so``. A failed build or load raises with the
compiler's or the loader's message; nothing is remembered but a success.
The port has no PIL/cv2 path to fall back to.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native"
LOCK_DIR = _ROOT / "build"
LIB_NAME = "libodcib.so"
_SOURCES = ("Makefile", "loader.cpp")
_lib: Optional[ctypes.CDLL] = None


def _open(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.odcib_decode_resize_pad.restype = ctypes.c_int
    lib.odcib_resize_pad_raw.restype = ctypes.c_int
    lib.odcib_pack_batch.restype = ctypes.c_int
    return lib


def build(native_dir: Path = NATIVE_DIR, lock_dir: Path = LOCK_DIR) -> Path:
    """``native_dir/libodcib.so``, built and published atomically if it is
    missing or does not load. Raises RuntimeError with the compiler's
    output if ``make`` fails."""
    native_dir, lock_dir = Path(native_dir), Path(lock_dir)
    lib_path = native_dir / LIB_NAME
    lock_dir.mkdir(parents=True, exist_ok=True)
    with open(lock_dir / f"{LIB_NAME}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if lib_path.exists():
            try:
                _open(lib_path)
                return lib_path
            except OSError:
                pass  # incomplete or stale (another writer): build anew
        with tempfile.TemporaryDirectory(dir=lock_dir) as tmp:
            for name in _SOURCES:
                shutil.copy2(native_dir / name, Path(tmp) / name)
            proc = subprocess.run(["make", "-C", tmp], capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"building {lib_path} failed (make exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            fd, staged = tempfile.mkstemp(prefix=".staged-", suffix=".so", dir=native_dir)
            os.close(fd)
            try:
                shutil.copyfile(Path(tmp) / LIB_NAME, staged)
                os.chmod(staged, 0o755)
                os.replace(staged, lib_path)
            except BaseException:
                os.unlink(staged)
                raise
    return lib_path


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises if it cannot be."""
    global _lib
    if _lib is None:
        path = build()
        try:
            _lib = _open(path)
        except OSError as e:
            raise RuntimeError(f"loading {path} failed: {e}") from e
    return _lib


def decode_resize_pad(jpeg_bytes: bytes, target: int) -> Tuple[np.ndarray, int, int]:
    """One JPEG -> (target, target, 3) uint8 canvas + content (h, w)."""
    lib = get_lib()
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
    jpeg_buffers: Sequence[bytes], target: int, num_threads: int = 0,
    out: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """N JPEGs -> (N, S, S, 3) canvases + (N, 2) content sizes, parallel.

    ``out``, a C-contiguous (N, S, S, 3) uint8 array (for example the numpy
    view of a pinned tensor), receives the canvases in place of a new one.
    Returns (canvases, sizes_hw, num_failures).
    """
    lib = get_lib()
    n = len(jpeg_buffers)
    blob = b"".join(jpeg_buffers)
    offsets = np.zeros(n, np.int64)
    lengths = np.asarray([len(b) for b in jpeg_buffers], np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    if out is None:
        canvases = np.empty((n, target, target, 3), np.uint8)
    elif out.shape != (n, target, target, 3) or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous ({n}, {target}, {target}, 3) uint8 array, "
                         f"got {out.shape} {out.dtype}")
    else:
        canvases = out
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
