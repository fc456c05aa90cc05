"""The JPEG loader: decode on the host, letterbox by ``ops/letterbox.py``.

The port's counterpart of ``object_detection_cib_tpu/data/native_loader.py``,
which binds ``native/loader.cpp`` (libjpeg + a C++ resize). The port
computes the same bytes without libjpeg, which the card machine lacks:

* **Decode** with Pillow on a thread pool (``concurrent.futures``; Pillow's
  decoder releases the interpreter lock, as ``loader.cpp``'s ``std::thread``
  workers run outside it), by ``loader.cpp:46-72``'s rules, not Pillow's: a
  JPEG in a colour model libjpeg does not turn into RGB (CMYK, YCCK) fails;
  a truncated file decodes as libjpeg decodes it, the missing data ending
  in an end-of-image marker (libjpeg's ``jpeg_mem_src`` inserts one where
  the bytes run out; here one is appended to the bytes of the call, so
  Pillow's process-wide ``ImageFile.LOAD_TRUNCATED_IMAGES`` stays off and
  the host pipeline's reader still raises on such a file); bytes that are
  not a JPEG fail; no draft or DCT scaling; grayscale is replicated to RGB.
  Pillow's bundled libjpeg-turbo gives the same RGB bytes as the library.
* **Letterbox** (``ops/letterbox.py``): resize to longest side S and pack
  on 114, bitwise ``loader.cpp``'s arithmetic; on the card its CUDA kernel,
  on the CPU its plain version.

``decode_resize_pad``, ``resize_pad_raw`` and ``pack_batch`` keep the JAX
package's names, signatures and numpy (S, S, 3) canvases. The card path
decodes into ``RawImages`` (one byte blob, pinned when asked) and
letterboxes them where the rows live: ``pack_rows``, or ``letterbox`` after
``RawImages.to``. A failed file gives sizes (0, 0) and a canvas of 114.

No data path of the port loads ``native/libodcib.so``, even where it
builds: one config computes through one decoder on every machine.
``build`` and ``get_lib`` stay for the JAX package's library: the root
``conftest.py`` builds it through them before the tests run (under an
``fcntl`` lock in the git-ignored ``build/``, ``make`` on a copy of
``native/`` in a temporary directory, published with ``os.replace``, so
processes that start at once build once and none opens a half-written
library; a failed build or load raises with the compiler's or the loader's
message, and nothing but a success is remembered).
"""

from __future__ import annotations

import ctypes
import fcntl
import io
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from object_detection_cib_torch.ops.letterbox import letterbox

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native"
LOCK_DIR = _ROOT / "build"
LIB_NAME = "libodcib.so"
_SOURCES = ("Makefile", "loader.cpp")
_EOI = b"\xff\xd9"  # end of image: where a truncated file's bytes run out
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
    """The JAX package's loaded library, built on first use; raises if it cannot be."""
    global _lib
    if _lib is None:
        path = build()
        try:
            _lib = _open(path)
        except OSError as e:
            raise RuntimeError(f"loading {path} failed: {e}") from e
    return _lib


def decode_jpeg(jpeg_bytes: bytes) -> Optional[np.ndarray]:
    """One JPEG as ``loader.cpp:decode_jpeg`` decodes it: (h, w, 3) uint8 RGB,
    or None where libjpeg would fail (the module docstring)."""
    from PIL import Image

    try:
        with Image.open(io.BytesIO(bytes(jpeg_bytes) + _EOI), formats=["JPEG"]) as im:
            if im.mode not in ("RGB", "L"):
                return None  # CMYK, YCCK: libjpeg has no conversion to RGB
            im.load()
            return np.asarray(im.convert("RGB") if im.mode == "L" else im)
    except (OSError, ValueError, SyntaxError, Image.DecompressionBombError):
        return None


def pool_threads(num_threads: int = 0) -> int:
    """Decode threads: ``num_threads``, or by default ``loader.cpp``'s callers' min(cores, 16)."""
    return num_threads if num_threads > 0 else min(os.cpu_count() or 1, 16)


class RawImages(NamedTuple):
    """Decoded RGB images back to back in one byte blob."""

    blob: torch.Tensor  # 1-D uint8: image i's (h, w, 3) bytes at offsets[i]
    offsets: torch.Tensor  # (n,) int64
    hw: torch.Tensor  # (n, 2) int32 (h, w); (0, 0) where the file failed to decode
    failures: int

    @classmethod
    def from_arrays(cls, images: Sequence[Optional[np.ndarray]], pin: bool = False) -> "RawImages":
        """(h, w, 3) uint8 arrays, None for a failure, into one blob (pinned
        with ``pin``, the source of a copy to the card that does not block)."""
        hw = np.asarray([a.shape[:2] if a is not None else (0, 0) for a in images],
                        np.int32).reshape(len(images), 2)
        lengths = hw[:, 0].astype(np.int64) * hw[:, 1] * 3
        offsets = np.zeros(len(images), np.int64)
        np.cumsum(lengths[:-1], out=offsets[1:])
        blob = torch.empty(int(lengths.sum()), dtype=torch.uint8, pin_memory=pin)
        flat = blob.numpy()
        for a, off, n in zip(images, offsets, lengths):
            if n:
                flat[off:off + n] = a.reshape(-1)
        return cls(blob, torch.from_numpy(offsets), torch.from_numpy(hw),
                   sum(a is None for a in images))

    def to(self, device: torch.device) -> "RawImages":
        """On ``device``, copied without blocking the host from pinned memory."""
        return RawImages(*(t.to(device, non_blocking=True) for t in self[:3]), self.failures)


def decode_images(jpeg_buffers: Sequence[bytes], num_threads: int = 0) -> List[Optional[np.ndarray]]:
    """``decode_jpeg`` of each buffer, on a pool of ``pool_threads(num_threads)``."""
    threads = min(pool_threads(num_threads), max(len(jpeg_buffers), 1))
    if threads == 1:
        return [decode_jpeg(b) for b in jpeg_buffers]
    with ThreadPoolExecutor(threads, thread_name_prefix="jpeg-decode") as pool:
        return list(pool.map(decode_jpeg, jpeg_buffers))


def decode_raw(jpeg_buffers: Sequence[bytes], num_threads: int = 0, pin: bool = False) -> RawImages:
    """N JPEGs decoded on the host into ``RawImages``."""
    return RawImages.from_arrays(decode_images(jpeg_buffers, num_threads), pin)


def pack_rows(jpeg_buffers: Sequence[bytes], out: torch.Tensor, center: bool = False,
              num_threads: int = 0) -> Tuple[torch.Tensor, int]:
    """N JPEGs decoded on the host and letterboxed into ``out``, an (N, 3, S,
    S) uint8 view on any device (on the card by the kernel, from a pinned
    blob). Returns (N, 2) int32 sizes on ``out``'s device and the failures."""
    raw = decode_raw(jpeg_buffers, num_threads, pin=out.device.type == "cuda")
    sizes = letterbox(*raw.to(out.device)[:3], out, center)
    return sizes, raw.failures


def pack_batch(
    jpeg_buffers: Sequence[bytes], target: int, num_threads: int = 0,
    out: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """N JPEGs -> (N, S, S, 3) canvases + (N, 2) content sizes, on the CPU.

    ``out``, a C-contiguous (N, S, S, 3) uint8 array, receives the canvases
    in place of a new one. Returns (canvases, sizes_hw, num_failures).
    """
    n = len(jpeg_buffers)
    if out is None:
        canvases = np.empty((n, target, target, 3), np.uint8)
    elif out.shape != (n, target, target, 3) or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous ({n}, {target}, {target}, 3) uint8 array, "
                         f"got {out.shape} {out.dtype}")
    else:
        canvases = out
    sizes, failures = pack_rows(jpeg_buffers, torch.from_numpy(canvases).permute(0, 3, 1, 2),
                                num_threads=num_threads)
    return canvases, sizes.numpy(), failures


def decode_resize_pad(jpeg_bytes: bytes, target: int) -> Tuple[np.ndarray, int, int]:
    """One JPEG -> (target, target, 3) uint8 canvas + content (h, w)."""
    canvases, sizes, failures = pack_batch([jpeg_bytes], target, num_threads=1)
    if failures:
        raise ValueError("JPEG decode failed")
    return canvases[0], int(sizes[0, 0]), int(sizes[0, 1])


def resize_pad_raw(img: np.ndarray, target: int) -> Tuple[np.ndarray, int, int]:
    """Raw HWC uint8 -> canvas (bilinear resize, fill 114)."""
    raw = RawImages.from_arrays([np.ascontiguousarray(img, np.uint8)])
    canvas = np.empty((1, target, target, 3), np.uint8)
    sizes = letterbox(*raw[:3], torch.from_numpy(canvas).permute(0, 3, 1, 2))
    return canvas[0], int(sizes[0, 0]), int(sizes[0, 1])
