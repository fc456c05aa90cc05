"""Corpus row gather: the CUDA kernel (K2/K3) and its plain PyTorch version.

Counterpart of ``object_detection_cib_tpu/ops/pallas_gather.py``:
``gather_rows_planar`` (K2, whole planes of the planar (N, 3, S, S) uint8
corpus, the training feed) and ``gather_rows_flat`` (K3, rows of the
(N, 8, D/8) byte view of an NHWC corpus, ``data.corpus_layout=flat``).
The flat layout existed because a TPU tiles its arrays in (8, 128); on the
card a row of any shape is contiguous bytes, so both functions launch the
same kernel file, ``csrc/gather.cu``, over rows of bytes, as a vector copy
with the widest element (16 bytes for every row at 416 or 640) that the
row size and base pointers allow. The JAX package's ``gather_rows`` (any
row shape through the flat view) is ``gather_rows_flat`` on a reshaped
view here; ``gather_rows_nhwc`` is that for an (N, S, S, 3) corpus, the
flat corpus's gather: ``flat_view`` turns the corpus into the (N, 8, D/8)
view K3 takes and the gathered rows are viewed back as (K, S, S, 3), both
views of the same contiguous bytes. The JAX package's rule for the flat
form (``pallas_gather.supports``: D % 1024 == 0, each row whole (8, 128)
tiles) is kept as ``check_flat_rows``, which raises naming S for an image
size that is not a multiple of 32 (the network needs S % 32 == 0 anyway).

CPU tensors take the plain version, ``src[idx]``, which raises on an index
outside [0, N). CUDA tensors launch the kernel or raise; the launch is
counted in ``gather_rows_planar.launches`` or ``gather_rows_flat.launches``
by the entry point that was called (inside a captured CUDA graph, at each
replay: ``ops/graph.py``; so are the other kernels' counts). On the card an out-of-range index is
not detected (that would cost a device-to-host sync): its row comes out as
zeros, so callers validate indices on the host, as ``DeviceDataPipeline``
does for its epoch plan.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from object_detection_cib_torch.ops import build as kbuild
from object_detection_cib_torch.ops.graph import count_launch

_lib: Optional[ctypes.CDLL] = None
ROW_TILE = 8 * 128  # bytes of one (8, 128) uint8 tile


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = kbuild.load("gather")
        lib.odcib_gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ]
        lib.odcib_gather_rows.restype = ctypes.c_int
        _lib = lib
    return _lib


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]``; raises IndexError on an index outside [0, N)."""
    n = src.shape[0]
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise IndexError(f"gather index outside [0, {n})")
    return src[idx.long()]


def _gather(src: torch.Tensor, idx: torch.Tensor, entry) -> torch.Tensor:
    """Launch the kernel for CUDA tensors, counting it on ``entry``."""
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx must be 1-D int32/int64, got {tuple(idx.shape)} {idx.dtype}")
    if idx.device != src.device:
        raise ValueError(f"src on {src.device} but idx on {idx.device}")
    if src.device.type == "cpu":
        return gather_rows_plain(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"no gather kernel for device {src.device}")
    if not src.is_contiguous():
        raise ValueError("src must be contiguous")
    idx = idx.to(torch.int32).contiguous()
    K = idx.shape[0]
    out = torch.empty((K,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    if K == 0 or out.numel() == 0:
        return out
    row_bytes = src[0].numel() * src.element_size()
    lib = _load()
    with torch.cuda.device(src.device):
        err = lib.odcib_gather_rows(
            src.data_ptr(), idx.data_ptr(), out.data_ptr(), src.shape[0], K,
            row_bytes, kbuild.stream_of(src),
        )
    kbuild.check(err, entry.__name__)
    count_launch(entry)
    return out


def gather_rows_planar(corpus: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """corpus (N, C, H, W); idx (K,) -> (K, C, H, W) == corpus[idx] (K2)."""
    if corpus.dim() != 4:
        raise ValueError(f"planar corpus must be (N, C, H, W), got {tuple(corpus.shape)}")
    return _gather(corpus, idx, gather_rows_planar)


def gather_rows_flat(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat (N, 8, D/8); idx (K,) -> (K, 8, D/8) == flat[idx] (K3)."""
    if flat.dim() != 3 or flat.shape[1] != 8:
        raise ValueError(f"flat corpus must be (N, 8, D/8), got {tuple(flat.shape)}")
    return _gather(flat, idx, gather_rows_flat)


def check_flat_rows(S: int) -> None:
    """Raise, naming S, unless an (S, S, 3) uint8 row of D = 3 S^2 bytes is a
    whole number of (8, 128) tiles (JAX ``pallas_gather.supports``)."""
    if (3 * S * S) % ROW_TILE:
        raise ValueError(f"the flat corpus holds each row of D = 3 x S x S bytes as (8, D/8) with D/8 a "
                         f"multiple of 128: S={S} gives D={3 * S * S}; S must be a multiple of 32")


def flat_view(corpus: torch.Tensor) -> torch.Tensor:
    """An NHWC corpus (N, S, S, 3) as the (N, 8, D/8) view K3 gathers."""
    if corpus.dim() != 4 or tuple(corpus.shape[2:]) != (corpus.shape[1], 3):
        raise ValueError(f"an NHWC corpus is (N, S, S, 3), got {tuple(corpus.shape)}")
    n, S = corpus.shape[:2]
    check_flat_rows(S)
    return corpus.view(n, 8, 3 * S * S // 8)


def gather_rows_nhwc(corpus: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """corpus (N, S, S, 3); idx (K,) -> (K, S, S, 3) == corpus[idx]: one K3
    launch on ``flat_view(corpus)``, its rows viewed back as images."""
    S = corpus.shape[1]
    return gather_rows_flat(flat_view(corpus), idx).view(idx.shape[0], S, S, 3)

gather_rows_planar.launches = 0
gather_rows_flat.launches = 0
