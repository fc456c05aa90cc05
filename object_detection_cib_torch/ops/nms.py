"""Greedy-NMS keep mask: the CUDA kernel, its plain PyTorch version, the build.

Counterpart of ``object_detection_cib_tpu/ops/pallas_nms.py``
(``pallas_greedy_nms_mask``). The kernel source is ``csrc/nms.cu``: CUDA C++
for sm_90a with a plain C interface, compiled by ``nvcc`` on first use into
``build/kernels/`` at the root of the checkout and loaded with ``ctypes``
(``ops/build.py``, shared by every kernel of the port).

The kernel is two launches inside one call. The first tests every pair
(j, i), j < i, over the whole card and writes 64-bit suppression words (bit
i of word w of row j: "box j suppresses box 64 w + i"; inside a row's own
64-box block the other way round) into a workspace that ``greedy_nms_mask``
allocates; the second walks each image's 64-box blocks in order, resolves a
block's own 64 x 64 words to their fixpoint and ORs the kept rows' later
words into the running "removed" words. ``greedy_nms_mask_words`` is
that algorithm in plain PyTorch, so that it is proven where there is no
card.

``greedy_nms_mask`` takes the plain version only for tensors on the CPU; for
a CUDA tensor it launches the kernel or raises. Where the JAX package falls
back to its XLA path when K is not a multiple of 256, the kernel masks the
ragged last block itself (a row past K is dead: it neither suppresses nor is
kept), so every K up to ``MAX_K`` goes through the kernel unpadded.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from object_detection_cib_torch.core.iou import compute_iou_pairwise
from object_detection_cib_torch.ops import build as kbuild
from object_detection_cib_torch.ops.graph import count_launch

MAX_K = 8192  # kMaxK in csrc/nms.cu: 128 words a row, one per thread of the scan
WORD = 64  # boxes per suppression word (kBlock in csrc/nms.cu)
# Most workspace one call allocates. An image needs K rows of ceil(K / 64)
# words (rounded up to an even count): 0.5 MiB at K = 2048, so the serving
# and validation batches (32 and 64 images) take 16 and 32 MiB at once, and
# 8 MiB at MAX_K, where a larger batch goes through in chunks of 16 images
# that reuse the workspace in stream order.
WORKSPACE_CAP_BYTES = 128 << 20

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
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.odcib_greedy_nms_mask.restype = ctypes.c_int
        for fn in (lib.odcib_nms_workspace_bytes, lib.odcib_nms_scan_smem_bytes):
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_longlong
        lib.odcib_nms_max_k.argtypes = []
        lib.odcib_nms_max_k.restype = ctypes.c_int
        if lib.odcib_nms_max_k() != MAX_K:
            raise RuntimeError("csrc/nms.cu kMaxK disagrees with ops/nms.py MAX_K")
        _lib = lib
    return _lib


def scan_smem_bytes(K: int) -> int:
    """Dynamic shared memory of one block of the kernel's scan at this K."""
    return _load().odcib_nms_scan_smem_bytes(K)


def _iou_above(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """(B, K, K) bool: IoU(j, i) > thr in f32, a symmetric matrix."""
    iou = compute_iou_pairwise(boxes, boxes)
    return iou > torch.tensor(iou_thres, dtype=torch.float32, device=boxes.device)


def _suppression(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """(B, K, K) bool, [b, j, i]: j < i and IoU(j, i) > thr in f32."""
    K = boxes.shape[1]
    later = torch.ones(K, K, dtype=torch.bool, device=boxes.device).triu(1)
    return _iou_above(boxes, iou_thres) & later


def _fixpoint(suppress: torch.Tensor, live: torch.Tensor) -> tuple[torch.Tensor, int]:
    """keep = live & ~any(suppress[j, i] & keep[j]) iterated from keep = live
    until it stops changing, and the number of sweeps that took. ``suppress``
    is strictly upper-triangular, so sweep s settles every box of dependency
    depth s and the fixpoint is the greedy result."""
    K = live.shape[-1]
    keep = live
    for sweeps in range(1, K + 2):
        new = live & ~(suppress & keep[..., :, None]).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    return new, sweeps


def greedy_nms_mask_plain(
    boxes: torch.Tensor, live: torch.Tensor, iou_thres: float, with_sweeps: bool = False
):
    """Plain PyTorch version: (B, K, 4) f32 + (B, K) bool -> (B, K) bool keep.

    The Jacobi fixpoint of ``core/nms.py:_greedy_nms_mask`` in the JAX
    package: keep[i] = live[i] and not any(keep[j] and IoU(j, i) > thr, j < i)
    iterated from keep = live until it stops changing (at most K sweeps; the
    dependency graph is strictly lower-triangular). Holds the (B, K, K) IoU
    matrix, so it is the reference, never the fast path. With
    ``with_sweeps`` also returns the number of sweeps the batch needed: its
    dependency depth plus one, the chain no parallel design can cut.
    """
    keep, sweeps = _fixpoint(_suppression(boxes, iou_thres), live)
    return (keep, sweeps) if with_sweeps else keep


def suppression_words(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """The kernel's workspace in plain PyTorch: (B, K, W) int64, W = ceil(K / 64).

    Right of the diagonal, bit i of ``words[b, j, w]`` is set iff 64 w + i < K
    and box j suppresses box 64 w + i. In the diagonal block (w = j // 64) the
    word reads the other way round, as the scan's vote on box j needs it: bit
    i is set iff box 64 w + i comes before j and suppresses it (IoU is
    symmetric bit for bit). Words left of the diagonal stay 0. As in the
    kernel, when ``iou_thres >= 0`` a pair takes the IoU test only if four
    compares say that it may overlap (where it cannot, the intersection is 0
    and 0 / x > thr is false).
    """
    B, K = boxes.shape[:2]
    W = -(-K // WORD)
    above = _iou_above(boxes, iou_thres)
    if iou_thres >= 0:
        # j's far edge past i's near edge and the other way round, in x and y
        far, near = boxes[..., 2:], boxes[..., :2]
        above = above & (~(far[:, :, None] <= near[:, None, :])
                         & ~(far[:, None, :] <= near[:, :, None])).all(-1)
    at = torch.arange(K, device=boxes.device)
    block = at // WORD
    later_block = block[None, :] > block[:, None]
    same_block_earlier = (block[None, :] == block[:, None]) & (at[None, :] < at[:, None])
    bits = torch.zeros(B, K, W * WORD, dtype=torch.int64, device=boxes.device)
    bits[:, :, :K] = above & (later_block | same_block_earlier)
    # bit 63 is the sign bit of an int64: -2**63, not 2**63
    weight = torch.tensor([1 << i for i in range(WORD - 1)] + [-(1 << 63)],
                          dtype=torch.int64, device=boxes.device)
    return (bits.view(B, K, W, WORD) * weight).sum(-1)


def scan_words(words: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """The kernel's scan in plain PyTorch: (B, K, W) words + (B, K) bool -> keep.

    Walks the 64-box blocks in order. Block b's candidates are its live boxes
    not yet removed; its own 64 x 64 words (word b of its rows: which earlier
    boxes of the block suppress each) are iterated to their fixpoint; the
    later words of the rows it keeps are then ORed into the running "removed"
    words of the later blocks.
    """
    B, K, W = words.shape
    shifts = torch.arange(WORD, dtype=torch.int64, device=words.device)
    keep = torch.zeros_like(live)
    removed = torch.zeros(B, W, dtype=torch.int64, device=words.device)
    for b in range(W):
        lo, hi = b * WORD, min((b + 1) * WORD, K)
        n = hi - lo
        gone = ((removed[:, b, None] >> shifts[:n]) & 1).bool()
        cand = live[:, lo:hi] & ~gone
        suppressed_by = ((words[:, lo:hi, b, None] >> shifts[:n]) & 1).bool()  # [box, earlier box]
        kept, _ = _fixpoint(suppressed_by.transpose(1, 2), cand)
        keep[:, lo:hi] = kept
        rows = torch.where(kept[:, :, None], words[:, lo:hi, b + 1:], 0)
        for j in range(n):
            removed[:, b + 1:] |= rows[:, j]
    return keep


def greedy_nms_mask_words(
    boxes: torch.Tensor, live: torch.Tensor, iou_thres: float
) -> torch.Tensor:
    """The kernel's algorithm (``csrc/nms.cu``) in plain PyTorch: suppression
    words, then the block scan. Equal to ``greedy_nms_mask_plain`` bit for
    bit; kept to prove the algorithm where there is no card."""
    return scan_words(suppression_words(boxes, iou_thres), live)


def greedy_nms_mask(
    boxes: torch.Tensor, live: torch.Tensor, iou_thres: float
) -> torch.Tensor:
    """Exact greedy NMS keep mask: (B, K, 4) f32 boxes, (B, K) bool -> (B, K) bool.

    Boxes are xyxy in descending-score order with the per-class offset
    applied (``core/nms.py`` does both). Suppression is IoU strictly greater
    than ``iou_thres``. CPU tensors take ``greedy_nms_mask_plain``; CUDA
    tensors launch the kernel (K <= ``MAX_K``) and count the call in
    ``greedy_nms_mask.launches`` (one per call: the pair tests and the scan
    go on the current stream together).

    The call allocates the kernel's workspace of suppression words,
    ``B * K * ceil(K / 64) * 8`` bytes (16 MiB at B = 32, K = 2048, which
    stays in the card's L2), at most ``WORKSPACE_CAP_BYTES``: a batch that
    needs more goes through in chunks of images that reuse it. It comes from
    PyTorch's caching allocator, so nothing outlives the call.
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
    per_image = lib.odcib_nms_workspace_bytes(K)
    ws_images = max(1, min(B, WORKSPACE_CAP_BYTES // per_image))
    workspace = torch.empty(ws_images * per_image, dtype=torch.uint8, device=boxes.device)
    with torch.cuda.device(boxes.device):
        err = lib.odcib_greedy_nms_mask(
            boxes.data_ptr(), live.data_ptr(), keep.data_ptr(), workspace.data_ptr(),
            ws_images, B, K, float(iou_thres), kbuild.stream_of(boxes),
        )
    kbuild.check(err, "greedy NMS")
    count_launch(greedy_nms_mask)
    return keep


greedy_nms_mask.launches = 0
