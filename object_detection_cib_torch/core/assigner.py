"""YOLOv5 anchor-target assignment as fixed-shape masked computation.

Counterpart of ``object_detection_cib_tpu/core/assigner.py`` (parity:
kod/core/label_assignment/yv5.py:45-319). Every step runs at the static
capacity ``B x T x A x n_off`` with a validity mask instead of ragged
filtering:

  1. targets in grid units: cxcywh / stride          (ref yv5.py:68-121)
  2. anchor filter: max(wh/a, a/wh) < THRESHOLD      (ref yv5.py:160-176)
  3. neighbour cells: self + up to 2 of 4 neighbours by the 0.5-offset rule
     (ref yv5.py:178-205), in ``offset_capacity`` slots per anchor: 3
     (center, x- and y-neighbour; the JAX package's default) or 5 (the
     reference's full table: self, right, down, left, up)
  4. (sample, anchor, gy, gx) indices (clamped), cell-relative gt boxes
     (cxcy - gij, wh) and per-match anchors          (ref yv5.py:254-296)

Invalid slots carry index 0 and are zeroed by the mask downstream. ``%`` is
floor-mod (``torch.remainder``), as ``jnp``'s is.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from object_detection_cib_torch.core.boxes import xyxy_to_cxcywh
from object_detection_cib_torch.core.types import FeatureShape, LevelAnchors

_OFF_BIAS = 0.5
THRESHOLD = 4.0  # the anchor wh-ratio gate (ref yv5.py:49)


class LevelAssignment(NamedTuple):
    """Per-level assignment at capacity K = B*T*A*n_off, flattened.

    Indices address the head output laid out (B, H, W, A, p).
    """

    sample_idx: torch.Tensor  # (K,) int64 batch index
    anchor_idx: torch.Tensor  # (K,) int64
    grid_y: torch.Tensor  # (K,) int64, clamped to [0, H-1]
    grid_x: torch.Tensor  # (K,) int64, clamped to [0, W-1]
    txywh: torch.Tensor  # (K, 4) cell-relative gt (cxcy - gij, wh), grid units
    labels: torch.Tensor  # (K,) int64
    anchors_wh: torch.Tensor  # (K, 2) anchor (w, h), grid units
    valid: torch.Tensor  # (K,) bool


class Assignment(NamedTuple):
    ll: LevelAssignment
    ml: LevelAssignment
    hl: LevelAssignment

    def levels(self) -> Tuple[LevelAssignment, ...]:
        return (self.ll, self.ml, self.hl)


def _assign_level(
    boxes_xyxy: torch.Tensor,  # (B, T, 4) pixels
    labels: torch.Tensor,  # (B, T) int
    mask: torch.Tensor,  # (B, T) bool
    anchors_px: Union[np.ndarray, torch.Tensor],  # (A, 2) anchor w, h in pixels
    stride: int,
    image_shape: FeatureShape,
    anchor_thr: float,
    offset_capacity: int = 3,
) -> LevelAssignment:
    B, T, _ = boxes_xyxy.shape
    A = anchors_px.shape[0]
    dev = boxes_xyxy.device
    grid_w = image_shape.width / stride  # float, as ref yv5.py:183-187
    grid_h = image_shape.height / stride
    out_w = image_shape.width // stride
    out_h = image_shape.height // stride
    anchors_grid = torch.as_tensor(anchors_px, dtype=torch.float32, device=dev) / stride

    # 1. targets in grid units
    t = xyxy_to_cxcywh(boxes_xyxy.float()) / float(stride)
    cxcy, wh = t[..., 0:2], t[..., 2:4]

    # 2. anchor ratio filter (B, T, A)
    ratio = wh[:, :, None, :] / anchors_grid[None, None, :, :]
    worst = torch.maximum(ratio, 1.0 / ratio).amax(-1)
    anchor_ok = (worst < anchor_thr) & mask[:, :, None]

    # 3. neighbour-cell candidates, independent of the anchor
    gx, gy = cxcy[..., 0], cxcy[..., 1]
    inv_x, inv_y = grid_w - gx, grid_h - gy
    j = (torch.remainder(gx, 1.0) < _OFF_BIAS) & (gx > 1.0)
    k = (torch.remainder(gy, 1.0) < _OFF_BIAS) & (gy > 1.0)
    l = (torch.remainder(inv_x, 1.0) < _OFF_BIAS) & (inv_x > 1.0)
    m = (torch.remainder(inv_y, 1.0) < _OFF_BIAS) & (inv_y > 1.0)

    n_off = offset_capacity
    half = torch.full_like(gx, _OFF_BIAS)
    zeros = torch.zeros_like(gx)
    if offset_capacity == 3:
        # three slots per anchor (center, x-neighbour, y-neighbour): j/l and
        # k/m are exclusive except at exact integers, where the l/m cell
        # duplicates the center match and is dropped
        off_x = torch.where(j, half, -half)
        off_y = torch.where(k, half, -half)
        offsets = torch.stack([
            torch.stack([zeros, zeros], -1),
            torch.stack([off_x, zeros], -1),
            torch.stack([zeros, off_y], -1),
        ], -2)  # (B, T, 3, 2)
        off_ok = torch.stack([torch.ones_like(j), j | l, k | m], -1)
    elif offset_capacity == 5:
        # the table (self, right, down, left, up) times 0.5, built on the
        # boxes' device without a copy from the host
        offsets = torch.stack([
            torch.stack([zeros, zeros], -1),
            torch.stack([half, zeros], -1),
            torch.stack([zeros, half], -1),
            torch.stack([-half, zeros], -1),
            torch.stack([zeros, -half], -1),
        ], -2)  # (B, T, 5, 2)
        off_ok = torch.stack([torch.ones_like(j), j, k, l, m], -1)
    else:
        raise ValueError(f"offset_capacity must be 3 or 5, got {offset_capacity}")

    valid = anchor_ok[..., None] & off_ok[:, :, None, :]  # (B, T, A, n_off)

    # gij = floor(cxcy - off); operands are >= 0 where the offset is valid
    shifted = cxcy[:, :, None, :] - offsets
    gij = torch.floor(shifted)
    txy = (cxcy[:, :, None, :] - gij)[:, :, None, :, :]  # (B, T, 1, n_off, 2)
    gij = gij.to(torch.int64)
    gi = gij[..., 0].clamp(0, out_w - 1)[:, :, None, :]
    gj = gij[..., 1].clamp(0, out_h - 1)[:, :, None, :]

    shape = (B, T, A, n_off)
    K = B * T * A * n_off

    def bc(x, extra=()):
        return x.expand(shape + extra).reshape((K,) + extra)

    ar = lambda n: torch.arange(n, device=dev)  # noqa: E731
    sample_idx = bc(ar(B)[:, None, None, None])
    anchor_idx = bc(ar(A)[None, None, :, None])
    grid_y = bc(gj)
    grid_x = bc(gi)
    txywh = torch.cat([bc(txy, (2,)), bc(wh[:, :, None, None, :], (2,))], -1)
    labels_k = bc(labels.long()[:, :, None, None])
    anchors_k = bc(anchors_grid[None, None, :, None, :], (2,))
    valid_k = valid.reshape(K)

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return LevelAssignment(
        sample_idx=torch.where(valid_k, sample_idx, zero),
        anchor_idx=torch.where(valid_k, anchor_idx, zero),
        grid_y=torch.where(valid_k, grid_y, zero),
        grid_x=torch.where(valid_k, grid_x, zero),
        txywh=txywh,
        labels=torch.where(valid_k, labels_k, zero),
        anchors_wh=anchors_k,
        valid=valid_k,
    )


def compact_level_assignment(level: LevelAssignment, cap: int) -> LevelAssignment:
    """Stable-compact valid slots to the front and truncate to ``cap``.

    Exact whenever the valid count is <= cap; past it, the valid slots in
    original-order tail position are dropped (the train step counts them
    as ``assign_drop``).
    """
    K = int(level.valid.shape[0])
    cap = min(int(cap), K)
    keys = (~level.valid).to(torch.int8)
    idx = torch.argsort(keys, stable=True)[:cap]
    return LevelAssignment(*(f[idx] for f in level))


def assign_targets(
    boxes_xyxy: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    image_shape: FeatureShape,
    anchors: LevelAnchors,
    anchor_tensors: Optional[Sequence[torch.Tensor]] = None,
    threshold: float = THRESHOLD,
    offset_capacity: int = 3,
) -> Assignment:
    """Assign padded GT (B, T, 4) pixels / (B, T) labels / (B, T) mask to the
    three pyramid levels, at ``offset_capacity`` (3 or 5) offset slots per
    anchor and the wh-ratio gate ``threshold``.

    ``anchor_tensors``: each level's (A, 2) anchor pixels already on the
    boxes' device (a copy from host memory would wait for the device).
    """
    if anchor_tensors is None:
        anchor_tensors = [info.as_array() for info in anchors.levels()]
    return Assignment(*(
        _assign_level(boxes_xyxy, labels, mask, a, info.stride, image_shape, threshold, offset_capacity)
        for info, a in zip(anchors.levels(), anchor_tensors)
    ))
