"""The train step (forward -> assign -> loss -> backward -> SmartSGD) and the
eval step (forward -> decode -> NMS).

Counterpart of ``object_detection_cib_tpu/train/steps.py`` (parity:
kod/lightning/experiments/yv5_baseline/exp.py):
  * training_step (exp.py:104-138): forward(train) -> assign (wh-ratio gate
    ``assign_threshold``, ``assign_offset_capacity`` slots per anchor) ->
    compact the assignment to ``assign_compact_slots * B`` slots per level
    (``None`` or 0: no compaction) -> loss ->
    total = B * (box + obj + cls) -> backward -> SmartSGD; BatchNorm running
    statistics move in the forward;
  * validation_step (exp.py:140-154): forward(eval) -> decode -> NMS
    (conf 0.001 / iou 0.6, exp.py:45-46).
The JAX steps take ``(params, batch_stats, ...)``; here the network module
holds its weights, so the train step takes a batch and the eval step the
images.

``remat_policy`` (the JAX ``jax.checkpoint`` policies over the forward):
each conv + BatchNorm + SiLU layer of the training forward runs as a
``torch.utils.checkpoint`` region (``models/layers.py:Remat``) with a
selective policy that saves what the JAX policy names and recomputes the
rest when the backward reaches the layer: ``conv_out`` the conv outputs
(``aten.convolution``), ``conv_out_bn_stats`` those and the BatchNorm
batch statistics (``aten.var_mean``; under a process group the global
statistics, kept by each ``BatchNorm``, so their all-reduces are not
issued again), ``nothing`` nothing. The recompute moves no running
statistic. Each policy computes the same function as no remat: the
recompute repeats the forward's operators on the same inputs, so the
gradients are those of the step without it.

Data parallelism (``mesh``, a ``parallel.mesh.DataMesh`` with a process
group; JAX ``jit_train_step`` over a ``data`` mesh): each rank steps on its
rows of the global batch B. The BatchNorm statistics are the global
batch's (``models/layers.py:sync_batchnorm``), the loss's denominators too
(``train/loss.py``), ``total = B_global * loss``, and after the backward
one all-reduce (SUM) of every gradient as one flat bucket gives each rank
the gradient of the global loss before SmartSGD, so every rank makes the
same update. ``DistributedDataParallel`` is not used: it divides the sum by
the number of ranks, and its reducer's hooks do not fit a captured CUDA
graph. The step's metrics are this rank's share (their sum over the ranks
is the global step's; the trainer sums them once an epoch); ``lr`` is every
rank's.

The compaction keeps the JAX package's slots: the first ``cap =
assign_compact_slots * B_global`` valid slots of each level of the global
table, which is image-major with the ranks' rows in rank order. One
all-reduce of a (ranks, 3) matrix holding each rank's valid counts in its
row (an all-gather) gives every rank the exclusive prefix ``p_r`` of the
counts before it, so rank r keeps its first ``clamp(cap - p_r, 0, n_r)``
valid slots in a table of ``min(cap, K_local)`` slots (one rank may hold
every kept slot) and marks the rest invalid. ``assign_drop``, each rank's
``n_r - keep_r``, sums over the ranks to the JAX package's global drop.

DP x SP spatial sharding (a mesh with ``model_size`` M > 1, from
``make_mesh(num_data, num_model)``; JAX ``make_train_step(head_sharding=)``
under ``jit_train_step(spatial=True)``): ``batch.images`` is this rank's
data rows cut to its band of H / M image rows, the boxes, labels and masks
its data rows whole (``shard_batch_pytree(..., spatial=True)``). The
network exchanges the row halos of its convs and pools with the model
neighbours and gathers its heads' maps whole (``models/layers.py``,
``parallel/spatial.py``), so the assignment and the loss are those of the
data rows, the same on every model rank. The reductions: over the data
group, the loss's valid counts and image count, the compaction's prefix
and ``cap`` and ``total`` (``B_global`` counts data rows); over every
rank, the BatchNorm statistics and the gradient bucket, whose sum over a
data row's model ranks adds up each band's part of that row's gradient
and over the data ranks each row share of the global loss, as without a
model axis. The step raises, as JAX's ``jit_train_step`` does, unless the
image height H (bands times the band's rows) gives the stride-32 level an
integer of at least 2 rows a band: then every halo (at most 2 rows: the
stem and SPPF) fits in the neighbour's band at every level. A remat policy
combines with it (``models/layers.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from object_detection_cib_torch.core.assigner import (
    THRESHOLD,
    Assignment,
    assign_targets,
    compact_level_assignment,
)
from object_detection_cib_torch.core.nms import NMSResult, non_max_suppression
from object_detection_cib_torch.core.types import FeatureShape, LevelAnchors
from object_detection_cib_torch.eval.decode import decode_predictions
from object_detection_cib_torch.models.layers import Remat, set_remat, set_spatial, sync_batchnorm
from object_detection_cib_torch.parallel.distributed import all_reduce_sum_
from object_detection_cib_torch.parallel.spatial import spatial_of
from object_detection_cib_torch.train.loss import LossParams, yolov5_loss
from object_detection_cib_torch.train.optim import SmartSGD
from object_detection_cib_torch.utils import tracing


class Batch(NamedTuple):
    """Fixed-shape detection batch: targets padded to capacity T with a mask."""

    images: torch.Tensor  # (B, H, W, 3) in [0, 1], feed dtype
    boxes: torch.Tensor  # (B, T, 4) xyxy pixels
    labels: torch.Tensor  # (B, T) int
    mask: torch.Tensor  # (B, T) bool


class StepMetrics(NamedTuple):
    """One train step's losses and lr (0-d f32 tensors, left on the device).

    The fields are in the JAX package's leaf order, which is the row order
    of the fused epoch's stacked metric matrix. Under a process group every
    field but ``lr`` is this rank's share, summed over the ranks by the
    trainer."""

    total: torch.Tensor
    box: torch.Tensor
    obj: torch.Tensor
    cls: torch.Tensor
    lr: torch.Tensor  # the step's lr_other
    # valid assignment slots dropped by the compaction (0 = exact)
    assign_drop: torch.Tensor


def make_train_step(
    net: torch.nn.Module,
    anchors: LevelAnchors,
    image_shape: FeatureShape,
    optimizer: SmartSGD,
    loss_params: LossParams = LossParams(),
    class_weights: Optional[torch.Tensor] = None,
    assign_threshold: float = THRESHOLD,
    assign_offset_capacity: int = 3,
    assign_compact_slots: Optional[int] = 128,
    mesh=None,
    remat_policy: Optional[str] = None,
):
    """Build ``train_step(batch, hp=None) -> StepMetrics``, which updates
    ``net`` in place with the hyperparameter row ``hp`` (``SmartSGD.step``).
    With a ``mesh`` that has a process group, ``batch`` is this rank's rows
    of the global batch and the step is the global one (module docstring);
    the net's BatchNorms are set to the mesh's ranks here. A mesh with a
    model axis makes it the spatial step: ``batch.images`` is this rank's
    band of rows, and the net is set to exchange its halos. ``remat_policy``: None
    (save everything), ``"conv_out"``, ``"conv_out_bn_stats"`` or
    ``"nothing"`` (module docstring); the net's BatchNorms are set to it.

    The assigner knobs and their defaults are the JAX ``make_train_step``'s
    (``model.assign_compact_slots`` and ``configs/assigners/yv5.yaml``).

    The step makes no host-device synchronisation: its losses stay on the
    device, and the anchors are copied to the device once. So it can be
    captured in a CUDA graph (the fused epoch). It marks its stage
    boundaries (``utils/tracing.py:mark``: ``forward_begin``,
    ``forward_end``, ``loss_end`` after the assignment, the compaction and
    the loss, ``backward_end``, and ``allreduce_end`` under a group) into
    the stamp matrix that the fused epoch installs; elsewhere the marks do
    nothing.
    """
    if remat_policy is not None and remat_policy not in REMAT_SAVES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}: expected one of {sorted(REMAT_SAVES)} or None")
    dev = next(net.parameters()).device
    anchor_tensors = [torch.as_tensor(info.as_array()).to(dev) for info in anchors.levels()]
    group = None if mesh is None else mesh.group  # the data axis: the loss, the compaction, the batch
    world = None if group is None else mesh.world  # every rank: BatchNorm and the gradient
    ranks = 1 if group is None else mesh.size
    bands = 1 if mesh is None else mesh.model_size
    if group is not None:
        sync_batchnorm(net, world)
    set_remat(net, None if remat_policy is None else Remat(REMAT_SAVES[remat_policy]))
    set_spatial(net, spatial_of(mesh))
    params = list(net.parameters())

    def train_step(batch: Batch, hp: Optional[torch.Tensor] = None) -> StepMetrics:
        if bands > 1:
            _check_bands(batch.images.shape[1] * bands, bands)
        net.train()
        tracing.mark("forward_begin")
        out = net(batch.images)
        tracing.mark("forward_end")
        assignment = assign_targets(batch.boxes, batch.labels, batch.mask, image_shape,
                                    anchors, anchor_tensors, assign_threshold, assign_offset_capacity)
        assign_drop = torch.zeros((), dtype=torch.int64, device=batch.boxes.device)
        if assign_compact_slots:
            cap = assign_compact_slots * batch.images.shape[0] * ranks  # the global batch's
            if group is None:
                for lv in assignment.levels():
                    n_valid = lv.valid.sum()
                    assign_drop = assign_drop + (n_valid - min(cap, int(lv.valid.shape[0]))).clamp(min=0)
                assignment = Assignment(*(compact_level_assignment(lv, cap) for lv in assignment.levels()))
            else:
                assignment, assign_drop = _compact_over_ranks(assignment, cap, mesh)
        lres = yolov5_loss(out, assignment, image_shape, loss_params, class_weights, group)
        total = batch.images.shape[0] * ranks * lres.total  # ref exp.py:126-130, the global batch
        tracing.mark("loss_end")
        optimizer.zero_grad()
        total.backward()
        tracing.mark("backward_end")
        if group is not None:
            _all_reduce_gradients(params, world)
            tracing.mark("allreduce_end")
        lr_other = optimizer.step(hp)
        return StepMetrics(
            total=total.detach(),
            box=lres.localization.detach(),
            obj=lres.objectness.detach(),
            cls=lres.classification.detach(),
            lr=lr_other,
            assign_drop=assign_drop,
        )

    return train_step


def _check_bands(h: int, m: int) -> None:
    """JAX ``jit_train_step(spatial=True)``'s guard (``train/steps.py:262-281``):
    image height ``h`` over ``m`` bands must leave the stride-32 level an
    integer of at least 2 rows a band."""
    rows32 = h // 32
    if h % (32 * m) != 0 or rows32 // m < 2:
        raise ValueError(
            f"spatial sharding: image height {h} over model axis of size {m} leaves the stride-32 pyramid level "
            f"with {rows32 / m:.2f} rows per shard; need an integer >= 2 (H % (32*model) == 0 and H >= {64 * m}). "
            "Use a smaller model axis or a larger resolution.")


REMAT_SAVES = {  # the operators whose outputs each policy saves (JAX steps.py:116-125)
    "conv_out": (torch.ops.aten.convolution.default,),
    "conv_out_bn_stats": (torch.ops.aten.convolution.default, torch.ops.aten.var_mean.correction),
    "nothing": (),
}


def _compact_over_ranks(assignment: Assignment, cap: int, mesh):
    """Each level compacted to this rank's share of the global table's first
    ``cap`` valid slots (module docstring): ``(assignment, assign_drop)``."""
    levels = assignment.levels()
    n = torch.stack([lv.valid.sum() for lv in levels])  # (3,) int64
    counts = torch.zeros((mesh.size, len(levels)), dtype=n.dtype, device=n.device)
    counts[mesh.rank] = n
    all_reduce_sum_(counts, mesh.group)
    keep = torch.minimum((cap - counts[:mesh.rank].sum(0)).clamp(min=0), n)
    out = []
    for lv, k in zip(levels, keep):
        c = compact_level_assignment(lv, min(cap, int(lv.valid.shape[0])))
        out.append(c._replace(valid=c.valid & (torch.arange(c.valid.shape[0], device=k.device) < k)))
    return Assignment(*out), (n - keep).sum()


def _all_reduce_gradients(params, group) -> None:
    """Sum every parameter's gradient over ``group`` as one flat bucket; the
    gradients become views of the summed bucket. A parameter the backward
    did not reach contributes zeros, so every rank's bucket has one layout."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    if len({g.dtype for g in grads}) != 1:
        raise TypeError(f"gradients of several dtypes: {sorted({str(g.dtype) for g in grads})}")
    flat = all_reduce_sum_(torch.cat([g.reshape(-1) for g in grads]), group)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p)
        offset += n


def make_eval_step(
    net: torch.nn.Module,
    anchors: LevelAnchors,
    conf_thres: float = 0.001,  # ref exp.py:45
    iou_thres: float = 0.6,  # ref exp.py:46
    max_det: int = 300,
    max_nms: int = 2048,
):
    """Build ``eval_step(images) -> NMSResult`` for (B, H, W, 3) images in [0, 1].

    The step runs the network in eval mode (running BN statistics) under
    ``torch.inference_mode`` and restores the module's mode afterwards. Its
    three layers are host spans (``utils/tracing.py:span``):
    ``infer.forward`` (the network), ``infer.decode`` and ``infer.nms``
    (candidate selection, K1, compaction).
    """

    @torch.inference_mode()
    def eval_step(images: torch.Tensor) -> NMSResult:
        was_training = net.training
        net.eval()
        try:
            with tracing.span("infer.forward"):
                out = net(images)
        finally:
            net.train(was_training)
        with tracing.span("infer.decode"):
            det = decode_predictions(out, anchors)
        with tracing.span("infer.nms"):
            return non_max_suppression(
                det,
                conf_thres=conf_thres,
                iou_thres=iou_thres,
                max_det=max_det,
                max_nms=max_nms,
            )

    return eval_step
