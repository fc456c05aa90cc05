"""Building-block layers: ConvBnAct, CSP blocks, SPPF, as ``nn.Module``s.

Counterpart of ``object_detection_cib_tpu/models/layers.py`` (parity:
torchvision Conv2dNormActivation as used across kod/nn/, kod/nn/layers/csp.py
and kod/nn/layers/sppf.py). Module and parameter names follow the flax tree
(``conv``, ``bn``, ``short_conv``, ``block0`` ...) so ``models/convert.py``
maps weights one to one.

Layout: these layers take and return NCHW tensors, which the network keeps in
``torch.channels_last`` memory format (the same bytes as the JAX package's
NHWC). The network's public contract stays NHWC (``models/yolov5.py``).

Compute dtype is the dtype of the incoming activation: the network casts its
input once (bf16 in production) and each conv casts its f32 weight to match,
as flax's ``dtype=`` promotion does. BatchNorm statistics and its affine
transform run in f32 (in f64 for an f64 activation); its output goes back to
the activation dtype. Under a process group (``sync_batchnorm``) the
training statistics are those of the global batch, as the JAX package's
BatchNorm computes them over a batch sharded on its mesh.

DP x SP spatial sharding (``set_spatial``; JAX ``jit_train_step(spatial=
True)``, where GSPMD inserts the halo exchanges): each rank holds a band of
every image's rows. Every conv wider than 1x1 and each of SPPF's pools first
exchanges the rows it reads beyond the band with the model neighbours
(``parallel/spatial.py``: zeros at the image's top and bottom edges for a
conv, the dtype's lowest value for a pool), then runs with no H padding and
its own W padding; the halo'd tensor is ``channels_last``. 1x1 convs, the
upsample and the concats stay local. The BatchNorms then take their
statistics over every rank of the mesh, data and model axes alike
(``sync_batchnorm(net, mesh.world)``): every band has the same size, so the
count is a band's times the ranks, as for the data axis alone. Under a
remat policy a layer exchanges its halo before its checkpoint region, so
the recompute reads the saved halo'd input and sends nothing.

Not ported: ``SpaceToDepthStem``. It computes the same function as the 6x6/2
pad-2 stem conv from the same (6, 6, 3, C) parameter; it existed only to map
a 3-channel conv onto the TPU's 128-lane matrix unit. The port runs the stem
as a plain 6x6/2 pad-2 conv, so a flax tree trained with the space-to-depth
stem converts unchanged. The ``BN_FORCE_F32_STATS`` measurement knob is
TPU-only as well.

Rematerialisation (``train/steps.py``, ``remat_policy``; ``Remat``,
``set_remat``): the JAX package tags the conv outputs (``conv_out``) and
``TaggedBatchNorm``'s batch statistics (``bn_stats``) by name and
checkpoints the whole forward, which XLA recomputes piece by piece inside
the backward. Here each ``ConvBnAct`` of a training forward is one
non-reentrant ``torch.utils.checkpoint`` region under a selective policy
that finds the conv output and the local statistics by their operators
(``aten.convolution``, ``aten.var_mean``) and recomputes the rest when the
backward reaches the layer. One region over the whole forward would
recompute all of it at the backward's first step and hold it all at once,
the peak memory of no remat (measured, PERF.md). The recompute moves no
running statistic a second time and, where the policy saves the
statistics, reuses the global ones of the forward rather than issuing
their all-reduces again.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from object_detection_cib_torch.ops import bn_silu
from object_detection_cib_torch.parallel.distributed import all_reduce_sum_
from object_detection_cib_torch.parallel.spatial import Spatial, conv_reach


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch of a process group:
    ``(x, weight, bias) -> (y, mean, var)``, every tensor in one float dtype.

    Forward, two-pass as the local path: the per-channel sums over N, H, W
    are summed over the ranks, giving the mean; then the sums of squared
    deviations from that mean, giving the biased variance. Every rank has
    the same number of rows (the global batch divides evenly), so the count
    is this rank's times the group's size. Backward: the per-channel sums of
    ``dy`` and ``dy * x_hat`` are summed over the ranks (one all-reduce) for
    ``dx``; the weight's and bias's gradients are this rank's sums, which
    the train step's gradient all-reduce adds up. ``stats``, the (mean, var)
    this batch already gave, skips the two forward all-reduces: the
    recompute of a remat policy that saves the statistics.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, group, ranks: int, eps: float, stats=None):
        C = x.shape[1]
        count = x.numel() // C * ranks
        if stats is None:
            mean = all_reduce_sum_(x.sum((0, 2, 3)), group) / count
            d = x - mean[:, None, None]
            var = all_reduce_sum_((d * d).sum((0, 2, 3)), group) / count
        else:  # the statistics this batch already gave (a recompute that saves them)
            mean, var = (t.detach() for t in stats)
            d = x - mean[:, None, None]
        invstd = torch.rsqrt(var + eps)
        x_hat = d * invstd[:, None, None]
        ctx.save_for_backward(x_hat, invstd, weight)
        ctx.group, ctx.count = group, count
        ctx.mark_non_differentiable(mean, var)
        return x_hat * weight[:, None, None] + bias[:, None, None], mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x_hat, invstd, weight = ctx.saved_tensors
        C = x_hat.shape[1]
        sum_dy = dy.sum((0, 2, 3))
        sum_dy_xhat = (dy * x_hat).sum((0, 2, 3))
        both = all_reduce_sum_(torch.cat([sum_dy, sum_dy_xhat]), ctx.group)
        mean_dy, mean_dy_xhat = both[:C] / ctx.count, both[C:] / ctx.count
        dx = (dy - mean_dy[:, None, None] - x_hat * mean_dy_xhat[:, None, None]) * (invstd * weight)[:, None, None]
        return dx, sum_dy_xhat, sum_dy, None, None, None, None


class Remat:
    """A remat policy shared by the layers of one network (``set_remat``):
    the outputs of the operators ``saves`` are kept for the backward,
    everything else of a ``ConvBnAct`` is recomputed there; ``save_stats``,
    the batch statistics among them (``conv_out_bn_stats``). ``recomputing``
    is true while the backward recomputes a layer."""

    def __init__(self, saves: Sequence = ()):
        self.saves = tuple(saves)
        self.save_stats = torch.ops.aten.var_mean.correction in self.saves
        self.recomputing = False

    def _policy(self, ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in self.saves else CheckpointPolicy.PREFER_RECOMPUTE

    @contextlib.contextmanager
    def _recompute(self, ctx):
        self.recomputing = True
        try:
            with ctx:
                yield
        finally:
            self.recomputing = False

    def contexts(self):
        """The checkpoint's ``context_fn``: the selective policy's forward
        and recompute contexts, the recompute marked on this state."""
        forward_ctx, recompute_ctx = create_selective_checkpoint_contexts(self._policy)
        return forward_ctx, self._recompute(recompute_ctx)

    def run(self, fn, x: torch.Tensor) -> torch.Tensor:
        """``fn(x)`` as one checkpoint region (no RNG state kept: the network
        draws nothing, and a CUDA graph capture must not read the generator)."""
        return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False, context_fn=self.contexts)


class BatchNorm(nn.Module):
    """BatchNorm over NCHW channels with flax's semantics.

    Eval: running statistics (``F.batch_norm``). Train: batch statistics
    (biased two-pass variance, over N, H, W in f32, or f64 for f64 input), and the running statistics move
    as flax moves them: ``ra = (1 - momentum) * ra + momentum * batch`` with
    the BIASED batch variance (torch's ``BatchNorm2d`` would use the unbiased
    one). ``momentum`` is torch's convention: 0.03 here is flax's decay 0.97.

    With a process group in ``group`` (set by ``sync_batchnorm``) the batch
    statistics are the global batch's, summed over the ranks in the same
    two passes (``_GlobalBatchNorm``), and the running statistics move
    alike on every rank. ``nn.SyncBatchNorm`` is not used: it moves the
    running variance with the unbiased estimate and combines per-rank
    moments in one pass.
    """

    def __init__(self, num_features: int, eps: float = 1e-3, momentum: float = 0.03):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.group = None  # a process group: statistics over the global batch
        self.remat: Optional[Remat] = None  # set by the train step's rematerialisation
        self._stats = None  # the global (mean, var) of the last forward, kept for its recompute
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                training=False, eps=self.eps,
            )
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        remat = self.remat
        recomputing = remat is not None and remat.recomputing
        if self.group is not None:
            import torch.distributed as dist

            keep = remat is not None and remat.save_stats
            y, mean, var = _GlobalBatchNorm.apply(x32, self.weight.to(x32.dtype), self.bias.to(x32.dtype),
                                                  self.group, dist.get_world_size(self.group), self.eps,
                                                  self._stats if keep and recomputing else None)
            if keep and not recomputing:
                self._stats = (mean, var)
            if not recomputing:
                self._move_running(mean, var)
            return y.to(x.dtype)
        var, mean = torch.var_mean(x32, dim=(0, 2, 3), unbiased=False)
        if not recomputing:
            self._move_running(mean, var)
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)

    @torch.no_grad()
    def _move_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var, alpha=m)


def sync_batchnorm(net: nn.Module, group) -> None:
    """Make every ``BatchNorm`` of ``net`` take its training statistics over
    the global batch of ``group`` (None: this process's batch)."""
    for m in net.modules():
        if isinstance(m, BatchNorm):
            m.group = group


def set_remat(net: nn.Module, remat: Optional[Remat]) -> None:
    """Give every ``ConvBnAct`` and ``BatchNorm`` of ``net`` the train step's
    ``Remat`` policy (None: no rematerialisation)."""
    for m in net.modules():
        if isinstance(m, (ConvBnAct, BatchNorm)):
            m.remat = remat


def set_spatial(net: nn.Module, spatial: Optional[Spatial]) -> None:
    """Make every conv wider than 1x1 and every SPPF pool of ``net`` run on
    a band of image rows with its halo from ``spatial``'s model neighbours,
    and the network gather its heads over them (None: whole images)."""
    for m in net.modules():
        if isinstance(m, ConvBnAct):
            m.spatial = spatial if m.conv.kernel_size[0] > 1 else None
        elif hasattr(m, "spatial"):
            m.spatial = spatial


def conv2d(x: torch.Tensor, conv: nn.Conv2d, pad_rows: bool = True) -> torch.Tensor:
    """``conv`` applied in the activation's dtype (weights cast to it);
    ``pad_rows`` False: no H padding (``x`` carries its halo rows)."""
    w = conv.weight.to(x.dtype)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, w, b, conv.stride, conv.padding if pad_rows else (0, conv.padding[1]))


class ConvBnAct(nn.Module):
    """Conv (no bias) + BatchNorm(eps 1e-3, momentum 0.03) + SiLU.

    Conv2dNormActivation equivalent (BN settings: ref networks/yolov5.py:24).
    A training forward with grad enabled, local statistics, no remat policy
    and a bf16 activation on the card runs BatchNorm and SiLU as one op
    (``ops/bn_silu.py``), which raises for a conv output its kernels cannot
    read; everything else runs the plain layers.
    """

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: Optional[int] = None,  # None -> (k-1)//2, torchvision default
    ):
        super().__init__()
        k = kernel_size
        pad = (k - 1) // 2 if padding is None else padding
        self.conv = nn.Conv2d(in_channels, features, k, stride, pad, bias=False)
        self.bn = BatchNorm(features)
        self.remat: Optional[Remat] = None  # set by the train step's rematerialisation
        self.spatial: Optional[Spatial] = None  # set by set_spatial: x is a band of image rows

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.spatial is not None:  # before any remat region: its recompute sends nothing
            x = self.spatial.exchange(x, *conv_reach(self.conv.kernel_size[0], self.conv.stride[0],
                                                     self.conv.padding[0]))
        if self.remat is not None and self.training and torch.is_grad_enabled():
            return self.remat.run(self._forward, x)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d(x, self.conv, pad_rows=self.spatial is None)
        bn = self.bn
        if (bn.training and torch.is_grad_enabled() and bn.group is None and self.remat is None
                and x.is_cuda and x.dtype == torch.bfloat16):
            return bn_silu.bn_silu_train(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.momentum, bn.eps)
        return F.silu(bn(x))


class CSPBlock(nn.Module):
    """1x1 -> 3x3 with optional residual (ref csp.py:16-58).

    Inner expand ratio 1.0, the only one CSPLayer uses (ref csp.py:95).
    """

    def __init__(self, features: int, add_identity: bool = True):
        super().__init__()
        self.conv1 = ConvBnAct(features, features, 1)
        self.conv2 = ConvBnAct(features, features, 3)
        self.add_identity = add_identity

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        return out + x if self.add_identity else out


class CSPLayer(nn.Module):
    """Cross-stage-partial layer (ref csp.py:66-111).

    short/main 1x1 branches at half width, N CSPBlocks on main, concat, 1x1
    out.
    """

    def __init__(
        self, in_channels: int, features: int, num_blocks: int = 1, add_identity: bool = True
    ):
        super().__init__()
        mid = int(features * 0.5)
        self.short_conv = ConvBnAct(in_channels, mid, 1)
        self.main_conv = ConvBnAct(in_channels, mid, 1)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block{i}", CSPBlock(mid, add_identity=add_identity))
        self.last_conv = ConvBnAct(2 * mid, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_short = self.short_conv(x)
        x_main = self.main_conv(x)
        for i in range(self.num_blocks):
            x_main = getattr(self, f"block{i}")(x_main)
        return self.last_conv(torch.cat([x_main, x_short], dim=1))


def _maxpool_same(x: torch.Tensor, k: int, spatial: Optional[Spatial] = None) -> torch.Tensor:
    """Stride-1 max pool with 'same' padding k//2 (torch MaxPool2d parity), NCHW.

    The JAX package pads with ``finfo(dtype).min`` and takes the max over the
    k*k shifted views (models/layers.py:309-335); ``F.max_pool2d`` pads with
    -inf. Every window holds at least one real element (its centre), so the
    padding never wins the max and both give the same result. With
    ``spatial``, ``x`` is a band: its halo rows come from the neighbours,
    ``finfo(dtype).min`` at the image's edges, and only W is padded.
    """
    if spatial is None:
        return F.max_pool2d(x, k, stride=1, padding=k // 2)
    x = spatial.exchange(x, *conv_reach(k, 1, k // 2), fill=torch.finfo(x.dtype).min)
    return F.max_pool2d(x, k, stride=1, padding=(0, k // 2))


class SPPFBottleneck(nn.Module):
    """Spatial pyramid pooling - fast (ref sppf.py:14-85).

    1x1 to half width, 3 chained k x k pools, concat(x, y1, y2, y3), 1x1 out.
    The JAX module's options (parallel-pool SPP list, no first conv) have no
    caller in the network and are not ported.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int = 5):
        super().__init__()
        self.kernel_size = kernel_size
        mid = int(in_channels * 0.5)
        self.conv1 = ConvBnAct(in_channels, mid, 1)
        self.conv2 = ConvBnAct(4 * mid, features, 1)
        self.spatial: Optional[Spatial] = None  # set by set_spatial: the pools run on a band

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        k, sp = self.kernel_size, self.spatial
        y1 = _maxpool_same(x, k, sp)
        y2 = _maxpool_same(y1, k, sp)
        y3 = _maxpool_same(y2, k, sp)
        return self.conv2(torch.cat([x, y1, y2, y3], dim=1))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode='nearest') parity, NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
