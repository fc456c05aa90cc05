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

Not ported: ``SpaceToDepthStem``. It computes the same function as the 6x6/2
pad-2 stem conv from the same (6, 6, 3, C) parameter; it existed only to map
a 3-channel conv onto the TPU's 128-lane matrix unit. The port runs the stem
as a plain 6x6/2 pad-2 conv, so a flax tree trained with the space-to-depth
stem converts unchanged. ``TaggedBatchNorm``'s remat tags and the
``BN_FORCE_F32_STATS`` measurement knob are TPU-only as well.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from object_detection_cib_torch.parallel.distributed import all_reduce_sum_


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
    the train step's gradient all-reduce adds up.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, group, ranks: int, eps: float):
        C = x.shape[1]
        count = x.numel() // C * ranks
        mean = all_reduce_sum_(x.sum((0, 2, 3)), group) / count
        d = x - mean[:, None, None]
        var = all_reduce_sum_((d * d).sum((0, 2, 3)), group) / count
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
        return dx, sum_dy_xhat, sum_dy, None, None, None


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
        if self.group is not None:
            import torch.distributed as dist

            y, mean, var = _GlobalBatchNorm.apply(x32, self.weight.to(x32.dtype), self.bias.to(x32.dtype),
                                                  self.group, dist.get_world_size(self.group), self.eps)
            self._move_running(mean, var)
            return y.to(x.dtype)
        var, mean = torch.var_mean(x32, dim=(0, 2, 3), unbiased=False)
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


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` applied in the activation's dtype (weights cast to it)."""
    w = conv.weight.to(x.dtype)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, w, b, conv.stride, conv.padding)


class ConvBnAct(nn.Module):
    """Conv (no bias) + BatchNorm(eps 1e-3, momentum 0.03) + SiLU.

    Conv2dNormActivation equivalent (BN settings: ref networks/yolov5.py:24).
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(conv2d(x, self.conv)))


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


def _maxpool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """Stride-1 max pool with 'same' padding k//2 (torch MaxPool2d parity), NCHW.

    The JAX package pads with ``finfo(dtype).min`` and takes the max over the
    k*k shifted views (models/layers.py:309-335); ``F.max_pool2d`` pads with
    -inf. Every window holds at least one real element (its centre), so the
    padding never wins the max and both give the same result.
    """
    return F.max_pool2d(x, k, stride=1, padding=k // 2)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        k = self.kernel_size
        y1 = _maxpool_same(x, k)
        y2 = _maxpool_same(y1, k)
        y3 = _maxpool_same(y2, k)
        return self.conv2(torch.cat([x, y1, y2, y3], dim=1))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode='nearest') parity, NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
