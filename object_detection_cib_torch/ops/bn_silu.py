"""Training BatchNorm + SiLU of a ``ConvBnAct`` layer as one op: the CUDA
kernels and their plain PyTorch version.

The port's own (like LB): the JAX package leaves BatchNorm and SiLU to XLA.
``models/layers.py:ConvBnAct`` takes this op for a training forward with
grad enabled, local statistics (no process group), no remat policy and a
bf16 activation on the card; every other case keeps the plain layers. The
op raises for a conv output its kernels cannot read (``takes``).

``bn_silu_train`` is a ``torch.autograd.Function``: forward three kernels
of ``csrc/bn_silu.cu`` (the batch statistics, their merge, which also moves
the running statistics in place by flax's rule, and y), backward three (the
sums of dz and dz * x_hat, their merge into the weight's and bias's
gradients, and dx). It saves only the bf16 input and the C floats of the
statistics. The plain versions ``bn_silu_train_plain`` and
``bn_silu_grad_plain`` compute the same function in PyTorch operations,
for the tests to hold the kernels to. One call counts one launch in ``bn_silu_train.launches`` (inside a captured CUDA
graph, at each replay: ``ops/graph.py``).

The function (``C`` channels, ``M = N * H * W`` rows, ``ct`` the compute
dtype: f32, or f64 for f64 input):

  forward   mean, var: the biased batch statistics over N, H, W in ``ct``;
            invstd = rsqrt(var + eps);
            z = ((x - mean) * (invstd * w) + b) rounded to x's dtype;
            y = z / (1 + exp(-z)) rounded to x's dtype;
            running = running * (1 - momentum) + momentum * batch;
  backward  s = 1 / (1 + exp(-z)), dz = dy * s * (1 + z * (1 - s)) in ``ct``;
            x_hat = (x - mean) * invstd; db = sum dz; dw = sum dz * x_hat;
            dx = (dz - db / M - x_hat * dw / M) * (invstd * w).

This is the plain layers' function (``BatchNorm`` then ``F.silu``), with
dz kept in ``ct`` where the plain path rounds it to x's dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from object_detection_cib_torch.ops import build as kbuild
from object_detection_cib_torch.ops.graph import count_launch

_lib: Optional[ctypes.CDLL] = None
VEC = 8  # channels a kernel thread owns: C must be a multiple of it


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = kbuild.load("bn_silu")
        p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        lib.odcib_bn_silu_blocks.argtypes = [ll, i]
        lib.odcib_bn_silu_forward.argtypes = [p, ll, ll, i, i, p, p, p, p, p, f, f, f, p, p, p]
        lib.odcib_bn_silu_backward.argtypes = [p, ll, p, ll, ll, i, i, p, p, p, p, p, p, p, p]
        for fn in (lib.odcib_bn_silu_blocks, lib.odcib_bn_silu_forward, lib.odcib_bn_silu_backward):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def takes(x: torch.Tensor, *params: torch.Tensor) -> bool:
    """Whether the kernels take the conv output ``x`` and the BatchNorm's
    ``params`` (weight, bias, running statistics): x a non-empty bf16
    (N, C, H, W) tensor on the card, ``channels_last`` contiguous, 16-byte
    aligned, with C a multiple of 8; each parameter (C,) f32 and contiguous
    on x's device."""
    return (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 4 and x.numel() > 0
            and x.shape[1] % VEC == 0 and x.is_contiguous(memory_format=torch.channels_last)
            and x.data_ptr() % 16 == 0
            and all(p.shape == (x.shape[1],) and p.dtype == torch.float32 and p.is_contiguous()
                    and p.device == x.device for p in params))


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def bn_silu_train_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
                        running_var: torch.Tensor, momentum: float, eps: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward in PyTorch operations: ``(y, mean, var, invstd)``, the
    running statistics moved in place. The variance is the mean of the
    squared deviations from the mean (two passes)."""
    x32 = x.to(_compute_dtype(x))
    mean = x32.mean((0, 2, 3))
    d = x32 - mean[:, None, None]
    var = (d * d).mean((0, 2, 3))
    invstd = torch.rsqrt(var + eps)
    with torch.no_grad():
        running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1.0 - momentum).add_(var, alpha=momentum)
    return _apply_plain(x, weight, bias, mean, invstd), mean, var, invstd


def _apply_plain(x, weight, bias, mean, invstd):
    """y from the batch statistics ``mean`` and ``invstd``."""
    x32 = x.to(_compute_dtype(x))
    z = ((x32 - mean[:, None, None]) * (invstd * weight)[:, None, None] + bias[:, None, None]).to(x.dtype)
    z = z.to(x32.dtype)
    return (z / (1.0 + torch.exp(-z))).to(x.dtype)


def bn_silu_grad_plain(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       mean: torch.Tensor, invstd: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward in PyTorch operations: ``(dx, dweight, dbias)`` from the
    input, y's gradient and the forward's ``mean`` and ``invstd``."""
    x32 = x.to(_compute_dtype(x))
    scale = invstd * weight
    d = x32 - mean[:, None, None]
    z = (d * scale[:, None, None] + bias[:, None, None]).to(x.dtype).to(x32.dtype)
    s = 1.0 / (1.0 + torch.exp(-z))
    dz = dy.to(x32.dtype) * s * (1.0 + z * (1.0 - s))
    x_hat = d * invstd[:, None, None]
    dbias = dz.sum((0, 2, 3))
    dweight = (dz * x_hat).sum((0, 2, 3))
    rows = x.numel() // x.shape[1]
    dx = (dz - (dbias / rows)[:, None, None] - x_hat * (dweight / rows)[:, None, None]) * scale[:, None, None]
    return dx.to(x.dtype), dweight.to(weight.dtype), dbias.to(bias.dtype)


def _rows_like(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised (N, C, H, W) tensor like ``x`` whose memory is (N, H, W, C)."""
    N, C, H, W = x.shape
    return torch.empty((N, H, W, C), dtype=x.dtype, device=x.device).permute(0, 3, 1, 2)


def _row_stride(t: torch.Tensor) -> Optional[int]:
    """The stride between rows of ``t`` (N, C, H, W) read as (N*H*W, C) rows
    of contiguous channels, 16-byte aligned; None if it is not such rows."""
    N, C, H, W = t.shape
    if t.is_contiguous(memory_format=torch.channels_last):
        ld = C
    else:
        sn, sc, sh, sw = t.stride()
        if sc != 1 or sh != W * sw or sn != H * W * sw or sw < C:
            return None
        ld = sw
    return ld if ld % VEC == 0 and t.data_ptr() % 16 == 0 else None


def _work(x: torch.Tensor, lib) -> Tuple[int, torch.Tensor]:
    N, C, H, W = x.shape
    blocks = lib.odcib_bn_silu_blocks(N * H * W, C)
    if blocks < 1:
        raise ValueError(f"bn_silu: no grid for {tuple(x.shape)}")
    return blocks, torch.empty(2 * blocks * C + blocks, dtype=torch.float32, device=x.device)


def _forward_kernels(x, weight, bias, running_mean, running_var, momentum, eps):
    """The forward on the card: ``(y, stats)``, stats (3, C) f32 rows mean,
    biased var, invstd; the running statistics moved in place."""
    N, C, H, W = x.shape
    lib = _load()
    with torch.cuda.device(x.device):
        blocks, work = _work(x, lib)
        stats = torch.empty(3, C, dtype=torch.float32, device=x.device)
        y = _rows_like(x)
        err = lib.odcib_bn_silu_forward(
            x.data_ptr(), C, N * H * W, C, blocks, work.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(), 1.0 - momentum, momentum, eps,
            stats.data_ptr(), y.data_ptr(), kbuild.stream_of(x))
    kbuild.check(err, "bn_silu forward")
    count_launch(bn_silu_train)
    return y, stats


def _backward_kernels(x, dy, weight, bias, stats):
    """The backward on the card: ``(dx, dweight, dbias)`` from the forward's ``stats``."""
    N, C, H, W = x.shape
    lddy = _row_stride(dy)
    if lddy is None:
        dy = dy.contiguous(memory_format=torch.channels_last)
        lddy = C
    lib = _load()
    with torch.cuda.device(x.device):
        blocks, work = _work(x, lib)
        dweight = torch.empty(C, dtype=torch.float32, device=x.device)
        dbias = torch.empty_like(dweight)
        dx = _rows_like(x)
        err = lib.odcib_bn_silu_backward(
            x.data_ptr(), C, dy.data_ptr(), lddy, N * H * W, C, blocks, work.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), stats.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), dx.data_ptr(),
            kbuild.stream_of(x))
    kbuild.check(err, "bn_silu backward")
    return dx, dweight, dbias


class _BnSiluTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum: float, eps: float):
        y, stats = _forward_kernels(x, weight, bias, running_mean, running_var, momentum, eps)
        ctx.save_for_backward(x, weight, bias, stats)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, bias, stats = ctx.saved_tensors
        dx, dweight, dbias = _backward_kernels(x, dy, weight, bias, stats)
        return dx, dweight, dbias, None, None, None, None


def bn_silu_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
                  running_var: torch.Tensor, momentum: float, eps: float) -> torch.Tensor:
    """silu(BatchNorm(x)) in training mode, differentiable in x, weight and
    bias; the running statistics (C) move in place by flax's rule
    (``momentum`` is torch's convention). ``x`` (N, C, H, W); weight, bias
    and the running statistics f32 and contiguous on x's device, which is
    a card: raises where ``takes`` is false."""
    params = (weight, bias, running_mean, running_var)
    if x.dim() != 4 or any(p.shape != (x.shape[1],) for p in params):
        raise ValueError(f"bn_silu_train: x must be (N, C, H, W) with (C,) parameters, got {tuple(x.shape)}")
    if not x.is_cuda or any(p.device != x.device for p in params):
        raise ValueError(f"bn_silu_train: the kernels run on a card, got x on {x.device}, parameters on "
                         f"{[str(p.device) for p in params]}")
    if not takes(x, *params):
        raise ValueError("bn_silu_train: the kernels take a bf16 channels_last conv output with C % 8 == 0 "
                         f"and contiguous f32 parameters, got {x.dtype} {tuple(x.shape)} strides {x.stride()}, "
                         f"parameters {[p.dtype for p in params]}")
    return _BnSiluTrain.apply(x, weight, bias, running_mean, running_var, momentum, eps)


bn_silu_train.launches = 0
