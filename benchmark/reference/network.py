"""YOLOv5 (CSPDarknet, SPPF, PAFPN, three anchor heads) in plain float32.

The layer equations of ultralytics ``models/yolov5{s,l}.yaml`` (v6.0) in the
form the measured program builds them: a 6x6/2 stem, ``ConvBnAct`` = conv
without bias, BatchNorm (eps 1e-3, momentum 0.03, the biased batch variance
in the running statistics) and SiLU; CSP layers at half width; SPPF with
three chained 5x5 max pools; a PAFPN neck; one 1x1 head conv per level
whose output channels are [box (4A) | obj (A) | cls (nc A)]. Parameter and
buffer names are the program's, so one state dict fits both.

Images come in as (B, H, W, 3) in [0, 1]; each head returns (B, h, w,
A (5 + nc)). ``set_quant(True)`` makes it the control of ``correct``: it
computes in fp8 (float8 e4m3, one scale a tensor) what the program
computes in bf16. Every convolution's three products read fp8 operands
and accumulate in float32, and every activation the program stores in
bf16 (a convolution's, BatchNorm's and SiLU's outputs, a residual sum) is
stored in fp8, its gradient too; a head's bias is rounded and its output,
bias added, stored in fp8, as the program's head computes in bf16.
BatchNorm's statistics stay float32, as the program keeps them.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # the largest float8 e4m3 value


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale, values in
    ``x``'s dtype."""
    scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    """fp8 storage of a tensor: its value rounded, and its gradient."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


def stored(x: torch.Tensor, quant: bool) -> torch.Tensor:
    """``x`` as the control stores it (fp8), or as it is."""
    return _Fp8.apply(x) if quant else x


class _Fp8Conv(torch.autograd.Function):
    """A convolution whose three products (forward, input gradient, weight
    gradient) read fp8-rounded operands and accumulate in float32, and whose
    output is stored in fp8, as a bf16 convolution reads and writes bf16."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        xq, wq = fp8_round(x), fp8_round(w)
        ctx.save_for_backward(xq, wq)
        ctx.stride, ctx.padding = stride, padding
        return fp8_round(F.conv2d(xq, wq, None, stride, padding))

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = fp8_round(g)
        gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, ctx.stride, ctx.padding)
        gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, ctx.stride, ctx.padding)
        return gx, gw, None, None


def make_divisible(x: float, widen: float) -> int:
    return math.ceil(x * widen / 8) * 8


def make_round(x: int, deepen: float) -> int:
    return int(max(round(x * deepen), 1) if x > 1 else x)


class BatchNorm(nn.Module):
    def __init__(self, n: int, eps: float = 1e-3, momentum: float = 0.03):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1 - m).add_(var.detach(), alpha=m)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]


class Conv(nn.Module):
    """A convolution that rounds its operands to fp8 when its owner asks."""

    def __init__(self, cin: int, cout: int, k: int, s: int = 1, p: Optional[int] = None, bias: bool = False):
        super().__init__()
        self.stride, self.padding = s, (k - 1) // 2 if p is None else p
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.quant = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant:
            y = _Fp8Conv.apply(x, self.weight, self.stride, self.padding)
            return y if self.bias is None else stored(y + stored(self.bias, True)[:, None, None], True)
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class ConvBnAct(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 3, s: int = 1, p: Optional[int] = None):
        super().__init__()
        self.conv = Conv(cin, cout, k, s, p)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        q = self.conv.quant
        return stored(F.silu(stored(self.bn(self.conv(x)), q)), q)


class CSPBlock(nn.Module):
    def __init__(self, c: int, add: bool):
        super().__init__()
        self.conv1, self.conv2, self.add = ConvBnAct(c, c, 1), ConvBnAct(c, c, 3), add

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return stored(y + x, self.conv1.conv.quant) if self.add else y


class CSPLayer(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, add: bool):
        super().__init__()
        mid = int(cout * 0.5)
        self.short_conv, self.main_conv = ConvBnAct(cin, mid, 1), ConvBnAct(cin, mid, 1)
        self.n = n
        for i in range(n):
            self.add_module(f"block{i}", CSPBlock(mid, add))
        self.last_conv = ConvBnAct(2 * mid, cout, 1)

    def forward(self, x):
        s, m = self.short_conv(x), self.main_conv(x)
        for i in range(self.n):
            m = getattr(self, f"block{i}")(m)
        return self.last_conv(torch.cat([m, s], 1))


class SPPF(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        mid = int(cin * 0.5)
        self.conv1, self.conv2 = ConvBnAct(cin, mid, 1), ConvBnAct(4 * mid, cout, 1)

    def forward(self, x):
        x = self.conv1(x)
        y1 = F.max_pool2d(x, 5, 1, 2)
        y2 = F.max_pool2d(y1, 5, 1, 2)
        y3 = F.max_pool2d(y2, 5, 1, 2)
        return self.conv2(torch.cat([x, y1, y2, y3], 1))


STAGES = ((64, 128, 3, True, False), (128, 256, 6, True, False), (256, 512, 9, True, False),
          (512, 1024, 3, False, True))  # in, out, blocks, identity, SPPF


class Backbone(nn.Module):
    def __init__(self, deepen: float, widen: float):
        super().__init__()
        md = lambda c: make_divisible(c, widen)  # noqa: E731
        self.stem = ConvBnAct(3, md(64), 6, 2, 2)
        prev = md(64)
        for i, (_, cout, n, add, spp) in enumerate(STAGES):
            out = md(cout)
            self.add_module(f"stage{i + 1}_conv", ConvBnAct(prev, out, 3, 2))
            self.add_module(f"stage{i + 1}_csp", CSPLayer(out, out, make_round(n, deepen), add))
            if spp:
                self.add_module(f"stage{i + 1}_sppf", SPPF(out, out))
            prev = out

    def forward(self, x) -> List[torch.Tensor]:
        x = self.stem(x)
        outs = []
        for i, (*_, spp) in enumerate(STAGES):
            x = getattr(self, f"stage{i + 1}_csp")(getattr(self, f"stage{i + 1}_conv")(x))
            if spp:
                x = getattr(self, f"stage{i + 1}_sppf")(x)
            outs.append(x)
        return outs


class Neck(nn.Module):
    """PAFPN over P3/P4/P5 (256, 512, 1024 channels before widening)."""

    def __init__(self, deepen: float, widen: float):
        super().__init__()
        c3, c4, c5 = (make_divisible(c, widen) for c in (256, 512, 1024))
        n = make_round(3, deepen)
        self.reduce_top = ConvBnAct(c5, c4, 1)
        self.top_down_csp2 = CSPLayer(c4 + c4, c4, n, False)
        self.top_down_reduce2 = ConvBnAct(c4, c3, 1)
        self.top_down_csp1 = CSPLayer(c3 + c3, c3, n, False)
        self.downsample0 = ConvBnAct(c3, c3, 3, 2)
        self.bottom_up_csp0 = CSPLayer(c3 + c3, c4, n, False)
        self.downsample1 = ConvBnAct(c4, c4, 3, 2)
        self.bottom_up_csp1 = CSPLayer(c4 + c4, c5, n, False)

    def forward(self, c3, c4, c5):
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        r5 = self.reduce_top(c5)
        i4 = self.top_down_reduce2(self.top_down_csp2(torch.cat([up(r5), c4], 1)))
        p3 = self.top_down_csp1(torch.cat([up(i4), c3], 1))
        p4 = self.bottom_up_csp0(torch.cat([self.downsample0(p3), i4], 1))
        p5 = self.bottom_up_csp1(torch.cat([self.downsample1(p4), r5], 1))
        return p3, p4, p5


class Head(nn.Module):
    def __init__(self, cin: int, anchors: int, nc: int, stride: int):
        super().__init__()
        self.anchors, self.nc, self.stride = anchors, nc, stride
        self.conv = Conv(cin, anchors * (5 + nc), 1, bias=True)

    def forward(self, x):
        return self.conv(x).permute(0, 2, 3, 1)  # (B, h, w, A (5 + nc))


class YOLOv5(nn.Module):
    def __init__(self, nc: int, deepen: float, widen: float, anchors: int = 3):
        super().__init__()
        self.nc = nc
        self.backbone = Backbone(deepen, widen)
        self.neck = Neck(deepen, widen)
        for name, c, s in (("ll_head", 256, 8), ("ml_head", 512, 16), ("hl_head", 1024, 32)):
            self.add_module(name, Head(make_divisible(c, widen), anchors, nc, s))

    def heads(self) -> Tuple[Head, Head, Head]:
        return self.ll_head, self.ml_head, self.hl_head

    def set_quant(self, on: bool) -> None:
        for m in self.modules():
            if isinstance(m, Conv):
                m.quant = on

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = images.permute(0, 3, 1, 2).contiguous()
        _, c3, c4, c5 = self.backbone(x)
        p = self.neck(c3, c4, c5)
        return tuple(h(t) for h, t in zip(self.heads(), p))


def head_priors(nc: int, stride: int) -> Tuple[float, float]:
    """The obj and cls offsets that YOLOv5 adds to its head biases."""
    return math.log(8.0 / (640.0 / stride) ** 2), math.log(0.6 / (nc - 0.99999))
