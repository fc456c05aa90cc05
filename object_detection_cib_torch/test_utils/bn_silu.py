"""The training BatchNorm + SiLU kernels (``ops/bn_silu.py``) against their
plain versions on the card: the layer shapes, the inputs, the measure of a
gap and its limits. The card tests (``tests/test_torch_cuda.py``) and
``chip_smoke.py`` hold the kernels to these."""

from __future__ import annotations

from typing import Dict

import torch

from object_detection_cib_torch.ops import bn_silu as bn_ops

# (side, C, layers): every training BatchNorm's (M = 64 side^2 rows, C) of
# yolov5s and yolov5l at 416 px, B = 64, and how many layers have it
LAYERS = {"s": [(208, 32, 1), (104, 64, 2), (104, 32, 4), (52, 128, 3), (52, 64, 10), (26, 256, 4),
                (26, 128, 18), (13, 512, 4), (13, 256, 11)],
          "l": [(208, 64, 1), (104, 128, 2), (104, 64, 8), (52, 256, 3), (52, 128, 22), (26, 512, 4),
                (26, 256, 38), (13, 1024, 4), (13, 512, 19)]}
# Measured against the plain version on the card (NVIDIA H100 80GB HBM3, at
# yolov5s's layer shapes and yolov5l's 1024 channels): the mean's gap over
# the channel's std (largest reading 1.5e-6), the variance's relative gap
# (5.7e-7), the weight's and bias's gradients' gaps over their largest
# magnitude (6.1e-5, 4.9e-5) and dx's (2.8e-3, under one bf16 unit of the
# largest dx); each limit a few times the largest reading over these shapes
TOL = {"mean": 1e-5, "var": 1e-5, "dweight": 3e-4, "dbias": 3e-4, "dx": 1e-2}
# y against the plain version from the kernels' own statistics: at most one
# bf16 unit. Against the plain version's statistics a z on a rounding
# boundary may round the other way, which moves a small y by many of its
# units (a few in 10^4 of y differ, measured up to 2.2e-4): at most one in
# 10^3 may differ.
Y_OWN_UNITS, Y_UNEQUAL = 1, 1e-3


def layer_inputs(dev, N: int, C: int, H: int, W: int, seed: int, center: float = 0.0):
    """``(x, dy, weight, bias, running_mean, running_var)`` from ``seed``: x
    and dy bf16 ``channels_last`` (N, C, H, W), x's channels of means
    ``center`` -2 to +2 and std 3 to 0.5; the rest (C,) f32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (N, H, W, C)
    mu = center + torch.linspace(-2.0, 2.0, C, device=dev)
    sd = torch.linspace(3.0, 0.5, C, device=dev)
    x = (torch.randn(shape, generator=g, device=dev) * sd + mu).to(torch.bfloat16).permute(0, 3, 1, 2)
    dy = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16).permute(0, 3, 1, 2)
    w = 0.5 + torch.rand(C, generator=g, device=dev)
    b = 0.5 * torch.randn(C, generator=g, device=dev)
    return x, dy, w, b, torch.randn(C, generator=g, device=dev), 0.5 + torch.rand(C, generator=g, device=dev)


def bf16_units(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 units between ``a`` and ``b``, elementwise (ordered bit patterns)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def against_plain(x, dy, w, b, rm, rv, momentum: float = 0.03, eps: float = 1e-3) -> Dict[str, float]:
    """The kernels (forward, then backward from its statistics) against
    ``bn_silu_train_plain`` / ``bn_silu_grad_plain`` on the same inputs:
    the gaps of the statistics (the running ones moved from ``rm``, ``rv``
    included) and the gradients relative to their scale, as ``TOL`` names
    them, and y's largest bf16 units from the plain version computed from
    the kernels' own statistics (``y_own_units``), the share of y that
    differs from the plain version's (``y_unequal``) and y's largest
    absolute gap from its own statistics' plain version (``y_own_abs``)."""
    rk, vk, rp, vp = rm.clone(), rv.clone(), rm.clone(), rv.clone()
    y, stats = bn_ops._forward_kernels(x, w, b, rk, vk, momentum, eps)
    dx, dw, db = bn_ops._backward_kernels(x, dy, w, b, stats)
    y_p, mean_p, var_p, inv_p = bn_ops.bn_silu_train_plain(x, w, b, rp, vp, momentum, eps)
    dx_p, dw_p, db_p = bn_ops.bn_silu_grad_plain(x, dy, w, b, mean_p, inv_p)
    y_own = bn_ops._apply_plain(x, w, b, stats[0], stats[2])

    def rel(got, want, scale):
        return float(((got.float() - want.float()).abs() / scale.clamp(min=1e-12)).max())

    return {"mean": max(rel(stats[0], mean_p, var_p.sqrt()), rel(rk, rp, rp.abs() + var_p.sqrt())),
            "var": max(rel(stats[1], var_p, var_p), rel(vk, vp, vp), rel(stats[2], inv_p, inv_p)),
            "dweight": rel(dw, dw_p, dw_p.abs().max()), "dbias": rel(db, db_p, db_p.abs().max()),
            "dx": rel(dx, dx_p, dx_p.float().abs().max()),
            "y_own_units": int(bf16_units(y, y_own).max()),
            "y_unequal": float((bf16_units(y, y_p) > 0).float().mean()),
            "y_own_abs": float((y.float() - y_own.float()).abs().max())}


def exceeded(gaps: Dict[str, float]) -> Dict[str, float]:
    """The gaps of ``against_plain`` beyond their limits (empty: held)."""
    over = {k: gaps[k] for k, tol in TOL.items() if gaps[k] > tol}
    if gaps["y_own_units"] > Y_OWN_UNITS:
        over["y_own_units"] = gaps["y_own_units"]
    if gaps["y_unequal"] > Y_UNEQUAL:
        over["y_unequal"] = gaps["y_unequal"]
    return over
