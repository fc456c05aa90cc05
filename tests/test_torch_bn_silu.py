"""The training BatchNorm + SiLU op (``ops/bn_silu.py``) on the CPU: its
plain versions against the plain layers through autograd, the cases that
keep the plain layers, what the kernels take, and the variance taken from
deviations.

The kernels themselves run only on the card: ``tests/test_torch_cuda.py``
holds them to ``bn_silu_train_plain`` and ``bn_silu_grad_plain``.
"""

import contextlib

import pytest
import torch
import torch.nn.functional as F

from object_detection_cib_torch.models import layers
from object_detection_cib_torch.ops import bn_silu as ops

# (N, C, H, W): M = N * H * W rows of 70, 507, 1, 891 and 18; none a
# multiple of a kernel block's rows at these widths
SHAPES = [(2, 8, 5, 7), (3, 16, 13, 13), (1, 24, 1, 1), (9, 32, 9, 11), (2, 64, 3, 3)]
# (rtol, atol) against the plain layers: f64 to rounding; f32 with sums over
# up to 891 rows; bf16: y within one bf16 unit (the CPU's SiLU may round its
# exp otherwise), the statistics f32's; bf16 gradients: see
# ``_dz_rounding_bound``
TOL = {torch.float64: {"y": (1e-12, 1e-12), "stat": (1e-12, 1e-12), "grad": (1e-10, 1e-10)},
       torch.float32: {"y": (1e-5, 1e-6), "stat": (1e-5, 1e-6), "grad": (1e-4, 1e-4)},
       torch.bfloat16: {"y": (8e-3, 8e-3), "stat": (1e-5, 1e-6), "grad": (4e-2, 4e-2)}}


def _layer(C, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    bn = layers.BatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(0.5 + torch.rand(C, generator=g))
        bn.bias.copy_(torch.randn(C, generator=g) * 0.5)
        bn.running_mean.copy_(torch.randn(C, generator=g))
        bn.running_var.copy_(0.5 + torch.rand(C, generator=g))
    return bn.to(torch.float64) if dtype == torch.float64 else bn


def _inputs(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    N, C, H, W = shape
    x = (torch.randn(shape, generator=g) * 2.0 + torch.linspace(-3, 3, C)[:, None, None])
    dy = torch.randn(shape, generator=g)
    cl = torch.channels_last
    return (x.to(dtype).contiguous(memory_format=cl), dy.to(dtype).contiguous(memory_format=cl))


def _plain_layers(bn, x, dy):
    """Today's path: ``F.silu(BatchNorm(x))`` and its autograd backward."""
    x = x.detach().requires_grad_(True)
    y = F.silu(bn(x))
    y.backward(dy)
    return y.detach(), x.grad, bn.weight.grad, bn.bias.grad


def _close(got, want, tol, what):
    rtol, atol = tol
    torch.testing.assert_close(got.double(), want.double(), rtol=rtol, atol=atol, msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_versions_equal_the_plain_layers(shape, dtype):
    """``bn_silu_train_plain`` and ``bn_silu_grad_plain`` against the plain
    layers through autograd: y, the batch statistics, both running
    statistics after the step, and dx, dweight, dbias."""
    N, C, H, W = shape
    x, dy = _inputs(shape, dtype, seed=C + H)
    ref = _layer(C, dtype, seed=C)
    mine = _layer(C, dtype, seed=C)
    y_ref, dx_ref, dw_ref, db_ref = _plain_layers(ref, x, dy)
    tol = TOL[dtype]
    with torch.no_grad():
        y, mean, var, invstd = ops.bn_silu_train_plain(x, mine.weight, mine.bias, mine.running_mean,
                                                       mine.running_var, mine.momentum, mine.eps)
        dx, dw, db = ops.bn_silu_grad_plain(x, dy, mine.weight, mine.bias, mean, invstd)
    ct = torch.promote_types(dtype, torch.float32)
    var_ref, mean_ref = torch.var_mean(x.to(ct), dim=(0, 2, 3), unbiased=False)
    assert y.dtype == dtype and dx.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last)
    _close(y, y_ref, tol["y"], "y")
    _close(mean, mean_ref, tol["stat"], "mean")
    _close(var, var_ref, tol["stat"], "var")
    _close(invstd, torch.rsqrt(var_ref + mine.eps), tol["stat"], "invstd")
    _close(mine.running_mean, ref.running_mean, tol["stat"], "running_mean")
    _close(mine.running_var, ref.running_var, tol["stat"], "running_var")
    scale = dx_ref.double().abs().max().clamp(min=1.0)
    _close(dx / scale, dx_ref / scale, tol["grad"], "dx")
    if dtype == torch.bfloat16:
        bound_w, bound_b = _dz_rounding_bound(x, dy, mean, invstd)
        assert ((dw - dw_ref).double().abs() <= bound_w).all(), (dw - dw_ref, bound_w)
        assert ((db - db_ref).double().abs() <= bound_b).all(), (db - db_ref, bound_b)
    else:
        _close(dw, dw_ref, tol["grad"], "dweight")
        _close(db, db_ref, tol["grad"], "dbias")


def _dz_rounding_bound(x, dy, mean, invstd):
    """How far the weight's and bias's gradients may lie from the plain
    layers' in bf16: those round each dz = dy * silu'(z) to bf16 (at most
    2^-9 of it; |silu'| < 1.1) before summing dz * x_hat and dz, where this
    op sums dz in f32; twice that bound, plus f32's share."""
    x_hat = (x.double() - mean.double()[:, None, None]) * invstd.double()[:, None, None]
    dz = 1.1 * dy.double().abs()
    return (2 * 2**-9 * (dz * x_hat.abs()).sum((0, 2, 3)) + 1e-4,
            2 * 2**-9 * dz.sum((0, 2, 3)) + 1e-4)


def _conv_layer(cin, cout, dtype):
    torch.manual_seed(0)
    m = layers.ConvBnAct(cin, cout, 3).to(memory_format=torch.channels_last)
    return m.to(torch.float64) if dtype == torch.float64 else m


@pytest.fixture
def recorded(monkeypatch):
    """``bn_silu_train`` recording its calls (and computing the plain
    versions) in ``ConvBnAct``'s dispatch."""
    calls = []

    def train(x, weight, bias, running_mean, running_var, momentum, eps):
        calls.append(tuple(x.shape))
        return ops.bn_silu_train_plain(x, weight, bias, running_mean, running_var, momentum, eps)[0]

    monkeypatch.setattr(ops, "bn_silu_train", train)
    return calls


@contextlib.contextmanager
def _on_a_card(monkeypatch):
    """A context in which every tensor reads as a card's (``is_cuda``)."""
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        yield


def _run(m, x, grad=True):
    with torch.set_grad_enabled(grad):
        return m(x)


def test_real_takes_refuses_every_cpu_tensor():
    x = torch.zeros(2, 16, 4, 4, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)
    assert not ops.takes(x)
    before = ops.bn_silu_train.launches
    m = _conv_layer(16, 16, torch.bfloat16)
    m.train()
    _run(m, x.requires_grad_(True)).float().sum().backward()
    assert ops.bn_silu_train.launches == before


@pytest.mark.parametrize("case", ["fused", "cpu", "f32", "f64", "group", "remat", "eval", "no_grad"])
def test_dispatch_keeps_the_plain_layers_where_the_op_does_not_apply(recorded, monkeypatch, case):
    """A training forward with grad of a bf16 conv output on the card, with
    no group and no remat, takes the op (which raises where its kernels
    cannot read the output); on the CPU, in f32 or f64, under a process
    group or a remat policy, in eval mode and without grad the plain layers
    run."""
    dtype = {"f32": torch.float32, "f64": torch.float64}.get(case, torch.bfloat16)
    m = _conv_layer(8, 16, dtype)  # f32 parameters under a bf16 activation, as the network keeps them
    x = torch.randn(2, 8, 6, 6, dtype=torch.float64 if dtype == torch.float64 else torch.float32).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    if case == "group":
        layers.sync_batchnorm(m, object())  # a stand-in group: the plain layers would need a real one
        m.bn.forward = lambda t: t.float()  # stand-in for the global statistics
    if case == "remat":
        layers.set_remat(m, layers.Remat())
    m.train(case != "eval")
    if case == "cpu":
        y = _run(m, x)
    else:
        with _on_a_card(monkeypatch):
            y = _run(m, x, grad=case != "no_grad")
    assert y.shape == (2, 16, 6, 6)
    assert recorded == ([(2, 16, 6, 6)] if case == "fused" else [])


def _conv_output(case):
    """A conv output and BatchNorm parameters for ``takes``, as ``case`` makes them."""
    C = 12 if case == "channels_8x_not" else 16
    N, H, W = (0, 3, 5) if case == "empty" else (2, 3, 5)
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    x = torch.zeros(N, C, H, W, dtype=dtype)
    if case == "unaligned":  # one element past a 16-byte boundary
        x = torch.zeros(1 + x.numel(), dtype=dtype)[1:].view(N, H, W, C).permute(0, 3, 1, 2)
    elif case != "nchw":
        x = x.contiguous(memory_format=torch.channels_last)
    p_dtype = torch.bfloat16 if case == "bf16_parameters" else torch.float32
    params = [torch.ones(C + (1 if case == "parameter_shape" else 0), dtype=p_dtype) for _ in range(4)]
    return x, params


@pytest.mark.parametrize("case", ["reads", "channels_8x_not", "nchw", "f32", "bf16_parameters", "unaligned",
                                  "empty", "parameter_shape"])
def test_takes_only_what_the_kernels_read(monkeypatch, case):
    """On a card (``is_cuda`` as there), ``takes`` holds for a non-empty
    bf16 channels_last 16-byte aligned conv output with C % 8 == 0 and (C,)
    f32 parameters, and for nothing else: there the op raises."""
    x, params = _conv_output(case)
    with _on_a_card(monkeypatch):
        assert ops.takes(x, *params) == (case == "reads")


def test_variance_comes_from_deviations_at_a_large_mean():
    """x = 1000 + noise (std 8) in f32 over 2 x 64 x 64 rows: the biased
    variance within 1e-5 of the f64 one; E[x^2] - E[x]^2 in f32 misses by
    far more, so the check would catch it."""
    g = torch.Generator().manual_seed(0)
    x = (1000.0 + 8.0 * torch.randn(2, 8, 64, 64, generator=g)).contiguous(memory_format=torch.channels_last)
    bn = _layer(8, torch.float32, seed=0)
    _, mean, var, _ = ops.bn_silu_train_plain(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, 0.03, 1e-3)
    v64 = x.double().var(dim=(0, 2, 3), unbiased=False)
    assert ((var.double() - v64).abs() / v64).max() < 1e-5
    naive = (x * x).mean((0, 2, 3)) - x.mean((0, 2, 3)) ** 2
    assert ((naive.double() - v64).abs() / v64).max() > 1e-3
    assert torch.allclose(mean.double(), x.double().mean((0, 2, 3)), rtol=1e-6)


def test_wrapper_refuses_what_it_cannot_take():
    x = torch.zeros(2, 16, 3, 3)
    p = torch.ones(16)
    with pytest.raises(ValueError, match="parameters"):
        ops.bn_silu_train(x, torch.ones(8), p, p, p, 0.03, 1e-3)
    with pytest.raises(ValueError, match=r"\(N, C, H, W\)"):
        ops.bn_silu_train(x[0], p, p, p, p, 0.03, 1e-3)
    with pytest.raises(ValueError, match="on a card"):
        ops.bn_silu_train(x, p, p, p, p, 0.03, 1e-3)


@pytest.mark.parametrize("shape,strides,ld", [
    ((2, 16, 3, 5), None, 16),  # channels_last contiguous
    ((2, 16, 3, 5), (3 * 5 * 24, 1, 5 * 24, 24), 24),  # 16 channels of rows of 24 (a slice of a concat)
    ((2, 16, 3, 5), (3 * 5 * 20, 1, 5 * 20, 20), None),  # rows of 20: not 16-byte rows
    ((2, 16, 3, 5), (16 * 15, 15, 5, 1), None),  # NCHW
])
def test_row_stride_of_a_gradient(shape, strides, ld):
    """The backward reads dy as rows of contiguous channels at any row
    stride that keeps 16-byte vectors (a channel slice of a channels_last
    concat's gradient); other layouts are copied first."""
    N, C, H, W = shape
    if strides is None:
        t = torch.zeros(shape, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)
    else:
        t = torch.empty_strided(shape, strides, dtype=torch.bfloat16)
    assert ops._row_stride(t) == ld
