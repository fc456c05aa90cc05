"""Port parity: the YOLOv5 network, the flax->torch converter, and decode.

The flax network is initialised by the JAX package, its running statistics
are randomised (so BatchNorm's conversion is exercised), and the variables
go through ``models/convert.py`` into the port. Both run in f32 on the CPU.

Forward tolerance atol 1e-4, rtol 1e-4: the two libraries sum each
convolution in a different order, so every layer differs in the last f32
bits (~1e-7 relative), and ~60 conv/BN layers carry that into head logits of
order 1-10. Decode is compared on identical head tensors at atol 1e-5 plus
rtol 1e-6: sigmoid kernels differ in the last bits, and boxes reach hundreds
of pixels, where one f32 ulp is already 1.5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_cib_torch.core.types import default_anchors as t_anchors
from object_detection_cib_torch.eval.decode import decode_predictions as t_decode
from object_detection_cib_torch.models import layers as tlayers
from object_detection_cib_torch.models.convert import flax_to_torch
from object_detection_cib_torch.models.yolov5 import (
    DetectionHeadResult as THead,
    SIZE_VARIANTS as T_SIZES,
    Yolov5NetworkResult as TResult,
    build_network as t_build,
    make_divisible as t_md,
    make_round as t_mr,
)
from object_detection_cib_tpu.core.types import default_anchors as j_anchors
from object_detection_cib_tpu.eval.decode import decode_predictions as j_decode
from object_detection_cib_tpu.models import layers as jlayers
from object_detection_cib_tpu.models.yolov5 import (
    DetectionHeadResult as JHead,
    SIZE_VARIANTS as J_SIZES,
    Yolov5NetworkResult as JResult,
    build_network as j_build,
    make_divisible as j_md,
    make_round as j_mr,
)

NC, IMG, BATCH = 3, 64, 2
ATOL = RTOL = 1e-4

# PARITY.md §2.3 (n, s at nc=80) and tests/test_models.py (nc=10)
GOLDEN_PARAM_COUNTS = {
    ("n", 80): 1_872_157,
    ("s", 80): 7_235_389,
    ("n", 10): 1_777_447,
    ("s", 10): 7_046_599,
}


@pytest.fixture(scope="module")
def flax_model():
    net = j_build(NC, "n")
    variables = jax.jit(lambda k, x: net.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3))
    )
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(0)

    def randomise(path, v):
        if path[-1].key == "mean":
            return rng.normal(0, 0.2, v.shape).astype(np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        return v

    variables = {
        "params": variables["params"],
        "batch_stats": jax.tree_util.tree_map_with_path(randomise, variables["batch_stats"]),
    }
    images = np.random.default_rng(1).random((BATCH, IMG, IMG, 3), np.float32)
    return net, variables, images


def _port(variables):
    net = t_build(NC, "n", device="cpu")
    net.load_state_dict(flax_to_torch(variables), strict=True)
    return net


def _assert_heads_close(t_out, j_out):
    for tl, jl in zip(t_out.levels(), j_out.levels()):
        assert tuple(tl.raw.shape) == jl.raw.shape
        np.testing.assert_allclose(
            tl.raw.detach().numpy(), np.asarray(jl.raw), atol=ATOL, rtol=RTOL
        )


@pytest.mark.parametrize("size,nc", list(GOLDEN_PARAM_COUNTS))
def test_param_count(size, nc):
    net = t_build(nc, size, device="cpu")
    assert sum(p.numel() for p in net.parameters()) == GOLDEN_PARAM_COUNTS[(size, nc)]


def test_scaling_helpers_match():
    assert T_SIZES == J_SIZES
    for x in (3, 9, 64, 100, 1024):
        for f in (0.25, 0.33, 0.5, 0.67, 1.0):
            assert t_md(x, f) == j_md(x, f)
            assert t_mr(x, f) == j_mr(x, f)


def test_converter_covers_every_leaf(flax_model):
    """flax -> torch -> flax: every flax leaf lands in exactly one torch entry."""
    _, variables, _ = flax_model
    sd = flax_to_torch(variables)
    net = t_build(NC, "n", device="cpu")
    assert set(sd) == set(net.state_dict())
    used = set()
    leaves = jax.tree_util.tree_flatten_with_path(variables)[0]
    for path, v in leaves:
        keys = [p.key for p in path]
        coll, mod, leaf = keys[0], keys[1:-1], keys[-1]
        if leaf == "kernel":
            name, back = ".".join(mod + ["weight"]), sd[".".join(mod + ["weight"])].numpy()
            np.testing.assert_array_equal(back.transpose(2, 3, 1, 0), v)
        elif coll == "batch_stats":
            name = ".".join(mod + [{"mean": "running_mean", "var": "running_var"}[leaf]])
            np.testing.assert_array_equal(sd[name].numpy(), v)
        elif mod[-1] == "bn":
            name = ".".join(mod + [{"scale": "weight", "bias": "bias"}[leaf]])
            np.testing.assert_array_equal(sd[name].numpy(), v)
        else:  # head part: slice it back out of the concatenated conv
            part, kind = leaf.split("_")
            head = variables["params"][mod[0]]
            sizes = [head[f"{p}_bias"].shape[0] for p in ("box", "obj", "cls")]
            lo = sum(sizes[: ("box", "obj", "cls").index(part)])
            full = sd[".".join(mod + ["conv", "weight" if kind == "kernel" else "bias"])].numpy()
            if kind == "kernel":
                back = full[lo : lo + v.shape[-1]].transpose(2, 3, 1, 0)
            else:
                back = full[lo : lo + v.shape[0]]
            np.testing.assert_array_equal(back, v)
            name = (".".join(mod), leaf)
        assert name not in used
        used.add(name)
    assert len(used) == len(leaves)


def test_eval_forward_matches_flax(flax_model):
    jnet, variables, images = flax_model
    want = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(variables, images)
    net = _port(variables).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(images))
    _assert_heads_close(got, want)


def test_train_forward_and_running_stats_match_flax(flax_model):
    jnet, variables, images = flax_model
    want, mutated = jax.jit(
        lambda v, x: jnet.apply(v, x, train=True, mutable=["batch_stats"])
    )(variables, images)
    net = _port(variables).train()
    with torch.no_grad():
        got = net(torch.from_numpy(images))
    _assert_heads_close(got, want)
    # running stats move with flax's momentum and its BIASED batch variance
    sd = net.state_dict()
    new_stats = flax_to_torch({"params": variables["params"], "batch_stats": mutated["batch_stats"]})
    for k, v in new_stats.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-4, err_msg=k)


def test_bf16_forward_close_to_f32(flax_model):
    """dtype=bf16: params stay f32, heads come out bf16, values near the f32 run.

    A check of the dtype plumbing, not a parity bound: bf16 keeps 8 mantissa
    bits (~0.4% per rounding) and ~60 layers compound it, so the bound is a
    quarter of the head's largest magnitude.
    """
    _, variables, images = flax_model
    net = _port(variables).eval()
    x = torch.from_numpy(images)
    with torch.no_grad():
        ref = net(x)
        net.dtype = torch.bfloat16
        got = net(x)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    for g, r in zip(got.levels(), ref.levels()):
        assert g.raw.dtype == torch.bfloat16
        err = (g.raw.float() - r.raw).abs().max().item()
        assert err < 0.25 * max(1.0, r.raw.abs().max().item()), err


def test_maxpool_and_upsample_match_jax():
    x = np.random.default_rng(2).normal(size=(2, 7, 5, 3)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for k in (3, 5):
        want = np.asarray(jlayers._maxpool_same(jnp.asarray(x), k))
        got = tlayers._maxpool_same(xt, k).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jlayers.upsample_nearest_2x(jnp.asarray(x)))
    got = tlayers.upsample_nearest_2x(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_decode_matches_jax():
    rng = np.random.default_rng(3)
    A = 3
    raws = [rng.normal(0, 2, (BATCH, s, s, A * (5 + NC))).astype(np.float32) for s in (8, 4, 2)]
    want = np.asarray(
        j_decode(JResult(*(JHead(jnp.asarray(r), A, NC) for r in raws)), j_anchors())
    )
    got = t_decode(TResult(*(THead(torch.from_numpy(r), A, NC) for r in raws)), t_anchors())
    assert tuple(got.shape) == want.shape == (BATCH, 3 * (64 + 16 + 4), 5 + NC)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)
