"""The yardstick's counts, through each configuration's network family:
model FLOPs, parameters, BatchNorm bytes and the seed's weights equal the
values pinned before the family modules existed; and kernel byte bounds."""

import hashlib

import pytest
import torch

from counts.bn_silu import BYTES_PER_ELEMENT
from counts.bytes import bound_ms, gather_rows, greedy_nms, hsv_planar, warp_quadrants
from counts.flops import TRAIN_FACTOR
from harness import registry

SEED = 2**31 + 17


def _cfg(name, nc=10):
    cfg = registry.config(name)
    return dict(cfg, nc=nc), registry.family(cfg)


@pytest.mark.parametrize("nc,config,size,gflops", [
    (80, "yolov5s", 640, 16.434), (80, "yolov5l", 640, 108.994), (10, "yolov5s", 416, 6.689),
    (10, "yolov5l", 416, 45.541), (10, "yolov5s", 640, 15.831),
])
def test_conv_flops_of_one_image(nc, config, size, gflops):
    cfg, fam = _cfg(config, nc)
    assert fam.conv_flops(cfg, size) / 1e9 == pytest.approx(gflops, abs=5e-4)


@pytest.mark.parametrize("config,published", [("yolov5s", 16.5), ("yolov5l", 109.1)])
def test_flops_within_a_percent_of_ultralytics(config, published):
    cfg, fam = _cfg(config, 80)
    assert abs(fam.conv_flops(cfg, 640) / 1e9 / published - 1) < 0.01


@pytest.mark.parametrize("nc,config,count", [(80, "yolov5s", 7_235_389), (80, "yolov5l", 46_563_709),
                                             (10, "yolov5s", 7_046_599), (10, "yolov5l", 46_186_759)])
def test_parameters(nc, config, count):
    cfg, fam = _cfg(config, nc)
    assert fam.parameters(cfg) == count


@pytest.mark.parametrize("config,elements,layers", [("yolov5s", 9_993_984, 57), ("yolov5l", 31_063_552, 101)])
def test_batchnorm_bytes_of_one_image_at_416(config, elements, layers):
    cfg, fam = _cfg(config)
    assert fam.bn_elements(cfg, 416) == (elements, layers) and BYTES_PER_ELEMENT == 10


@pytest.mark.parametrize("config,leaves,digest", [
    ("yolov5s", 291, "1063312c3d806eecba28a6fbca4264f28523f8498dd36f672bf21b69de59c748"),
    ("yolov5l", 511, "eea80d850cfc03a9857be83a2b9583ca7bf88324b54960a4e8efd5f54d912d1c"),
])
def test_the_seeds_weights_are_drawn_as_before(config, leaves, digest):
    """Every leaf, in order, bit for bit: the same generator stream, order
    and values as the weights drawn before the family modules."""
    cfg, fam = _cfg(config)
    state = fam.weights(SEED, cfg, torch.device("cpu"))
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    assert (len(state), h.hexdigest()) == (leaves, digest)


def test_train_step_counts_three_forwards():
    assert TRAIN_FACTOR == 3


def test_kernel_bounds():
    assert bound_ms(gather_rows(256, 519_168)) == pytest.approx(0.079347, abs=1e-6)
    assert bound_ms(hsv_planar(64, 416)) == pytest.approx(0.039674, abs=1e-6)


def test_warp_and_nms_bounds_as_the_kernel_table_counts_them():
    assert bound_ms(warp_quadrants(36_376_860, 64, 416)) == pytest.approx(0.031459, abs=1e-6)
    assert bound_ms(greedy_nms(32, 2048)) == pytest.approx(0.000352, abs=1e-6)
