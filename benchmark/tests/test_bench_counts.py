"""The yardstick's counts: model FLOPs, parameters and kernel byte bounds."""

import pytest

from counts.bytes import bound_ms, gather_rows, greedy_nms, hsv_planar, warp_quadrants
from counts.flops import TRAIN_FACTOR, conv_flops, parameters

S_, L_ = (0.33, 0.50), (1.0, 1.0)


@pytest.mark.parametrize("nc,factors,size,gflops", [
    (80, S_, 640, 16.434), (80, L_, 640, 108.994), (10, S_, 416, 6.689), (10, L_, 416, 45.541),
    (10, S_, 640, 15.831),
])
def test_conv_flops_of_one_image(nc, factors, size, gflops):
    assert conv_flops(nc, *factors, size) / 1e9 == pytest.approx(gflops, abs=5e-4)


@pytest.mark.parametrize("factors,published", [(S_, 16.5), (L_, 109.1)])
def test_flops_within_a_percent_of_ultralytics(factors, published):
    assert abs(conv_flops(80, *factors, 640) / 1e9 / published - 1) < 0.01


@pytest.mark.parametrize("nc,factors,count", [(80, S_, 7_235_389), (80, L_, 46_563_709), (10, S_, 7_046_599),
                                              (10, L_, 46_186_759)])
def test_parameters(nc, factors, count):
    assert parameters(nc, *factors) == count


def test_train_step_counts_three_forwards():
    assert TRAIN_FACTOR == 3


def test_kernel_bounds():
    assert bound_ms(gather_rows(256, 519_168)) == pytest.approx(0.079347, abs=1e-6)
    assert bound_ms(hsv_planar(64, 416)) == pytest.approx(0.039674, abs=1e-6)


def test_warp_and_nms_bounds_as_the_kernel_table_counts_them():
    assert bound_ms(warp_quadrants(36_376_860, 64, 416)) == pytest.approx(0.031459, abs=1e-6)
    assert bound_ms(greedy_nms(32, 2048)) == pytest.approx(0.000352, abs=1e-6)
