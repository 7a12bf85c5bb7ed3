"""B1's bytes and operations as the benchmark counts them."""

import pytest

from hydrobench import roofline
from hydrobench.reference import mc


def test_b1_bytes_count_each_array_once():
    # 13 inputs and the 3 outputs of the timed path, float32, per lane
    assert roofline.b1_bytes(1) == 64
    assert roofline.b1_bytes(2_729_077) == 2_729_077 * 64
    assert roofline.b1_bytes(10, outputs=6) == 10 * 19 * 4


def test_operation_counts_follow_the_frozen_arithmetic():
    ev, lane = roofline.evaluation_ops(), roofline.lane_ops()
    # two residual calls and the secant update; a repeatable count
    assert ev == roofline.evaluation_ops() == 153
    assert lane == 39
    # an overbank evaluation adds the floodplain celerity: the in-bank
    # count is the floor
    assert roofline.overbank_ops() > ev
    assert roofline.b1_ops(10, 4) == 10 * ev + 4 * lane


def test_counted_numbers_count_arithmetic_only():
    C, c = roofline.Counted, roofline._Counter
    c.ops = 0
    x = C(2.0)
    y = (x + 1.0) * x / 3.0 - x ** 0.5
    y = abs(-y)
    _ = max(x, 1.0), x > 1.0
    assert c.ops == 5 and isinstance(y, C)
    assert y.v == pytest.approx(((2.0 + 1.0) * 2.0 / 3.0) - 2.0 ** 0.5)
    c.ops = 0
    mc._sqrt(x)
    assert c.ops == 1


def test_least_time_takes_the_larger_bound():
    peak = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    t, which = roofline.least_time_s(67e9, 1.0, peak)
    assert which == "ops" and t == pytest.approx(1e-3)
    t, which = roofline.least_time_s(1.0, 3.35e9, peak)
    assert which == "bytes" and t == pytest.approx(1e-3)
    # the CONUS warm step: about 3 evaluations a lane, bound by bytes
    n = 2_729_077
    t, which = roofline.least_time_s(roofline.b1_ops(3 * n, n),
                                     roofline.b1_bytes(n), peak)
    assert which == "bytes" and t == pytest.approx(52.1e-6, rel=1e-2)
