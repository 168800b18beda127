"""The window's arithmetic, the trace's reduction and the roofline counts."""

import math
import re
import statistics

import pytest

from benchmark import harness, roofline
from benchmark.devtrace import Event, Trace, short_name


def test_rate_and_idle_share():
    assert harness.rate(30, 10.0) == 3.0
    assert harness.idle_share(7.5, 10.0) == pytest.approx(25.0)
    with pytest.raises(ValueError):
        harness.rate(1, 0.0)


def test_percentile_interpolates_between_the_nearest_values():
    values = [float(v) for v in range(1, 101)]
    assert harness.percentile(values, 95) == pytest.approx(95.05)
    assert harness.percentile(values[::-1], 50) == pytest.approx(50.5)
    assert harness.percentile([4.0], 95) == 4.0


def test_spread_is_the_quartile_distance_over_the_median():
    values = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert harness.spread(values) == pytest.approx((q3 - q1) / med)


def _trace():
    device = [Event("void pad_points_kernel(float const*)", 0, 1),
              Event("void split_v_kernel(float const*)", 1, 2),
              Event("void (anonymous namespace)::sym_matvec_kernel<0, 2, 4>(float const*)", 2, 6),
              Event("void (anonymous namespace)::matvec_kernel<0, 9, 4>(float const*)", 8, 9),
              Event("at::native::elementwise_kernel<...>", 5, 7)]
    host = [Event("window", 0, 12), Event("fwd", 0, 10), Event("aten::item", 7.5, 8.5)]
    return Trace((0.0, 12.0), device, host)


def test_busy_time_is_the_union_of_device_intervals():
    t = _trace()
    assert t.busy_intervals() == [(0, 7), (8, 9)]
    assert t.busy_s == pytest.approx(8e-6)
    assert t.window_s == pytest.approx(12e-6)
    assert t.idle_gaps() == [(7, 8), (9, 12)]


def test_idle_gaps_are_labelled_by_the_host():
    labels = dict(_trace().idle_by_host())
    assert labels["fwd/aten::item"] == pytest.approx(1e-6)
    assert labels["window"] == pytest.approx(3e-6)


def test_kernel_seconds_take_the_prepass_enqueued_before_each_launch():
    t = _trace()
    assert t.kernel_seconds(re.compile(r"\bsym_matvec_kernel\b")) == pytest.approx(6e-6)
    assert t.kernel_seconds(re.compile(r"(?<![A-Za-z_])matvec_kernel\b")) == pytest.approx(1e-6)
    assert short_name(t.device[2].name) == "sym_matvec_kernel<0, 2, 4>"


def test_roofline_counts_from_shapes():
    # K3 at n = 1e5, d = 3, t = 11: the formation of the n(n+1)/2 entries
    # in f32 bounds it (0.746 ms) ahead of the three bf16 passes (0.667 ms)
    n, d, t = 100_000, 3, 11
    entries = n * (n + 1) / 2
    assert roofline.k3_least_seconds(n, d, t) == pytest.approx(entries * (3 * d + 1) / 67e12)
    assert roofline.k3_least_seconds(n, d, t) * 1e3 == pytest.approx(0.7463, rel=1e-3)
    assert 3 * entries * 4 * t / 989e12 * 1e3 == pytest.approx(0.6674, rel=1e-3)
    # K1 for a LOVE query of 1024 points: t = 1 is bound by the formation,
    # t = 100 by the three passes
    assert roofline.k1_least_seconds(1024, n, d, 1) == pytest.approx(1024 * n * (3 * d + 1) / 67e12)
    assert roofline.k1_least_seconds(1024, n, d, 100) == pytest.approx(3 * 1024 * n * 200 / 989e12)
    assert roofline.share_pct(1.0, 4.0) == 25.0
    assert roofline.share_pct(1.0, 0.0) is None


def test_leaf_gaps_take_the_larger_of_the_leaf_and_the_median_leaf():
    ref = {"a": 1.0, "b": 0.01, "c": 0.5}
    prog = {"a": 1.1, "b": 0.02, "c": 0.5}
    # b's gap 0.01 is measured against the median leaf (0.5), not b itself
    assert harness.leaf_gaps(prog, ref) == pytest.approx(0.1)
    assert harness.moved_leaves({"a": 1.0, "b": 1e-5, "c": 0.5}) == {"a", "c"}


def test_a_cell_without_limits_is_never_correct():
    assert not harness.correct([harness.Check("loss", 0.0, None)])
    assert harness.correct([harness.Check("loss", 0.1, 0.2), harness.Check("x", 9.0, None)])
    assert not harness.correct([harness.Check("loss", math.nan, 0.2)])
