"""The benchmark's arithmetic on canned numbers and a canned trace."""

import statistics

import pytest

from conftest import ROOT  # noqa: F401
from vbench import arith
from vbench.trace import Trace


def test_union_and_gaps():
    iv = [(5, 7), (0, 2), (1, 3), (6, 9), (12, 13)]
    assert arith.merged(iv) == [(0, 3), (5, 9), (12, 13)]
    assert arith.union_length(iv) == 3 + 4 + 1
    assert arith.gaps(iv, -1, 15) == [(-1, 0), (3, 5), (9, 12), (13, 15)]
    assert arith.gaps(iv, 1, 8) == [(3, 5)]
    assert arith.gaps([], 0, 4) == [(0, 4)]


def test_p95_and_spread():
    v = list(range(1, 201))
    assert arith.p95(v) == statistics.quantiles(v, n=20)[18]
    assert 190 < arith.p95(v) < 192
    assert arith.spread([10, 10, 10, 10]) == 0.0
    q1, q2, q3 = statistics.quantiles([1, 2, 3, 4, 5, 6], n=4)
    assert arith.spread([1, 2, 3, 4, 5, 6]) == pytest.approx((q3 - q1) / q2)


def test_knn_work_and_bound():
    ops, nbytes = arith.knn_work(768, 7680, 8, 700, 6000)
    assert ops == 9 * 700 * 6000
    assert nbytes == 12 * (768 + 7680) + 7680 + 12 * 768 * 8
    assert arith.bound_s(ops, nbytes) == max(ops / 67e12, nbytes / 3.35e12)
    assert arith.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_trace_reading():
    ms = 1_000_000
    tr = Trace(device_ops=[("k_a", 0, 2 * ms), ("k_b", 1 * ms, 3 * ms), ("k_a", 6 * ms, 7 * ms),
                           ("copy", 9 * ms, 10 * ms)],
               ranges=[("host_grid", 3 * ms, 5 * ms), ("vloam_step", 2 * ms, 6 * ms),
                       ("host_grid", 7 * ms, 9 * ms)],
               span_ns=(0, 12 * ms))
    assert tr.window_s() == pytest.approx(0.012)
    assert tr.busy_s() == pytest.approx(0.005)
    assert tr.top_ops() == [["k_a", pytest.approx(0.003)], ["k_b", pytest.approx(0.002)],
                            ["copy", pytest.approx(0.001)]]
    gaps = tr.idle_gaps()
    assert gaps[0] == ["host_grid+vloam_step", pytest.approx(0.003)]
    assert gaps[1] == ["host_grid", pytest.approx(0.002)]
    assert gaps[2] == ["none", pytest.approx(0.002)]
