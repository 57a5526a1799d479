"""The window's arithmetic and the roofline's counts on numbers worked out
by hand."""
import numpy as np
import pytest

from wfbench import harness, roofline
from wfbench.spec import Geometry, config_fields


def test_p95_is_the_inclusive_95th_percentile():
    times = [i / 1000.0 for i in range(1, 101)]         # 1 .. 100 ms
    # inclusive quantiles: 1 + 0.95 * 99 = 95.05 -> 95.05 ms
    assert harness.percentile(times, 95) == pytest.approx(0.09505)
    assert harness.percentile([0.2], 95) == 0.2
    shuffled = list(reversed(times))
    assert harness.percentile(shuffled, 95) == harness.percentile(times, 95)
    # one slow call in twenty moves the tail, not the median
    calls = [0.010] * 19 + [0.050]
    assert harness.percentile(calls, 95) == pytest.approx(0.010 + 0.05 * 0.040)
    assert harness.percentile(calls, 50) == pytest.approx(0.010)


def test_rate_is_all_the_work_over_the_whole_window():
    # 3 calls of 64 x 1080 blocks from t = 10.0 to t = 10.5
    assert harness.rate(3 * 64 * 1080, 10.0, 10.5) == pytest.approx(414720.0)


def test_sample_is_drawn_from_the_seed_and_keeps_the_extra():
    a = harness.sample(2 ** 31 + 3, 16, 3)
    assert a == harness.sample(2 ** 31 + 3, 16, 3) and len(set(a)) == 3
    b = harness.sample(5, 16, 3, extra=15)
    assert 15 in b and len(b) in (3, 4)
    assert harness.sample(5, 2, 3) == [0, 1]


G = Geometry(config_fields("nps_rg1a_fp32"))


def test_system_and_solve_ops_at_one_pulse():
    # M = 3, packed triangle 6: K (25 + 12 + 6 + 5) + 15 + 5 a bin
    assert roofline.system_ops(90, 1) == 90 * 48 + 20
    assert roofline.solve_ops(1) == 27 + 36 + 30


def test_lm_bound_counts_each_lane_at_its_pulses_and_the_table_once():
    npulse = np.array([1, 1, 2])
    n_iter = np.array([3, 0, 5])
    b = roofline.lm_bound(G, npulse, n_iter, "float32")
    ops = (4 * roofline.system_ops(90, 1) + 3 * roofline.solve_ops(1)
           + 1 * roofline.system_ops(90, 1)
           + 6 * roofline.system_ops(90, 2) + 5 * roofline.solve_ops(2))
    assert b["operations"] == ops
    vals = 2 * (90 + 4 * 3 + 3) + (90 + 4 * 5 + 3)
    assert b["bytes"] == 4 * vals + 4 * 1080 * 4 * 128
    assert b["seconds"] == max(b["bytes"] / 3.35e12, ops / 67e12)
    b64 = roofline.lm_bound(G, npulse, n_iter, "float64")
    assert b64["bytes"] == 2 * b["bytes"]
    assert b64["seconds"] == max(b64["bytes"] / 3.35e12, ops / 34e12)


def test_search_bound_at_the_default_sigma():
    # sigma 2: shift 14, frame 138 bins; int(1000 exp(-(i - 6)^2 / 8)) is
    # nonzero to bin 13 (lh_gold 14): 12*3 + 4 + 6 + 28 + 3 (2*27 + 4) + 15
    # = 263 a bin
    assert roofline.search_ops_per_lane(G, 110) == 138 * 263
    b = roofline.search_bound(G, 10, "float32")
    assert b["operations"] == 10 * 138 * 263
    assert b["bytes"] == 10 * (220 + 48) * 4
    assert b["by"] == "operations"
