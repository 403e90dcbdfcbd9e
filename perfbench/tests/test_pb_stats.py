"""Whole-window arithmetic: tails over every request, and a stall
anywhere in the window moves them."""
import numpy as np
import pytest

from harness import stats


def test_percentile_is_numpys_linear():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 1001):
        v = rng.exponential(size=n).tolist()
        for q in (50, 90, 95, 99):
            assert stats.percentile(v, q) == pytest.approx(np.percentile(v, q), rel=1e-12)


def test_unserved_request_counts_its_age():
    due = [0.0, 1.0, 2.0, 9.5, 11.0]
    first = [0.2, 1.2, None, 9.6, None]
    s = stats.ttft_samples(due, first, end=10.0)
    assert s == pytest.approx([0.2, 0.2, 8.0, 0.1])      # due past the close: not counted


def test_stall_moves_ttft_tail():
    due = [i * 0.1 for i in range(100)]
    calm = [d + 0.05 for d in due]
    stalled = [d + (0.05 if not 40 <= i < 50 else 1.5) for i, d in enumerate(due)]
    p_calm = stats.percentile(stats.ttft_samples(due, calm, 20.0), 95)
    p_stall = stats.percentile(stats.ttft_samples(due, stalled, 20.0), 95)
    assert p_stall > 10 * p_calm


def test_stall_moves_itl_tail_also_open_at_close():
    times = [[i * 0.05 for i in range(40)] for _ in range(10)]
    calm = stats.percentile(stats.itl_samples(times, [True] * 10, 5.0), 95)
    stalled = [list(t) for t in times]
    for t in stalled:              # three stalls a request: 3 of its 39 gaps
        for k in (10, 20, 30):
            t[k:] = [x + 1.0 for x in t[k:]]
    assert stats.percentile(stats.itl_samples(stalled, [True] * 10, 5.0), 95) > 10 * calm
    # A request stuck when the window closes gives its open gap.
    stuck = [[0.0, 0.05, 0.1]]
    assert stats.itl_samples(stuck, [False], 3.0) == pytest.approx([0.05, 0.05, 2.9])


def test_rate_counts_all_work_over_all_time():
    assert stats.rate(16384 * 10, 40.0) == 4096.0


def test_spread_is_iqr_over_median():
    v = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, q2, q3 = __import__("statistics").quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)
