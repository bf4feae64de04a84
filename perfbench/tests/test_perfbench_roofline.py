"""Operations and bytes of the roofline against counts by hand."""

import pytest

from perfbench import roofline
from perfbench.models import pulses


def test_least_time_is_the_larger_bound():
    assert roofline.least_s(67e12, 0) == pytest.approx(1.0)
    assert roofline.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_s(67e12, 6.7e12) == pytest.approx(2.0)


def test_distinct_picks():
    assert roofline.distinct_picks(1, 4) == pytest.approx(1.0)
    assert roofline.distinct_picks(2, 2) == pytest.approx(1.5)
    assert roofline.distinct_picks(0, 4) == 0.0


def test_stretch_counts_by_hand():
    """nt = 1, nw = 4, D = 2, float32: halves of 2 walkers.  Propose half 0:
    2 moving rows and 1.5 distinct picked rows of 2 coordinates, 3 values
    a walker, q and the factor (3 a walker), perm 4 int64; 2 walkers x 15
    ops.  Accept half 1: per walker D + 6 read, D + 3 written, the ladder,
    2 int64; 2 x 12 ops."""
    c = roofline.stretch(1, 4, 2)
    assert c["stretch_propose"] == (2 * 15, (3.5 * 2 + 6 + 6) * 4 + 32)
    assert c["stretch_accept"] == (2 * 12, (2 * 8 + 1 + 2 * 5) * 4 + 16)
    accept0 = (2 * 8 + 1 + 2 * 5) * 4 + 16
    propose1 = (2 * 2 + 6 + 6) * 4 + 32
    assert c["stretch_accept_propose"] == (2 * 12 + 2 * 15, accept0 + propose1)


def test_cascade_counts_by_hand():
    """nt = 2, nw = 4, one float32 leaf of 4 bytes a walker: the
    log-likelihood and the leaf read and written (2 x 8 x 8), pi (32), one
    shift (4), the draws (16), the ladder (8) and one count (4); one rung
    of 4 walkers x 3 ops."""
    assert roofline.cascade(2, 4, 4) == (12, 128 + 32 + 4 + 16 + 8 + 4)


def test_group_stretch_counts_by_hand():
    """nt = 1, nw = 4, 1 leaf of 1 coordinate, every leaf active: 2 moving
    leaves, 1.5 distinct picks; u and the factors (16), masks (4), uu (8),
    rows read and written and picked (2 x 2 + 1.5) x 4; per leaf 4 + 2 + 1
    + 3 ops, per walker 3."""
    ops, nbytes = roofline.group_stretch(1, 4, 1, 1, 1.0)
    assert ops == 2 * 10 + 2 * 3
    assert nbytes == pytest.approx(16 + 4 + 8 + 5.5 * 4)


def test_likelihood_costs_by_hand():
    cfg = {"ndim": 3, "nleaves_max": 2}
    ops, nbytes = pulses.likelihood_cost(cfg, {"npts": 10}, 5)
    assert ops == 5 * (2 * 10 * 6 + 10 * 4 + 2 * 2)
    assert nbytes == 5 * (2 * 3 * 4 + 2 + 4) + 2 * 10 * 4
