"""The roofline counts' arithmetic."""

import pytest

import pb_tiny  # noqa: F401
from portbench import roofline


def test_vec_dist_work():
    nbytes, flops = roofline.vec_dist_work(ndis=1000, launches=3, q_rows=8,
                                           d=96, row_bytes=96)
    assert nbytes == 1000 * 96 + 3 * 8 * (96 * 4 + 4)
    assert flops == 1000 * 2 * 96


def test_bound_takes_the_larger_side():
    assert roofline.bound_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_seconds(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_seconds(3.35e12, 134e12) == pytest.approx(2.0)


def test_share_percent():
    assert roofline.share_percent(3.35e9, 0, 0.004) == pytest.approx(25.0)
    assert roofline.share_percent(0, 0, 1.0) is None
    assert roofline.share_percent(1.0, 0, 0.0) is None


def test_k3_share_from_a_searchs_counts():
    """A search's K3 at PERF.md's sq8 numbers (8,192 queries, ~73 launches,
    ~2.9 ms) stays well under 100%: bytes bound it."""
    ndis = 8192 * 2000
    nbytes, flops = roofline.vec_dist_work(ndis, 73, 8192, 96, 96)
    assert nbytes / roofline.HBM_BYTES_PER_S > flops / roofline.F32_FLOPS
    assert 5 < roofline.share_percent(nbytes, flops, 2.9e-3) < 50
