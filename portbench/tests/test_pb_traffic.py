"""The traffic generator: every mix file loads and finds its runner by
its kind, and each seed gets the same amount of work in its own order."""

import json

import numpy as np
import pytest

import pb_tiny
from portbench import traffic


@pytest.mark.parametrize("name", sorted(
    {w["traffic"] for w in pb_tiny.MAN["workloads"]}))
def test_mix_file_loads(name):
    spec = traffic.load(name)
    drv = traffic.runner(spec["kind"])
    for fn in ("drive", "control"):
        assert callable(getattr(drv, fn))
    assert drv.FAULTS and drv.CONTROL_FAILS
    for key in drv.TINY:                 # the tiny run cuts what is there
        assert spec[key] > 0, key
    if hasattr(drv, "pool_rows"):
        assert drv.pool_rows(spec) > 0


def test_unknown_kind_refused(tmp_path, monkeypatch):
    (tmp_path / "odd.json").write_text(json.dumps({"kind": "no_such"}))
    monkeypatch.setattr(traffic, "DIR", tmp_path)
    with pytest.raises(ValueError):
        traffic.load("odd")
    with pytest.raises(ValueError):
        traffic.runner("../cells")


def test_batch_order_cycles_a_permutation():
    p = traffic.load("batch8k")["pool_batches"]
    o = traffic.batch_order(p, pb_tiny.SEED, 3 * p)
    assert sorted(o[:p]) == list(range(p))
    assert (o[:p] == o[p:2 * p]).all()
    o2 = traffic.batch_order(p, pb_tiny.SEED + 1, p)
    assert sorted(o2) == list(range(p))


def _mix(**kw):
    spec = {"rate_per_s": 5000,
            "arrivals": {"cv": 1.0}, "sizes": [[1, 1, 1.0]],
            "pool_queries": 4096}
    spec.update(kw)
    return spec


@pytest.mark.parametrize("spec", [
    traffic.load("requests-open"),
    _mix(sizes=[[1, 1, 1.0], [2, 64, 1.0]], arrivals={"cv": 3.0})],
    ids=["requests-open", "sized-bursty"])
def test_requests_same_work_every_seed(spec):
    a = traffic.requests(spec, pb_tiny.SEED, 2.0)
    b = traffic.requests(spec, pb_tiny.SEED + 7, 2.0)
    c = traffic.requests(spec, pb_tiny.SEED, 2.0)
    assert len(a) == len(b) == round(spec["rate_per_s"] * 2.0)
    assert sorted(a.rows) == sorted(b.rows)
    assert (a.due == c.due).all() and (a.rows == c.rows).all()
    assert not (a.due == b.due).all()
    top = max(g[1] for g in spec["sizes"])
    for r in (a, b):
        assert (np.diff(r.due) >= 0).all() and r.due.min() >= 0
        assert r.due.max() < 2.0
        assert r.rows.min() >= 1 and r.rows.max() <= top
        assert (r.start >= 0).all()
        assert (r.start + r.rows <= spec["pool_queries"]).all()


def test_sizes_follow_their_groups():
    spec = _mix(sizes=[[1, 1, 1.0], [2, 64, 3.0]])
    rows = traffic.requests(spec, 5, 4.0).rows
    assert abs((rows == 1).mean() - 0.25) < 0.03
    big = rows[rows > 1]
    assert big.min() == 2 and big.max() == 64
    assert abs(big.mean() - 33) < 2


@pytest.mark.parametrize("cv", [1.0, 3.0])
def test_arrival_gaps_have_their_spread(cv):
    due = traffic.requests(_mix(arrivals={"cv": cv}), 11, 8.0).due
    gaps = np.diff(due)
    assert abs(gaps.std() / gaps.mean() - cv) < 0.1 * cv


def test_requests_rate_override():
    spec = traffic.load("requests-open")
    assert len(traffic.requests(spec, 1, 1.0, rate=123)) == 123
