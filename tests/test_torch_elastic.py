"""Failure detection and elastic recovery of the port's sharded index, on
the CPU: twins of the six tests of tests/test_elastic.py (per-shard health
probes, serving over the surviving shards, a mid-build checkpoint resumed
bit for bit, shard restore from a checkpoint), plus a restore across the
packages: the port's failed shard reloaded from a checkpoint the reference
wrote answers as the reference does."""

import numpy as np
import pytest
import torch

from hnsw_tpu.parallel.sharded import ShardedHnswIndex as RefSharded
from hnsw_tpu.parallel.sharded import make_mesh as ref_mesh
from hnsw_tpu.utils.recall import recall_at_k
from hnsw_tpu_torch import synthetic_workload
from hnsw_tpu_torch.parallel.sharded import ShardedHnswIndex, make_mesh

from conftest import exact_knn
from torch_threads import one_torch_thread  # noqa: F401  (a fixture)

CPU = torch.device("cpu")


def cpu_mesh():
    return make_mesh(4, 2, devices=[CPU] * 8)


def _build(n=2000, d=16, seed=71):
    wl = synthetic_workload(n, d, n_queries=64, metric="l2", seed=seed)
    idx = ShardedHnswIndex(d, 8, "l2", mesh=cpu_mesh(),
                           capacity_per_shard=1024, ef_construction=60,
                           seed=29)
    idx.add(wl.base)
    return idx, wl


def test_healthy_by_default():
    idx, _ = _build(n=400)
    assert idx.failed_shards == []
    report = idx.health_check()
    assert all(r["ok"] for r in report), report
    assert [r["count"] for r in report] == [100] * 4


def test_mark_failed_degrades_then_recovers():
    idx, wl = _build()
    q = wl.queries
    d_full, i_full = idx.search(q, k=10, ef_search=64)
    idx.mark_shard_failed(1)
    assert idx.failed_shards == [1]
    d_deg, i_deg = idx.search(q, k=10, ef_search=64)
    # round robin: shard 1 owns the user ids = 1 (mod 4)
    live = i_deg[i_deg >= 0]
    assert live.size > 0 and not (live % 4 == 1).any()
    alive_ids = np.flatnonzero(np.arange(idx.ntotal) % 4 != 1)
    _, gt_alive = exact_knn(wl.base[alive_ids], q, 10, "l2")
    remap = -np.ones(idx.ntotal, np.int64)
    remap[alive_ids] = np.arange(len(alive_ids))
    i_deg_r = np.where(i_deg >= 0, remap[np.maximum(i_deg, 0)], -1)
    assert recall_at_k(i_deg_r, gt_alive, 10) >= 0.9
    idx.mark_shard_ok(1)
    d_back, i_back = idx.search(q, k=10, ef_search=64)
    np.testing.assert_array_equal(i_back, i_full)
    np.testing.assert_array_equal(d_back, d_full)


def test_health_check_detects_corruption_and_restore_recovers(tmp_path):
    """NaN the whole vector table of shard 2: exactly that shard fails the
    self-query probe (the plain K3 and K1 take NaN distances without a
    fault or an endless loop), serving goes on without its ids, and
    ``restore_shards`` brings back the pre-corruption results bit for
    bit."""
    idx, wl = _build(seed=73)
    q = wl.queries
    d_full, i_full = idx.search(q, k=10, ef_search=64)
    p = str(tmp_path / "ckpt.npz")
    idx.save(p)
    idx._storage[2].rows.fill_(float("nan"))
    report = idx.health_check()
    assert [r["shard"] for r in report if not r["ok"]] == [2], report
    assert "probe" in report[2]["errors"][0]
    assert idx.failed_shards == [2]
    _, i_deg = idx.search(q, k=10, ef_search=64)
    live = i_deg[i_deg >= 0]
    assert live.size > 0 and not (live % 4 == 2).any()
    assert idx.restore_shards(p) == [2]
    assert idx.failed_shards == []
    assert all(r["ok"] for r in idx.health_check())
    d_back, i_back = idx.search(q, k=10, ef_search=64)
    np.testing.assert_array_equal(i_back, i_full)
    np.testing.assert_array_equal(d_back, d_full)


def test_health_check_detects_bad_entry_point():
    idx, _ = _build(n=400, seed=77)
    idx._graphs[0].entry_point = -3
    report = idx.health_check(auto_mark=False)
    assert not report[0]["ok"]
    assert "entry_point" in report[0]["errors"][0]
    assert all(r["ok"] for r in report[1:])
    assert idx.failed_shards == []   # auto_mark=False left serving alone


def test_health_check_after_vacuum_of_row_zero():
    """User ids 0-7 are local rows 0 and 1 of every shard. Removed and
    vacuumed, they leave the graph; the probe takes each shard's first
    live row, so every shard stays healthy and keeps serving (the
    reference probes row 0 and would fail all four)."""
    idx, wl = _build(n=400, seed=79)
    idx.remove_ids(np.arange(8))
    assert all(r["ok"] for r in idx.health_check())
    assert idx.vacuum() == 8
    for g in idx._graphs:
        assert (g.neighbors0[:2] < 0).all()
    report = idx.health_check()
    assert all(r["ok"] for r in report), report
    assert idx.failed_shards == []
    _, i = idx.search(wl.queries, k=10, ef_search=64)
    live = i[i >= 0]
    assert not np.isin(live, np.arange(8)).any()
    assert set(np.unique(live % 4)) == {0, 1, 2, 3}


def test_checkpointed_build_resume_is_bit_identical(tmp_path):
    """Half the points, a save, a load and the other half: every shard's
    arrays, user ids and level generators equal an uninterrupted build's,
    and so do the searches."""
    wl = synthetic_workload(1600, 16, n_queries=48, metric="l2", seed=79)
    h1, h2 = wl.base[:800], wl.base[800:]
    kw = dict(capacity_per_shard=1024, ef_construction=60, seed=37)
    a = ShardedHnswIndex(16, 8, "l2", mesh=cpu_mesh(), **kw)
    a.add(h1)
    a.add(h2)
    b = ShardedHnswIndex(16, 8, "l2", mesh=cpu_mesh(), **kw)
    b.add(h1)
    p = str(tmp_path / "mid.npz")
    b.save(p)
    c = ShardedHnswIndex.load(p, mesh=cpu_mesh())
    c.add(h2)
    for ga, gc in zip(a._graphs, c._graphs):
        assert vars(ga).keys() == vars(gc).keys()
        for f, v in vars(ga).items():
            assert (torch.equal(v, getattr(gc, f)) if torch.is_tensor(v)
                    else v == getattr(gc, f)), f
    for x, y in zip(a._global_ids + [st.rows for st in a._storage],
                    c._global_ids + [st.rows for st in c._storage]):
        assert torch.equal(x, y)
    assert [s.rng.random() for s in a._builders] == \
        [s.rng.random() for s in c._builders]
    da, ia = a.search(wl.queries, k=10, ef_search=64)
    dc, ic = c.search(wl.queries, k=10, ef_search=64)
    np.testing.assert_array_equal(ia, ic)
    np.testing.assert_array_equal(da, dc)


def test_restore_rejects_mismatched_checkpoint(tmp_path):
    idx, _ = _build(n=400, seed=81)
    other = ShardedHnswIndex(16, 16, "l2", mesh=idx.mesh,
                             capacity_per_shard=1024, seed=5)
    other.add(np.random.default_rng(0).normal(size=(64, 16)).astype(
        np.float32))
    p = str(tmp_path / "other.npz")
    other.save(p)
    idx.mark_shard_failed(0)
    with pytest.raises(ValueError, match="config"):
        idx.restore_shards(p)
    two = ShardedHnswIndex(16, 8, "l2", mesh=make_mesh(2, devices=[CPU] * 2),
                           capacity_per_shard=1024, ef_construction=60,
                           seed=29)
    two.add(np.random.default_rng(1).normal(size=(64, 16)).astype(
        np.float32))
    p2 = str(tmp_path / "two.npz")
    two.save(p2)
    with pytest.raises(ValueError, match="shards"):
        idx.restore_shards(p2)
    assert idx.failed_shards == [0]


def test_restore_from_a_reference_checkpoint(tmp_path):
    """The reference builds and saves; the port loads that file and
    searches as the reference does (ids >= 99% equal, distances within
    rtol 1e-5 + atol 1e-5 where equal); a shard the port corrupts and
    restores from the same file answers so again; and the config JSON of
    the two packages is one string."""
    wl = synthetic_workload(2000, 16, n_queries=64, metric="l2", seed=73)
    ref = RefSharded(16, 8, "l2", mesh=ref_mesh(4, 2),
                     capacity_per_shard=1024, ef_construction=60, seed=29)
    ref.add(wl.base)
    p = str(tmp_path / "ref.npz")
    ref.save(p)
    rd, ri = ref.search(wl.queries, k=10, ef_search=64)
    port = ShardedHnswIndex.load(p, mesh=cpu_mesh())
    assert port.config.to_json() == ref.config.to_json()

    def same_as_reference():
        d, i = port.search(wl.queries, k=10, ef_search=64)
        same = i == ri
        assert same.mean() >= 0.99, same.mean()
        np.testing.assert_allclose(d[same], rd[same], rtol=1e-5, atol=1e-5)

    same_as_reference()
    port._storage[1].rows.fill_(float("nan"))
    port._graphs[1].neighbors0.fill_(-1)
    assert [r["shard"] for r in port.health_check() if not r["ok"]] == [1]
    assert port.restore_shards(p) == [1]
    assert all(r["ok"] for r in port.health_check())
    same_as_reference()
