"""The port's range search, grow, ef tuners and merge_from against the
reference, on the CPU: twins of tests/test_range_search.py, the
device-mode tests/test_grow.py and three tests/test_index_api.py cases.
Graphs are shared by loading the port's save into the reference, as in
tests/test_torch_mutable.py, whose helpers this file uses."""

import numpy as np
import pytest
import torch

import hnsw_tpu
import hnsw_tpu_torch
from hnsw_tpu.utils.recall import recall_at_k
from hnsw_tpu_torch.ops import packed

from conftest import exact_knn
from test_torch_mutable import (assert_same_arrays, assert_same_search,
                                copy_of, port_index, ref_of)
# fixtures: the shared graph, and one intra-op thread for the module
from test_torch_mutable import f32  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401  (a fixture)


# ---------------------------------------------------------------------------
# range search (twins of tests/test_range_search.py)
# ---------------------------------------------------------------------------

def assert_same_range(got, want):
    """(lims, D, I) against the reference's range_search of the same graph:
    equal lims, and ids >= 99% equal with distances within rtol 1e-5
    where they agree."""
    np.testing.assert_array_equal(got[0], want[0])
    assert_same_search(got[1:], [np.asarray(a) for a in want[1:]])


def test_hnsw_range_tracks_exact(f32, monkeypatch):
    idx, wl = f32
    q, base = wl.queries[:32], wl.base
    flat = hnsw_tpu_torch.FlatIndex(24, "l2", device="cpu")
    flat.add(base)
    r = float(np.median(flat.search(q, 8)[0][:, 4]))
    lims_e, _, i_e = flat.range_search(q, r)
    lims, d, i = idx.range_search(q, r, ef_search=64)
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    assert_same_range((lims, d, i),
                      ref_of(idx).range_search(q, r, ef_search=64))
    assert (d < r).all()
    found = expected = 0
    for qi in range(len(q)):
        want = set(i_e[lims_e[qi]:lims_e[qi + 1]])
        got = set(i[lims[qi]:lims[qi + 1]])
        for g in got:
            assert ((q[qi] - base[g]) ** 2).sum() < r
        seg = d[lims[qi]:lims[qi + 1]]
        assert (np.diff(seg) >= 0).all()              # best-first
        expected += len(want)
        found += len(want & got)
    assert found >= 0.95 * expected, (found, expected)


def test_ip_range_sign_convention(monkeypatch):
    idx, wl = port_index(1500, d=16, metric="ip", seed=93, capacity=2048,
                         efc=80)
    q, base = wl.queries[:16], wl.base
    dots = q @ base.T
    r = float(np.median(np.sort(dots, axis=1)[:, -5]))
    hl, hd, hi = idx.range_search(q, r, ef_search=96)
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    assert_same_range((hl, hd, hi),
                      ref_of(idx).range_search(q, r, ef_search=96))
    assert (hd > r).all()
    want = [set(np.flatnonzero(dots[qi] > r)) for qi in range(len(q))]
    for qi in range(len(q)):
        assert (np.diff(hd[hl[qi]:hl[qi + 1]]) <= 0).all()  # descending dot
    got = sum(len(set(hi[hl[qi]:hl[qi + 1]]) & want[qi])
              for qi in range(len(q)))
    assert got >= 0.9 * sum(len(w) for w in want)


# ---------------------------------------------------------------------------
# grow (twins of the device-mode tests/test_grow.py)
# ---------------------------------------------------------------------------

def test_grow_preserves_search_bit_identical(f32):
    """The arrays the reference's grow() of the same index holds, and the
    same search as before the grow."""
    idx, wl = f32
    idx = copy_of(idx)
    ref = ref_of(idx)
    idx.enable_packed(bits=8)
    d1, i1 = idx.search(wl.queries, 10, ef_search=64)
    idx.grow(8192)
    ref.grow(8192)
    assert_same_arrays(idx, ref)
    assert idx.config.capacity == 8192 and idx.packed_enabled
    d2, i2 = idx.search(wl.queries, 10, ef_search=64)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)


def test_grow_then_add_matches_oneshot_build():
    """The level RNG and batch schedule carry across grow(): the grown
    build equals one with the capacity from the start."""
    wl = hnsw_tpu_torch.synthetic_workload(2400, 16, n_queries=64, seed=32)
    kw = dict(device="cpu", ef_construction=60)
    grown = hnsw_tpu_torch.HnswIndex(16, 8, "l2", capacity=1200, **kw)
    grown.add(wl.base[:1000])
    with pytest.raises(ValueError):
        grown.add(wl.base[1000:])                     # over capacity
    ref = ref_of(grown)
    grown.grow(4096)
    ref.grow(4096)
    assert_same_arrays(grown, ref)
    grown.add(wl.base[1000:])
    oneshot = hnsw_tpu_torch.HnswIndex(16, 8, "l2", capacity=4096, **kw)
    oneshot.add(wl.base[:1000])
    oneshot.add(wl.base[1000:])
    for k in ("neighbors0", "levels"):
        assert torch.equal(getattr(grown.graph, k)[:2400],
                           getattr(oneshot.graph, k)[:2400]), k
    assert grown.graph.entry_point == oneshot.graph.entry_point
    _, i = grown.search(wl.queries, 10, ef_search=96)
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    assert recall_at_k(i, gt, 10) >= 0.9


def test_grow_validation_and_tombstones(f32):
    idx, wl = f32
    idx = copy_of(idx)
    with pytest.raises(ValueError):
        idx.grow(4096)                                # must strictly grow
    idx.remove_ids(np.arange(0, 3000, 3))
    n_del = idx.n_deleted
    ref = ref_of(idx)
    idx.grow(6000, upper_capacity=64)    # below the current: kept
    ref.grow(6000, upper_capacity=64)
    assert_same_arrays(idx, ref)
    assert idx.n_deleted == n_del and idx._alive.shape == (6000,)
    _, i = idx.search(wl.queries, 5, ef_search=48)
    assert (i[i >= 0] % 3 != 0).all()


def test_grow_keeps_pq_routing_rows_through_add(f32):
    """PQ-coded routing rows over f32 storage survive a grow past the old
    capacity and an add there: the routing codes are padded with the rest
    (the reference drops its tables here: its codes keep the old length),
    so the new ids get their codes and the re-pack (past the table's
    rows: in full, on the same codebooks) equals a fresh pack."""
    from hnsw_tpu_torch.ops.pq import encode_pq
    idx, wl = f32
    idx = copy_of(idx)
    idx.enable_packed(mode="pq", pq_m=4, train_x=wl.base)
    cb = idx._route[0]
    idx.grow(5000)
    assert idx._route[1].shape == (5000, 4)
    idx.add(hnsw_tpu_torch.synthetic_workload(1100, 24, n_queries=1,
                                              seed=8).base)
    n = idx.ntotal                              # 4100 > the old 4096
    assert idx.packed_enabled and idx._last_refresh["branch"] == "full"
    assert idx._route[0] is cb
    codes = idx._route[1]
    assert torch.equal(codes[:n], encode_pq(idx.vectors[:n], cb))
    fresh = packed.pack_pq_neighbors(idx.graph.neighbors0, codes, cb,
                                     n_rows=n)
    assert torch.equal(idx._packed.nbr_codes[:n], fresh.nbr_codes[:n])


def test_grow_save_load(f32, tmp_path):
    idx, wl = f32
    idx = copy_of(idx)
    idx.grow(5000)
    p = str(tmp_path / "g.npz")
    idx.save(p)
    idx2 = hnsw_tpu_torch.HnswIndex.load(p, device="cpu")
    assert idx2.config.capacity == 5000
    _, i1 = idx.search(wl.queries, 5, ef_search=48)
    _, i2 = idx2.search(wl.queries, 5, ef_search=48)
    np.testing.assert_array_equal(i1, i2)
    assert_same_arrays(idx2, hnsw_tpu.HnswIndex.load(p))


# ---------------------------------------------------------------------------
# tuners and merge_from (twins of tests/test_index_api.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tuned():
    return port_index(2000, d=16, seed=95, capacity=2048, efc=80)


def test_tune_ef_search(tuned, monkeypatch):
    """The reference's tuner over the same graph and queries chooses the
    same ef."""
    idx, wl = tuned
    idx = copy_of(idx)
    q = wl.queries[:64]
    ef = idx.tune_ef_search(q, target_recall=0.95, k=10)
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    ref = ref_of(tuned[0])
    assert ref.tune_ef_search(q, target_recall=0.95, k=10) == ef
    assert ef in (16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)
    assert idx.ef_search == ef
    _, gt = exact_knn(wl.base, q, 10, "l2")
    _, i = idx.search(q, 10)
    assert recall_at_k(i, gt, 10) >= 0.95
    assert idx.tune_ef_search(q, target_recall=1.01, set_default=False,
                              ef_grid=(16, 32)) == 32
    assert idx.ef_search == ef


def test_tune_operating_point(tuned, monkeypatch):
    """The reference's tuner over the same graph and queries chooses the
    same (ef, hops)."""
    idx, wl = tuned
    idx = copy_of(idx)
    q = wl.queries[:64]
    ef, hops = idx.tune_operating_point(q, target_recall=0.95, k=10)
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    ref = ref_of(tuned[0])
    assert ref.tune_operating_point(q, target_recall=0.95, k=10) == \
        (ef, hops)
    assert idx.ef_search == ef and 16 <= hops <= ef + 8
    _, gt = exact_knn(wl.base, q, 10, "l2")
    _, i = idx.search(q, 10, ef_search=ef, max_hops=hops)
    assert recall_at_k(i, gt, 10) >= 0.95


def test_merge_from(tuned):
    """The reference's merge_from of the same two indexes (loaded from the
    port's saves) merges the same count and vectors into the same graph,
    edge for edge; ``other`` is unchanged in both."""
    idx, wl = tuned
    a = hnsw_tpu_torch.HnswIndex(16, 8, "l2", device="cpu", capacity=2048,
                                 ef_construction=80, seed=3)
    a.add(wl.base[:1200])
    b = hnsw_tpu_torch.HnswIndex(16, 8, "l2", device="cpu", capacity=1024,
                                 ef_construction=80, seed=5)
    b.add(wl.base[1200:1600])
    b.remove_ids(np.arange(10))       # tombstoned rows are not merged
    ra, rb = ref_of(a), ref_of(b)
    assert a.merge_from(b) == ra.merge_from(rb) == 390
    assert a.ntotal == ra.ntotal == 1590 and b.ntotal == rb.ntotal == 400
    assert_same_arrays(a, ra)
    assert_same_arrays(b, rb)
    keep = np.r_[wl.base[:1200], wl.base[1210:1600]]
    _, i = a.search(wl.queries, k=10, ef_search=64)
    _, ti = exact_knn(keep, wl.queries, 10, "l2")
    assert recall_at_k(i, ti, 10) >= 0.90
    with pytest.raises(ValueError, match="dim"):
        a.merge_from(hnsw_tpu_torch.HnswIndex(8, 8, "l2", capacity=64,
                                              device="cpu"))
    with pytest.raises(ValueError, match="metric"):
        a.merge_from(hnsw_tpu_torch.HnswIndex(16, 8, "ip", capacity=64,
                                              device="cpu"))
