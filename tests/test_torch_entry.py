"""Twins of tests/test_entry.py's fast tests on the port: entry selection
(the sampled dense entry, the stratified seeds of ``entry_mode="seed"``
and the greedy descent) with each reference test's own bars, and the
port's result held to the reference's on the same graph (the port's save
loaded into the reference). The graph is built once for the module, and
the tests that built their own index in the reference search a copy of it.

The reference on the CPU runs its legacy beam unless told otherwise; at
these shapes the port's fused beam returns what that beam returns
(``same_search``: ids >= 99% equal, the bar of the search parity tests).
The seed mode's own engine, the fused beam's multi-entry buffer, is held
to the reference's fused beam in interpret mode (HNSW_TPU_BEAM_KERNEL=1)
at ef=64. The four tests the reference marks ``slow`` are not twinned."""

import numpy as np
import pytest

import hnsw_tpu
import hnsw_tpu_torch
from hnsw_tpu.search import entry_sample_size as ref_sample_size
from hnsw_tpu.utils.datasets import synthetic_workload
from hnsw_tpu.utils.recall import recall_at_k
from hnsw_tpu_torch.search import entry_sample_size

from torch_threads import one_torch_thread  # noqa: F401  (a fixture)

N, D, M, EFC = 4000, 32, 16, 60


def port_index(metric="l2"):
    return hnsw_tpu_torch.HnswIndex(D, M, metric, capacity=4096,
                                    ef_construction=EFC, device="cpu")


def truth(base, queries, metric="l2"):
    flat = hnsw_tpu_torch.FlatIndex(D, metric, device="cpu")
    flat.add(base)
    return flat.search(queries, 10)[1]


def copy_of(idx):
    return hnsw_tpu_torch.HnswIndex.from_bytes(idx.to_bytes(), device="cpu")


def same_search(got, want):
    """ids >= 99% equal, distances within rtol 1e-5 where they agree."""
    (d, i), (rd, ri) = got[:2], want[:2]
    same = np.asarray(i) == np.asarray(ri)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(np.asarray(d)[same], np.asarray(rd)[same],
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def wl():
    return synthetic_workload(N, D, n_queries=256, metric="l2", seed=7)


@pytest.fixture(scope="module")
def built(wl):
    """(port index, the reference's load of it, ground truth)."""
    idx = port_index()
    idx.add(wl.base)
    return idx, hnsw_tpu.HnswIndex.from_bytes(idx.to_bytes()), \
        truth(wl.base, wl.queries)


def test_sample_size_static():
    assert entry_sample_size(1 << 20) == 32768
    assert entry_sample_size(1 << 26) == 32768
    assert entry_sample_size(4096) == 128
    assert entry_sample_size(100) == 128
    for cap in (1 << 20, 4096, 100, 12345, 777777):
        s = entry_sample_size(cap)
        assert s & (s - 1) == 0 and s == ref_sample_size(cap)


def test_recall_parity_with_descend(built, wl):
    idx, ref, gt = built
    out = {m: idx.search(wl.queries, 10, ef_search=64, entry_mode=m)
           for m in ("sample", "descend")}
    r_s = recall_at_k(out["sample"][1], gt, 10)
    r_d = recall_at_k(out["descend"][1], gt, 10)
    assert r_s >= 0.95
    assert r_s >= r_d - 0.02, (r_s, r_d)
    for m, got in out.items():
        same_search(got, ref.search(wl.queries, 10, ef_search=64,
                                    entry_mode=m))


def test_sample_deterministic(built, wl):
    idx = built[0]
    d1, i1 = idx.search(wl.queries, 10, ef_search=64, entry_mode="sample")
    d2, i2 = idx.search(wl.queries, 10, ef_search=64, entry_mode="sample")
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)


def test_ip_metric_sample():
    wl = synthetic_workload(N, D, n_queries=128, metric="ip", seed=8)
    idx = port_index("ip")
    idx.add(wl.base)
    got = idx.search(wl.queries, 10, ef_search=64, entry_mode="sample")
    assert recall_at_k(got[1], truth(wl.base, wl.queries, "ip"), 10) >= 0.93
    ref = hnsw_tpu.HnswIndex.from_bytes(idx.to_bytes())
    same_search(got, ref.search(wl.queries, 10, ef_search=64,
                                entry_mode="sample"))


@pytest.mark.parametrize("mode", ["sample", "seed"])
def test_packed(built, wl, mode):
    """test_sample_with_packed and test_seed_mode_packed: 8-bit packed
    rows, on a copy of the graph and on the reference's."""
    idx, ref, gt = built
    idx2, ref2 = copy_of(idx), hnsw_tpu.HnswIndex.from_bytes(idx.to_bytes())
    idx2.enable_packed(bits=8)
    ref2.enable_packed(bits=8)
    got = idx2.search(wl.queries, 10, ef_search=64, entry_mode=mode)
    assert recall_at_k(got[1], gt, 10) >= 0.95
    if mode == "sample":
        same_search(got, ref2.search(wl.queries, 10, ef_search=64,
                                     entry_mode=mode))


def test_tombstones_pre_vacuum(built, wl):
    idx, ref = copy_of(built[0]), hnsw_tpu.HnswIndex.from_bytes(
        built[0].to_bytes())
    dead = np.arange(0, N, 3)
    idx.remove_ids(dead)
    ref.remove_ids(dead)
    got = idx.search(wl.queries, 10, ef_search=64, entry_mode="sample")
    assert not np.isin(got[1][got[1] >= 0], dead).any()
    same_search(got, ref.search(wl.queries, 10, ef_search=64,
                                entry_mode="sample"))


@pytest.mark.parametrize("mode", ["sample", "seed"])
def test_filtered_search(built, wl, mode):
    """test_filtered_search_sample and test_seed_mode_legacy_fallback: a
    filter runs the legacy beam, which starts from the best seed."""
    idx, ref, _ = built
    allow = np.zeros(4096, bool)
    allow[np.arange(0, N, 2)] = True
    got = idx.search(wl.queries, 10, ef_search=96, allowed=allow,
                     entry_mode=mode)
    assert (got[1][got[1] >= 0] % 2 == 0).all()
    same_search(got, ref.search(wl.queries, 10, ef_search=96,
                                allowed=allow, entry_mode=mode))


def test_tiny_index_sample():
    idx = hnsw_tpu_torch.HnswIndex(8, 4, "l2", capacity=1024, device="cpu")
    x = np.eye(8, dtype=np.float32)[:3]
    idx.add(x)
    d, i = idx.search(x, 1, ef_search=16, entry_mode="sample")
    np.testing.assert_array_equal(i[:, 0], [0, 1, 2])
    assert np.allclose(d[:, 0], 0.0, atol=1e-5)


def test_seed_mode_recall_and_determinism(built, wl, monkeypatch):
    """Against the reference's fused beam (its kernel in interpret mode):
    the stratified seeds pre-fill the same buffer."""
    idx, ref, gt = built
    d1, i1 = idx.search(wl.queries, 10, ef_search=64, entry_mode="seed")
    d2, i2 = idx.search(wl.queries, 10, ef_search=64, entry_mode="seed")
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)
    assert recall_at_k(i1, gt, 10) >= 0.95
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    same_search((d1, i1), ref.search(wl.queries, 10, ef_search=64,
                                     entry_mode="seed"))


def test_seed_mode_fewer_hops_same_recall(built, wl):
    idx, _, gt = built
    _, i_seed = idx.search(wl.queries, 10, ef_search=64, max_hops=12,
                           entry_mode="seed")
    _, i_samp = idx.search(wl.queries, 10, ef_search=64, max_hops=12,
                           entry_mode="sample")
    r_seed = recall_at_k(i_seed, gt, 10)
    r_samp = recall_at_k(i_samp, gt, 10)
    assert r_seed >= r_samp - 0.005, (r_seed, r_samp)


def test_seed_mode_small_ef(built, wl):
    """ef below the seed count: the tail seeds are masked at init by the
    runtime ef; recall tracks sample mode at the same small ef."""
    idx, _, gt = built
    d_s, i_s = idx.search(wl.queries, 10, ef_search=10, entry_mode="seed")
    _, i_p = idx.search(wl.queries, 10, ef_search=10, entry_mode="sample")
    r_s = recall_at_k(i_s, gt, 10)
    r_p = recall_at_k(i_p, gt, 10)
    assert r_s >= r_p - 0.02, (r_s, r_p)
    _, i2 = idx.search(wl.queries, 10, ef_search=10, entry_mode="seed")
    np.testing.assert_array_equal(i_s, i2)


def test_seed_dedup_sparse_index(wl):
    """ntotal below the sample size: strided sampling repeats ids, and
    adjacent strata may emit the same seed; no result holds an id
    twice."""
    idx = port_index()
    idx.add(wl.base[:50])
    d, i = idx.search(wl.base[:8], 10, ef_search=32, entry_mode="seed")
    np.testing.assert_array_equal(i[:, 0], np.arange(8))
    for row in i:
        live = row[row >= 0]
        assert len(np.unique(live)) == len(live), row
    ref = hnsw_tpu.HnswIndex.from_bytes(idx.to_bytes())
    np.testing.assert_array_equal(
        ref.search(wl.base[:8], 10, ef_search=32, entry_mode="seed")[1], i)
