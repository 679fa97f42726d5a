"""The port's host builder against the reference, on the CPU:
``hnsw_tpu_torch.NumpyHnsw`` (twins of tests/test_reference_impl.py) and
``HnswIndex(build="host")`` (the host-build cases of
tests/test_index_api.py, tests/test_grow.py::test_grow_host_build_mode, the
host fixtures of tests/test_serialization.py and the sq8 / pq refusals of
tests/test_sq.py and tests/test_pq.py).

The builder is numpy in both packages, so on the same config and data the
port's graph must be the reference's edge for edge (``assert_same_graph``:
arrays equal, no tolerance). Searches of the same host-built graph are held
to the reference's within the parity tolerances of
tests/test_torch_search.py: ids >= 99% equal, matched distances within
rtol 1e-5, recall within 0.005 and hops equal."""

import numpy as np
import pytest

import hnsw_tpu
import hnsw_tpu_torch
from hnsw_tpu.utils.datasets import synthetic_workload
from hnsw_tpu.utils.recall import recall_at_k
from hnsw_tpu_torch import NumpyHnsw
from hnsw_tpu_torch.config import HnswConfig
from hnsw_tpu_torch.graph import check_invariants, graph_from_numpy

from conftest import exact_knn
from torch_threads import one_torch_thread  # noqa: F401  (a fixture)
# one intra-op thread for the module


def port_host(d, m, metric="l2", **kw):
    return hnsw_tpu_torch.HnswIndex(d, m, metric, build="host",
                                    device="cpu", **kw)


def ref_host(d, m, metric="l2", **kw):
    return hnsw_tpu.HnswIndex(d, m, metric, build="host", **kw)


def graph_of(idx) -> dict:
    """The graph arrays of a port index, a reference index or either
    package's NumpyHnsw, as numpy keyed by field."""
    if hasattr(idx, "to_graph_arrays"):
        g = idx.to_graph_arrays()
    else:
        g = idx.graph.numpy() if hasattr(idx.graph, "numpy") else idx.graph
    get = g.__getitem__ if isinstance(g, dict) else \
        (lambda k: getattr(g, k))
    return {k: np.asarray(get(k)) for k in (
        "neighbors0", "levels", "upper_slot", "upper_node",
        "upper_neighbors", "entry_point", "max_level", "ntotal", "n_upper")}


def assert_same_graph(port, ref) -> None:
    """Edge for edge: every graph array equal."""
    want = graph_of(ref)
    for k, v in graph_of(port).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def assert_same_index(port, ref) -> None:
    """Config, graph and stored vectors (as f32) equal."""
    assert port.config.to_json() == ref.config.to_json()
    assert_same_graph(port, ref)
    np.testing.assert_array_equal(
        port.vectors.float().numpy(),
        np.asarray(ref.vectors).astype(np.float32))


def assert_same_search(got, want, gt=None, k=None):
    """The port's search against the reference's on the same graph: ids >=
    99% equal, distances within rtol 1e-5 where they agree, recall within
    0.005 and, with stats, hops equal."""
    (d, i), (rd, ri) = got[:2], [np.asarray(a) for a in want[:2]]
    same = i == ri
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(d[same], rd[same], rtol=1e-5, atol=1e-5)
    if gt is not None:
        assert abs(recall_at_k(i, gt, k) - recall_at_k(ri, gt, k)) <= 0.005
    if len(got) > 2:
        assert got[2].hops == int(want[2].hops)


@pytest.fixture(scope="module")
def port_numpy(small_workload):
    """The port's NumpyHnsw on conftest's ``host_index`` config and data."""
    cfg = HnswConfig(dim=32, m=8, metric="l2", capacity=2048,
                     ef_construction=80, ef_search=64, seed=3)
    idx = NumpyHnsw(cfg)
    idx.add(small_workload.base)
    return idx


@pytest.fixture(scope="module")
def port_numpy_ip(small_ip_workload):
    cfg = HnswConfig(dim=24, m=8, metric="ip", capacity=2048,
                     ef_construction=80, ef_search=64, seed=5)
    idx = NumpyHnsw(cfg)
    idx.add(small_ip_workload.base)
    return idx


# ---------------------------------------------------------------------------
# NumpyHnsw (twins of tests/test_reference_impl.py)
# ---------------------------------------------------------------------------

def test_level_distribution():
    cfg = HnswConfig(dim=4, m=16, capacity=50_000, seed=0)
    idx = NumpyHnsw(cfg)
    levels = np.array([idx.draw_level() for _ in range(50_000)])
    assert abs((levels >= 1).mean() - 1 / 16) < 0.01    # P(level >= 1) = 1/m
    assert abs((levels >= 2).mean() - 1 / 256) < 0.005
    ref = hnsw_tpu.NumpyHnsw(hnsw_tpu.HnswConfig(dim=4, m=16,
                                                 capacity=50_000, seed=0))
    np.testing.assert_array_equal(
        levels, [ref.draw_level() for _ in range(50_000)])


def test_select_neighbors_heuristic_diversity():
    """Each kept c is closer to q than to any earlier-kept neighbor (faiss
    shrink_neighbor_list), and the kept list is the reference's."""
    cfg = HnswConfig(dim=2, m=4, capacity=64, seed=1)
    idx = NumpyHnsw(cfg)
    ref = hnsw_tpu.NumpyHnsw(hnsw_tpu.HnswConfig(dim=2, m=4, capacity=64,
                                                 seed=1))
    pts = np.random.default_rng(2).normal(size=(20, 2)).astype(np.float32)
    idx.vectors[:20] = ref.vectors[:20] = pts
    q = np.zeros(2, np.float32)
    cand = sorted(zip(((pts - q) ** 2).sum(1).tolist(), range(20)))
    kept = idx.select_neighbors(q, cand, m=4)
    assert kept == ref.select_neighbors(q, cand, m=4)
    assert len(kept) <= 4
    for pos, c in enumerate(kept):
        d_cq = ((pts[c] - q) ** 2).sum()
        for k2 in kept[:pos]:
            assert ((pts[c] - pts[k2]) ** 2).sum() >= d_cq


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_numpy_hnsw_matches_reference_edge_for_edge(
        metric, port_numpy, port_numpy_ip, host_index, host_ip_index):
    port, ref = (port_numpy, host_index) if metric == "l2" else \
        (port_numpy_ip, host_ip_index)
    assert_same_graph(port, ref)
    np.testing.assert_array_equal(port.vectors, ref.vectors)


def test_recall_vs_brute_force(port_numpy, host_index, small_workload):
    wl = small_workload
    d, i = port_numpy.search(wl.queries, k=10, ef_search=64)
    _, ti = exact_knn(wl.base, wl.queries, 10, "l2")
    assert recall_at_k(i, ti, 10) >= 0.95
    rd, ri = host_index.search(wl.queries, k=10, ef_search=64)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(d, rd)


def test_invariants(port_numpy):
    g = graph_from_numpy(port_numpy.to_graph_arrays(), "cpu")
    stats = check_invariants(g, port_numpy.cfg)
    assert stats["errors"] == []
    assert stats["deg0_max"] <= port_numpy.cfg.m0


def test_self_query(port_numpy, small_workload):
    base = small_workload.base
    d, i = port_numpy.search(base[:20], k=1, ef_search=32)
    assert (i[:, 0] == np.arange(20)).mean() > 0.9
    assert (d[i[:, 0] == np.arange(20), 0] < 1e-4).all()


def test_ip_metric(port_numpy_ip, small_ip_workload):
    wl = small_ip_workload
    _, i = port_numpy_ip.search(wl.queries, k=10, ef_search=64)
    _, ti = exact_knn(wl.base, wl.queries, 10, "ip")
    assert recall_at_k(i, ti, 10) >= 0.9


def test_determinism(small_workload):
    cfg = HnswConfig(dim=32, m=8, capacity=512, ef_construction=40, seed=9)
    a, b = NumpyHnsw(cfg), NumpyHnsw(cfg)
    a.add(small_workload.base[:300])
    b.add(small_workload.base[:300])
    assert (a.neighbors0 == b.neighbors0).all()
    assert (a.levels == b.levels).all()


# ---------------------------------------------------------------------------
# HnswIndex(build="host") (host cases of tests/test_index_api.py, ...)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_pair(small_workload):
    """(port, reference) host-built indexes over the first 1,000 points,
    added in two batches."""
    wl = small_workload
    out = []
    for make in (port_host, ref_host):
        idx = make(32, 8, capacity=2048, ef_construction=80, seed=3)
        idx.add(wl.base[:500])
        idx.add(wl.base[500:1000])
        out.append(idx)
    return tuple(out)


def test_faiss_parity_surface(host_pair, small_workload, monkeypatch):
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    wl = small_workload
    idx, ref = host_pair
    assert idx.build_mode == "host" and idx.is_trained and idx.d == 32
    assert idx.ntotal == 1000
    assert_same_index(idx, ref)
    idx.ef_search = ref.ef_search = 64
    d, i = idx.search(wl.queries, k=10)
    assert d.shape == (len(wl.queries), 10) and i.dtype == np.int64
    _, ti = exact_knn(wl.base[:1000], wl.queries, 10, "l2")
    assert recall_at_k(i, ti, 10) >= 0.93
    assert_same_search(idx.search(wl.queries, 10, with_stats=True),
                       ref.search(wl.queries, 10, with_stats=True), ti, 10)
    np.testing.assert_allclose(idx.reconstruct(3), wl.base[3], rtol=1e-6)
    np.testing.assert_allclose(idx.reconstruct_n(10, 5), wl.base[10:15],
                               rtol=1e-6)
    assert idx.check()["errors"] == []


@pytest.mark.parametrize("packed,entry_mode", [(False, "sample"),
                                               (True, "sample"),
                                               (False, "descend")])
def test_host_graph_searches_match_reference(
        host_pair, small_workload, monkeypatch, packed, entry_mode):
    """The same host-built graph searched by both packages, unpacked and
    packed 8-bit, at two entry modes."""
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    wl = small_workload
    idx, ref = host_pair
    _, gt = exact_knn(wl.base[:1000], wl.queries, 10, "l2")
    if packed:
        idx.enable_packed(bits=8)
        ref.enable_packed(bits=8)
    try:
        assert_same_search(
            idx.search(wl.queries, 10, ef_search=48, with_stats=True,
                       entry_mode=entry_mode),
            ref.search(wl.queries, 10, ef_search=48, with_stats=True,
                       entry_mode=entry_mode), gt, 10)
    finally:
        idx.disable_packed()
        ref.disable_packed()


def test_host_add_drops_packed_tables(small_workload):
    """A host build drops the tables (the reference's rule); search after
    it runs unpacked until enable_packed() again."""
    wl = small_workload
    idx = port_host(32, 8, capacity=1024, ef_construction=40, seed=3)
    idx.add(wl.base[:300])
    idx.enable_packed(bits=8)
    idx.add(wl.base[300:400])
    assert not idx.packed_enabled and idx.ntotal == 400
    idx.enable_packed(bits=8)
    _, i = idx.search(wl.queries, 5, ef_search=48)
    assert (i >= 0).all()


def test_capacity_guard():
    idx = port_host(4, 4, capacity=10)
    with pytest.raises(ValueError, match="capacity"):
        idx.add(np.zeros((11, 4), np.float32))


def test_empty_index_search():
    idx = port_host(4, 4, capacity=10)
    d, i = idx.search(np.zeros((3, 4), np.float32), k=2)
    assert (i == -1).all() and np.isinf(d).all()


def test_dim_guard():
    idx = port_host(4, 4, capacity=10)
    with pytest.raises(ValueError, match="expected"):
        idx.add(np.zeros((2, 5), np.float32))


@pytest.mark.parametrize("kw", [{"dtype": "sq8"},
                                {"dtype": "pq", "pq_m": 4}])
def test_codec_storage_rejects_host_build(kw):
    """Twins of tests/test_sq.py:153 and tests/test_pq.py:287."""
    with pytest.raises(ValueError, match="device"):
        port_host(8, 4, capacity=64, **kw)
    with pytest.raises(ValueError, match="device"):
        ref_host(8, 4, capacity=64, **kw)


def test_bf16_storage(small_workload):
    wl = small_workload
    idx = port_host(32, 8, capacity=1024, dtype="bfloat16",
                    ef_construction=80)
    ref = ref_host(32, 8, capacity=1024, dtype="bfloat16",
                   ef_construction=80)
    idx.add(wl.base[:600])
    ref.add(wl.base[:600])
    assert str(idx.vectors.dtype) == "torch.bfloat16"
    assert_same_index(idx, ref)
    _, i = idx.search(wl.queries, k=10, ef_search=64)
    _, ti = exact_knn(wl.base[:600], wl.queries, 10, "l2")
    assert recall_at_k(i, ti, 10) >= 0.85   # bf16 storage costs a little


def test_reconstruct_batch_and_search_and_reconstruct(small_workload):
    wl = small_workload
    idx = port_host(32, 8, capacity=2048, ef_construction=80, seed=3)
    idx.add(wl.base[:800])
    ids = np.array([7, 3, 3, 799, 0, -1], np.int64)
    r = idx.reconstruct_batch(ids)
    np.testing.assert_allclose(r[:5], wl.base[ids[:5]], rtol=1e-6)
    assert (r[5] == 0).all()
    with pytest.raises(IndexError):
        idx.reconstruct_batch(np.array([800]))
    d, i, r = idx.search_and_reconstruct(wl.queries[:20], k=5, ef_search=64)
    assert r.shape == (20, 5, 32)
    valid = i >= 0
    np.testing.assert_allclose(r[valid], wl.base[i[valid]], rtol=1e-6)
    assert np.isnan(r[~valid]).all()
    q = np.repeat(wl.queries[:20, None, :], 5, axis=1)
    np.testing.assert_allclose(
        d[valid], ((q[valid] - r[valid]) ** 2).sum(-1), rtol=1e-3, atol=1e-2)
    # k > reachable: the missing rows come back NaN
    tiny = port_host(32, 8, capacity=64, seed=3)
    tiny.add(wl.base[:3])
    _, it, rt = tiny.search_and_reconstruct(wl.queries[:4], k=5,
                                            ef_search=16)
    assert (it == -1).any() and np.isnan(rt[it == -1]).all()
    np.testing.assert_allclose(rt[it >= 0], wl.base[it[it >= 0]], rtol=1e-6)


def test_merge_from(small_workload):
    """Host-mode merge_from re-adds through the host builder: the merged
    graph is the reference's edge for edge."""
    wl = small_workload
    pair = []
    for make in (port_host, ref_host):
        a = make(32, 8, capacity=1024, ef_construction=60, seed=3)
        a.add(wl.base[:400])
        b = make(32, 8, capacity=512, ef_construction=60, seed=5)
        b.add(wl.base[400:700])
        b.remove_ids(np.arange(10))      # tombstoned rows are not merged
        assert a.merge_from(b) == 290
        assert a.ntotal == 690 and b.ntotal == 300
        pair.append(a)
    a, ref = pair
    assert_same_index(a, ref)
    keep = np.r_[wl.base[:400], wl.base[410:700]]
    _, ti = exact_knn(keep, wl.queries, 10, "l2")
    _, i = a.search(wl.queries, k=10, ef_search=64)
    assert recall_at_k(i, ti, 10) >= 0.90
    with pytest.raises(ValueError, match="dim"):
        a.merge_from(port_host(16, 8, capacity=64))
    with pytest.raises(ValueError, match="metric"):
        a.merge_from(port_host(32, 8, "ip", capacity=64))


def test_grow_host_build_mode():
    """grow() pads the host builder's arrays too: the build goes on as the
    reference's, edge for edge."""
    wl = synthetic_workload(400, 16, n_queries=16, metric="l2", seed=34)
    base = np.asarray(wl.base)
    pair = []
    for make in (port_host, ref_host):
        idx = make(16, 8, capacity=512, ef_construction=40)
        idx.add(base[:300])
        idx.grow(1024)
        idx.add(base[300:])
        pair.append(idx)
    idx, ref = pair
    assert idx.ntotal == 400 and idx._host.vectors.shape[0] == 1024
    assert_same_index(idx, ref)
    _, i = idx.search(np.asarray(wl.queries), 5, ef_search=48)
    gt = np.argsort(((np.asarray(wl.queries)[:, None] - base[None]) ** 2)
                    .sum(-1), 1)[:, :5]
    assert recall_at_k(i, gt, 5) >= 0.9


def test_compacted_keeps_host_mode(small_workload):
    wl = small_workload
    pair = []
    for make in (port_host, ref_host):
        idx = make(32, 8, capacity=1024, ef_construction=40, seed=3)
        idx.add(wl.base[:400])
        idx.remove_ids(np.arange(0, 400, 7))
        pair.append(idx.compacted())
    (new, old_ids), (ref, ref_old) = pair
    assert new.build_mode == "host"
    np.testing.assert_array_equal(old_ids, ref_old)
    assert_same_index(new, ref)


def test_vacuum_then_host_add_filters_dead_ids(small_workload):
    """After vacuum(), a host add brings back the host graph, which still
    links the tombstoned ids: the port filters them again (the reference
    returns them; ROADMAP.md Queue C)."""
    wl = small_workload
    idx = port_host(32, 8, capacity=2048, ef_construction=60, seed=3)
    idx.add(wl.base[:1000])
    idx.remove_ids(np.arange(100))
    idx.vacuum()
    idx.add(wl.base[1000:1100])
    _, i = idx.search(wl.queries, 10, ef_search=48)
    assert not np.isin(i, np.arange(100)).any()
    assert idx.n_deleted == 100


# ---------------------------------------------------------------------------
# save / load of a host-built index (tests/test_serialization.py fixtures)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def synced(port_numpy):
    """A port index over conftest's host graph, through ``_sync_from_host``
    as the reference's serialization tests make theirs."""
    idx = hnsw_tpu_torch.HnswIndex(config=port_numpy.cfg, build="host",
                                   device="cpu")
    idx._host = port_numpy
    idx._sync_from_host()
    return idx


def test_save_load_bit_identical_search(synced, small_workload, tmp_path,
                                        monkeypatch):
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    wl = small_workload
    d1, i1 = synced.search(wl.queries[:50], k=10)
    p = str(tmp_path / "index.npz")
    synced.save(p)
    idx2 = hnsw_tpu_torch.HnswIndex.load(p, device="cpu")
    assert idx2.build_mode == "device"        # as the reference's load
    assert idx2.ntotal == synced.ntotal and idx2.config == synced.config
    d2, i2 = idx2.search(wl.queries[:50], k=10)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)
    ref = hnsw_tpu.HnswIndex.load(p)          # the port's file, read there
    assert_same_index(synced, ref)
    assert_same_search((d1, i1), ref.search(wl.queries[:50], k=10))


def test_to_bytes_from_bytes_roundtrip(synced, small_workload):
    wl = small_workload
    idx = hnsw_tpu_torch.HnswIndex.from_bytes(synced.to_bytes(),
                                              device="cpu")
    idx.remove_ids(np.arange(5))   # tombstones ride along in the blob
    blob = idx.to_bytes()
    idx2 = hnsw_tpu_torch.HnswIndex.from_bytes(blob, device="cpu")
    assert idx2.ntotal == idx.ntotal and idx2.n_deleted == 5
    d1, i1 = idx.search(wl.queries[:50], k=10)
    d2, i2 = idx2.search(wl.queries[:50], k=10)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)
    ref = hnsw_tpu.HnswIndex.from_bytes(blob)
    assert ref.n_deleted == 5
    np.testing.assert_array_equal(np.asarray(ref.search(
        wl.queries[:50], k=10)[1]), i1)


def test_reference_host_save_loads_in_port(host_index, synced,
                                           small_workload, tmp_path):
    """The reference's host-built index, saved there, is the port's graph
    once loaded here."""
    ref = hnsw_tpu.HnswIndex(config=host_index.cfg, build="host")
    ref._host = host_index
    ref._sync_from_host()
    p = str(tmp_path / "ref.npz")
    ref.save(p)
    idx = hnsw_tpu_torch.HnswIndex.load(p, device="cpu")
    assert_same_index(idx, ref)
    assert_same_graph(idx, synced)
