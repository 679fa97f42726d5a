"""Twins of tests/test_device_search.py on the port: the query engine
(``hnsw_tpu_torch.search.hnsw_search``) over conftest's known-good
NumPy-built graphs, with each reference test's own bars, and the port's
result held to the reference's ``hnsw_search`` on the same graph and
queries. The reference on the CPU runs its legacy beam; on these graphs
the port's fused beam returns what that beam returns (``same_search``:
ids >= 99% equal, the bar of the search parity tests)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_tpu.search import compute_sqnorms
from hnsw_tpu.search import hnsw_search as ref_search
from hnsw_tpu.utils.recall import recall_at_k
from hnsw_tpu_torch import search as port_search
from hnsw_tpu_torch.graph import graph_from_numpy

from conftest import exact_knn


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module (tests/test_torch_mutable.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _search(host_idx, queries, k, ef, **kw):
    """The port's search of a NumpyHnsw's graph: (D, I[, stats]) numpy."""
    out = port_search.hnsw_search(
        graph_from_numpy(host_idx.to_graph_arrays(), "cpu"),
        torch.from_numpy(host_idx.vectors), torch.from_numpy(queries),
        k=k, ef_search=ef, metric=host_idx.cfg.metric,
        max_level_cap=host_idx.cfg.max_level_cap, **kw)
    return (out[0].numpy(), out[1].numpy()) + tuple(out[2:])


def _ref(host_idx, queries, k, ef, **kw):
    v = jnp.asarray(host_idx.vectors)
    out = ref_search(host_idx.to_graph_arrays(), v, compute_sqnorms(v),
                     jnp.asarray(queries), k=k, ef_search=ef,
                     metric=host_idx.cfg.metric,
                     max_level_cap=host_idx.cfg.max_level_cap, **kw)
    return (np.asarray(out[0]), np.asarray(out[1])) + tuple(out[2:])


def same_search(got, want):
    (d, i), (rd, ri) = got[:2], want[:2]
    same = i == ri
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(d[same], rd[same], rtol=1e-5, atol=1e-5)


def test_recall_matches_reference(host_index, small_workload):
    wl = small_workload
    got = _search(host_index, wl.queries, 10, 64)
    _, ti = exact_knn(wl.base, wl.queries, 10, "l2")
    r_dev = recall_at_k(got[1], ti, 10)
    _, i_ref = host_index.search(wl.queries, k=10, ef_search=64)
    r_ref = recall_at_k(i_ref, ti, 10)
    assert r_dev >= r_ref - 0.01, (r_dev, r_ref)
    assert r_dev >= 0.95
    same_search(got, _ref(host_index, wl.queries, 10, 64))


def test_exact_same_buffer_semantics(host_index, small_workload):
    wl = small_workload
    got = _search(host_index, wl.queries[:32], 5, 128)
    _, i_ref = host_index.search(wl.queries[:32], k=5, ef_search=128)
    agree = (got[1] == i_ref).mean()
    assert agree > 0.98, agree
    same_search(got, _ref(host_index, wl.queries[:32], 5, 128))


def test_true_l2_distances(host_index, small_workload):
    wl = small_workload
    d, i = _search(host_index, wl.queries[:16], 3, 64)
    for qi in range(16):
        for j in range(3):
            if i[qi, j] >= 0:
                expect = ((wl.base[i[qi, j]] - wl.queries[qi]) ** 2).sum()
                np.testing.assert_allclose(d[qi, j], expect, rtol=1e-3,
                                           atol=1e-3)


def test_ip_device(host_ip_index, small_ip_workload):
    wl = small_ip_workload
    got = _search(host_ip_index, wl.queries, 10, 64)
    _, ti = exact_knn(wl.base, wl.queries, 10, "ip")
    assert recall_at_k(got[1], ti, 10) >= 0.9
    same_search(got, _ref(host_ip_index, wl.queries, 10, 64))


@pytest.mark.parametrize("n_expand", [2, 4])
def test_n_expand_recall(host_index, small_workload, n_expand):
    wl = small_workload
    _, ti = exact_knn(wl.base, wl.queries, 10, "l2")
    _, i1 = _search(host_index, wl.queries, 10, 64, n_expand=1)
    got = _search(host_index, wl.queries, 10, 64, n_expand=n_expand)
    r1 = recall_at_k(i1, ti, 10)
    rN = recall_at_k(got[1], ti, 10)
    assert rN >= r1 - 0.02, (r1, rN)
    same_search(got, _ref(host_index, wl.queries, 10, 64, n_expand=n_expand))


def test_stats(host_index, small_workload):
    wl = small_workload
    d, i, stats = _search(host_index, wl.queries[:8], 5, 32,
                          with_stats=True)
    assert int(stats.hops) > 0
    assert (stats.ndis.numpy() > 0).all()
    _, _, rst = _ref(host_index, wl.queries[:8], 5, 32, with_stats=True)
    assert int(stats.hops) == int(rst.hops)
    np.testing.assert_array_equal(stats.ndis.numpy(), np.asarray(rst.ndis))


def test_hop_cap_is_generous(host_index, small_workload):
    wl = small_workload
    _, _, stats = _search(host_index, wl.queries, 10, 64, with_stats=True)
    assert int(stats.hops) < 4 * 64 + 16


def test_ef_bucket_width_independence(host_index, small_workload,
                                      monkeypatch):
    """ef is a runtime value: the same ef gives identical results in the
    64-wide bucket and in a 128-wide one."""
    q = small_workload.queries[:32]
    d1, i1 = _search(host_index, q, 10, 48)
    monkeypatch.setattr(port_search, "ef_bucket", lambda ef: 128)
    d2, i2 = _search(host_index, q, 10, 48)
    assert np.array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)
