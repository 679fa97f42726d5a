"""The port's query path (hnsw_tpu_torch.search.hnsw_search) against the
reference's fused path on the SAME graph and queries: conftest's
NumPy-built graphs, unpacked and packed 8-bit, on the CPU. The reference
runs its Pallas kernels in interpret mode (HNSW_TPU_BEAM_KERNEL=1), as its
own tests do; the port runs its kernels' plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_tpu.ops.packed import pack_neighbors as ref_pack
from hnsw_tpu.search import compute_sqnorms as ref_sqnorms
from hnsw_tpu.search import hnsw_search as ref_search
from hnsw_tpu.utils.recall import recall_at_k
from hnsw_tpu_torch.graph import graph_from_numpy
from hnsw_tpu_torch.ops.packed import pack_neighbors
from hnsw_tpu_torch.search import ef_bucket, entry_sample_size, hnsw_search

from conftest import exact_knn


def _both(index, monkeypatch):
    """(reference graph + vectors, port graph + vectors) of a NumpyHnsw."""
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    g = index.to_graph_arrays()
    return (g, jnp.asarray(index.vectors),
            graph_from_numpy(g, "cpu"), torch.from_numpy(index.vectors))


def _assert_same_search(ref, got, gt, k):
    """ids equal in >= 99% of positions, distances of matched ids within
    rtol 1e-5 (f32 sums in another order), recall within 0.005, hops
    equal, and the distance count within 0.5% (a quantized routing near-tie
    may resolve the other way)."""
    (rd, ri, rst), (d, i, st) = ref, got
    rd, ri = np.asarray(rd), np.asarray(ri)
    d, i = d.numpy(), i.numpy()
    same = i == ri
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(d[same], rd[same], rtol=1e-5, atol=1e-5)
    assert abs(recall_at_k(i, gt, k) - recall_at_k(ri, gt, k)) <= 0.005
    assert st.hops == int(rst.hops)
    ndis, rndis = int(st.ndis.sum()), int(np.asarray(rst.ndis).sum())
    assert abs(ndis - rndis) <= 0.005 * rndis, (ndis, rndis)


@pytest.mark.parametrize("packed,entry_mode", [(False, "sample"),
                                               (True, "sample"),
                                               (False, "descend"),
                                               (True, "seed")])
def test_search_matches_reference(host_index, small_workload, monkeypatch,
                                  packed, entry_mode):
    g, v, tg, tv = _both(host_index, monkeypatch)
    wl, k, ef = small_workload, 10, 48
    _, gt = exact_knn(wl.base, wl.queries, k, "l2")
    rp = tp = None
    if packed:
        rp = ref_pack(g.neighbors0, v, g.levels, bits=8,
                      n_rows=host_index.ntotal)
        tp = pack_neighbors(tg.neighbors0, tv, tg.levels, bits=8,
                            n_rows=host_index.ntotal)
    ref = ref_search(g, v, ref_sqnorms(v), jnp.asarray(wl.queries), k=k,
                     ef_search=ef, metric="l2", with_stats=True, packed=rp,
                     entry_mode=entry_mode)
    got = hnsw_search(tg, tv, torch.from_numpy(wl.queries), k=k,
                      ef_search=ef, metric="l2", with_stats=True, packed=tp,
                      entry_mode=entry_mode)
    _assert_same_search(ref, got, gt, k)


def test_search_matches_reference_ip(host_ip_index, small_ip_workload,
                                     monkeypatch):
    g, v, tg, tv = _both(host_ip_index, monkeypatch)
    wl, k = small_ip_workload, 10
    _, gt = exact_knn(wl.base, wl.queries, k, "ip")
    ref = ref_search(g, v, ref_sqnorms(v), jnp.asarray(wl.queries), k=k,
                     ef_search=64, metric="ip", with_stats=True)
    got = hnsw_search(tg, tv, torch.from_numpy(wl.queries), k=k,
                      ef_search=64, metric="ip", with_stats=True)
    _assert_same_search(ref, got, gt, k)


@pytest.mark.parametrize("bits", [8, 4])
def test_pack_neighbors_byte_identical(host_index, bits):
    """Packing is integer math on the same min/max affine: the code tables
    must be byte-identical and the norms equal to f32 rounding."""
    g = host_index.to_graph_arrays()
    v = host_index.vectors
    n = host_index.ntotal
    ref = ref_pack(g.neighbors0, jnp.asarray(v), g.levels, bits=bits,
                   n_rows=n)
    got = pack_neighbors(torch.tensor(np.asarray(g.neighbors0)),
                         torch.from_numpy(v),
                         torch.tensor(np.asarray(g.levels)), bits=bits,
                         n_rows=n)
    np.testing.assert_array_equal(got.nbr_codes.numpy(),
                                  np.asarray(ref.nbr_codes)[:n])
    np.testing.assert_array_equal(got.offset.numpy(), np.asarray(ref.offset))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_allclose(got.nbr_sq.numpy(),
                               np.asarray(ref.nbr_sq)[:n], rtol=1e-6)
    assert got.bits_for(32, 16) == bits


def test_pack_neighbors_budget_and_unported_layout(host_index):
    g = host_index.to_graph_arrays()
    args = (torch.tensor(np.asarray(g.neighbors0)),
            torch.from_numpy(host_index.vectors),
            torch.tensor(np.asarray(g.levels)))
    with pytest.raises(ValueError, match="budget"):
        pack_neighbors(*args, bits=8, max_bytes=1000)
    with pytest.raises(NotImplementedError, match="words"):
        pack_neighbors(*args, bits=8, layout="words")


def test_unported_search_options_raise(host_index, small_workload,
                                       monkeypatch):
    _, _, tg, tv = _both(host_index, monkeypatch)
    q = torch.from_numpy(small_workload.queries[:4])
    for kw in ({"allowed": np.ones(2048, bool)}, {"n_expand": 2},
               {"visited_mode": "bitmap"}):
        with pytest.raises(NotImplementedError):
            hnsw_search(tg, tv, q, k=5, ef_search=32, **kw)


def test_static_sizes_match_reference():
    from hnsw_tpu.search import ef_bucket as ref_bucket
    from hnsw_tpu.search import entry_sample_size as ref_sample
    for ef in (1, 10, 32, 33, 64, 100, 512, 513):
        assert ef_bucket(ef) == ref_bucket(ef)
    for cap in (64, 2048, 100_000, 1_000_000, 10_000_000):
        assert entry_sample_size(cap) == ref_sample(cap)
