"""The port's query path (hnsw_tpu_torch.search.hnsw_search) against the
reference's on the SAME graph and queries: conftest's NumPy-built graphs,
unpacked and packed 8-bit (bytes and words rows), on the CPU. The fused
path's reference runs its Pallas kernels in interpret mode
(HNSW_TPU_BEAM_KERNEL=1), as its own tests do; the legacy beam (n_expand
2, the bitmap visited set, filters, HNSW_TPU_PALLAS_HOP=1, bf16 / f32
merge keys) is the reference's multi-op loop whatever that variable says.
The port runs its kernels' plain versions."""

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


def _pack_both(g, v, tg, tv, n, layout, bits=8):
    if layout is None:
        return None, None
    return (ref_pack(g.neighbors0, v, g.levels, bits=bits, n_rows=n,
                     layout=layout),
            pack_neighbors(tg.neighbors0, tv, tg.levels, bits=bits, n_rows=n,
                           layout=layout))


# (packed layout, options) of the legacy beam, plus the fused words path.
# Packed routing merges in bf16 by default ("auto"), as does beam_keys
# "bf16": a bf16 near-tie or a quantized one may resolve the other way
# (f32 sums in another order before the rounding), which
# _assert_same_search allows for (ids >= 99% equal, ndis within 0.5%).
LEGACY_CASES = {
    "words-fused": ("words", {}),
    "n_expand2": (None, {"n_expand": 2}),
    "n_expand2-bytes": ("bytes", {"n_expand": 2}),
    "n_expand2-words": ("words", {"n_expand": 2}),
    "bitmap": (None, {"visited_mode": "bitmap"}),
    "bitmap-n_expand2": (None, {"visited_mode": "bitmap", "n_expand": 2}),
    "bf16-keys": (None, {"n_expand": 2, "beam_keys": "bf16"}),
    "f32-keys-bytes": ("bytes", {"n_expand": 2, "beam_keys": "f32"}),
}


@pytest.mark.parametrize("case", list(LEGACY_CASES))
def test_search_paths_match_reference(host_index, small_workload,
                                      monkeypatch, case):
    layout, kw = LEGACY_CASES[case]
    g, v, tg, tv = _both(host_index, monkeypatch)
    wl, k, ef = small_workload, 10, 48
    _, gt = exact_knn(wl.base, wl.queries, k, "l2")
    rp, tp = _pack_both(g, v, tg, tv, host_index.ntotal, layout)
    ref = ref_search(g, v, ref_sqnorms(v), jnp.asarray(wl.queries), k=k,
                     ef_search=ef, metric="l2", with_stats=True, packed=rp,
                     **kw)
    got = hnsw_search(tg, tv, torch.from_numpy(wl.queries), k=k,
                      ef_search=ef, metric="l2", with_stats=True, packed=tp,
                      **kw)
    _assert_same_search(ref, got, gt, k)


@pytest.mark.parametrize("layout,n_expand", [(None, 1), ("bytes", 2)])
def test_filtered_search_matches_reference(host_index, small_workload,
                                           monkeypatch, layout, n_expand):
    """allowed as a bool mask (a random third of the ids, and the even
    ids): only allowed ids come back, each once, as the reference's."""
    g, v, tg, tv = _both(host_index, monkeypatch)
    wl, k, ef = small_workload, 10, 48
    rp, tp = _pack_both(g, v, tg, tv, host_index.ntotal, layout)
    cap = tg.neighbors0.shape[0]
    rng = np.random.default_rng(n_expand)
    for allowed in (rng.random(cap) < 0.3, np.arange(cap) % 2 == 0):
        n_ok = min(int(allowed[:host_index.ntotal].sum()), len(wl.base))
        _, gt = exact_knn(wl.base[allowed[:len(wl.base)]], wl.queries, k,
                          "l2")
        gt = np.flatnonzero(allowed[:len(wl.base)])[gt]
        assert n_ok > k
        ref = ref_search(g, v, ref_sqnorms(v), jnp.asarray(wl.queries), k=k,
                         ef_search=ef, metric="l2", with_stats=True,
                         packed=rp, n_expand=n_expand,
                         allowed=jnp.asarray(allowed))
        got = hnsw_search(tg, tv, torch.from_numpy(wl.queries), k=k,
                          ef_search=ef, metric="l2", with_stats=True,
                          packed=tp, n_expand=n_expand,
                          allowed=torch.from_numpy(allowed))
        _assert_same_search(ref, got, gt, k)
        ids = got[1].numpy()
        assert allowed[ids[ids >= 0]].all()
        for row in ids:
            assert len(set(row[row >= 0])) == (row >= 0).sum()


def test_pallas_hop_search_matches_reference(host_index, small_workload,
                                             monkeypatch):
    """HNSW_TPU_PALLAS_HOP=1 on a 128-d zero-padded copy (the reference's
    kernel needs d % 128 == 0; the pad leaves every distance unchanged), as
    tests/test_hop_kernel.py runs it: the reference's K5 in interpret mode,
    the port's K5 plain version (any d). 96 queries: the reference's kernel
    also needs Q % 8 == 0."""
    import hnsw_tpu.ops.hop_kernel as hk
    g, v, tg, tv = _both(host_index, monkeypatch)
    wl, k, ef = small_workload, 10, 32
    queries = wl.queries[:96]
    _, gt = exact_knn(wl.base, queries, k, "l2")
    vp, qp = (np.pad(a, ((0, 0), (0, 96))) for a in (np.asarray(v),
                                                      queries))
    orig = hk.fused_gather_distances
    monkeypatch.setattr(hk, "fused_gather_distances",
                        lambda vec, ids, qs, metric="l2", interpret=False:
                        orig(vec, ids, qs, metric, interpret=True))
    monkeypatch.setenv("HNSW_TPU_PALLAS_HOP", "1")
    ref = ref_search(g, jnp.asarray(vp), ref_sqnorms(jnp.asarray(vp)),
                     jnp.asarray(qp), k=k, ef_search=ef, metric="l2",
                     with_stats=True)
    from hnsw_tpu_torch.ops import hop_kernel
    calls = []
    real = hop_kernel.fused_gather_distances
    monkeypatch.setattr("hnsw_tpu_torch.search.fused_gather_distances",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = hnsw_search(tg, torch.from_numpy(vp), torch.from_numpy(qp), k=k,
                      ef_search=ef, metric="l2", with_stats=True)
    _assert_same_search(ref, got, gt, k)
    assert len(calls) >= got[2].hops + 1   # the entry rescore and each hop


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
    """The max_bytes budget counts each layout's row bytes (words: 4 bytes
    a word, segments padded to word_width); a layout that does not exist
    raises."""
    g = host_index.to_graph_arrays()
    args = (torch.tensor(np.asarray(g.neighbors0)),
            torch.from_numpy(host_index.vectors),
            torch.tensor(np.asarray(g.levels)))
    n, m0, d = host_index.ntotal, g.neighbors0.shape[1], 32
    with pytest.raises(ValueError, match="budget"):
        pack_neighbors(*args, bits=8, max_bytes=1000)
    for layout, bits, row in (("bytes", 8, m0 * d), ("bytes", 4, m0 * 16),
                              ("words", 8, m0 * 8 * 4),
                              ("words", 4, m0 * 4 * 4)):
        need = n * row + n * m0 * 4
        with pytest.raises(ValueError, match="budget"):
            pack_neighbors(*args, bits=bits, n_rows=n, layout=layout,
                           max_bytes=need - 1)
        p = pack_neighbors(*args, bits=bits, n_rows=n, layout=layout,
                           max_bytes=need)
        assert p.layout == layout and p.nbytes == need + 2 * d * 4
    with pytest.raises(ValueError, match="layout"):
        pack_neighbors(*args, bits=8, layout="nibbles")


def test_unported_search_options_raise(host_index, small_workload,
                                       monkeypatch):
    """Every legacy option runs now; unknown option values raise, and so
    does what stays unported at the index level: add() with (PQ-coded)
    packed tables enabled, the host builder, and HNSW_TPU_PALLAS_HOP=1
    over bf16 storage (the port's K5 reads f32 rows)."""
    _, _, tg, tv = _both(host_index, monkeypatch)
    q = torch.from_numpy(small_workload.queries[:4])
    for kw in ({"visited_mode": "hash"}, {"beam_keys": "fp16"},
               {"entry_mode": "random"}):
        with pytest.raises(ValueError):
            hnsw_search(tg, tv, q, k=5, ef_search=32, **kw)
    import hnsw_tpu_torch
    base = small_workload.base
    idx = hnsw_tpu_torch.HnswIndex(32, 8, capacity=64, device="cpu")
    idx.add(base[:40])
    idx.enable_packed(mode="pq", pq_m=8, pq_bits=4, train_x=base)
    with pytest.raises(NotImplementedError, match="A4"):
        idx.add(base[40:41])
    with pytest.raises(NotImplementedError, match="A5"):
        hnsw_tpu_torch.HnswIndex(32, 8, capacity=64, build="host",
                                 device="cpu")
    bf = hnsw_tpu_torch.HnswIndex(32, 8, capacity=64, dtype="bfloat16",
                                  device="cpu")
    bf.add(base[:40])
    monkeypatch.setenv("HNSW_TPU_PALLAS_HOP", "1")
    with pytest.raises(NotImplementedError, match="K5"):
        bf.search(small_workload.queries[:4], 5)


def test_static_sizes_match_reference():
    from hnsw_tpu.search import ef_bucket as ref_bucket
    from hnsw_tpu.search import entry_sample_size as ref_sample
    for ef in (1, 10, 32, 33, 64, 100, 512, 513):
        assert ef_bucket(ef) == ref_bucket(ef)
    for cap in (64, 2048, 100_000, 1_000_000, 10_000_000):
        assert entry_sample_size(cap) == ref_sample(cap)
