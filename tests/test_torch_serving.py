"""The port's serving front end (hnsw_tpu_torch/serving.py: size buckets,
request coalescing, handles) against the reference's hnsw_tpu/serving.py,
on the CPU. Twins of tests/test_serving.py, and the two front ends over the
same graph (the port's save loaded by the reference)."""

import numpy as np
import pytest

import hnsw_tpu
import hnsw_tpu_torch
from hnsw_tpu.serving import Searcher as RefSearcher
from hnsw_tpu.serving import size_bucket as ref_size_bucket
from hnsw_tpu_torch.serving import Searcher, size_bucket

from conftest import exact_knn
from torch_threads import one_torch_thread  # noqa: F401  (a fixture)


@pytest.fixture(scope="module")
def served():
    wl = hnsw_tpu_torch.synthetic_workload(2000, 16, n_queries=200, seed=41)
    idx = hnsw_tpu_torch.HnswIndex(16, 8, "l2", capacity=2048,
                                   ef_construction=60, device="cpu")
    idx.add(wl.base)
    return idx, wl


def test_size_bucket():
    assert size_bucket(1) == 64
    assert size_bucket(64) == 64
    assert size_bucket(65) == 128
    assert size_bucket(8192) == 8192
    assert size_bucket(100_000) == 8192   # clamped; search() chunks
    for n in (0, 1, 2, 63, 64, 65, 1000, 4097, 8191, 8193, 10 ** 6):
        for lo, hi in ((64, 8192), (1, 128), (16, 16)):
            assert size_bucket(n, lo, hi) == ref_size_bucket(n, lo, hi)


def test_direct_search_any_size(served):
    idx, wl = served
    s = Searcher(idx, k=10, ef_search=96, min_bucket=64, max_bucket=128)
    q = wl.queries
    _, gt = exact_knn(wl.base, q, 10, "l2")
    _, i1 = s.search(q[0])                           # one 1-d query
    assert i1.shape == (1, 10)
    _, i = s.search(q[:77])
    assert i.shape == (77, 10)
    _, iall = s.search(q)                            # 200 > 128: 2 chunks
    assert iall.shape == (200, 10) and iall.dtype == np.int64
    assert (iall[:, :, None] == gt[:, None, :]).any(-1).mean() >= 0.9
    # padding never leaks: row r of a padded batch equals a solo search
    _, i_solo = s.search(q[76])
    np.testing.assert_array_equal(i_solo[0], i[76])
    assert s.stats["launches"] >= 4
    assert s.stats["queries_served"] == 1 + 77 + 200 + 1
    # and equals the index's own search of the same rows
    np.testing.assert_array_equal(iall, idx.search(q, 10, ef_search=96)[1])


def test_coalescing_handles(served):
    idx, wl = served
    s = Searcher(idx, k=5, ef_search=64, min_bucket=64, max_bucket=8192)
    q = wl.queries
    h1, h2, h3 = s.submit(q[:3]), s.submit(q[3:10]), s.submit(q[10])
    assert s.stats["launches"] == 0              # nothing searched yet
    d1, i1 = s.result(h1)                        # one flush for all three
    assert s.stats["launches"] == 1
    _, i2 = s.result(h2)
    _, i3 = s.result(h3)
    assert i1.shape == (3, 5) and i2.shape == (7, 5) and i3.shape == (1, 5)
    _, ii = s.search(q[:10])
    np.testing.assert_array_equal(np.concatenate([i1, i2]), ii)
    np.testing.assert_array_equal(i3[0], s.search(q[10])[1][0])


def test_device_out_fallback(served):
    """An index whose search() takes no device_out: the first chunk's
    TypeError downgrades the Searcher once, with the same results."""
    idx, wl = served

    class NoDeviceOut:
        def search(self, x, k, *, ef_search=None):
            return idx.search(x, k, ef_search=ef_search)

    s = Searcher(NoDeviceOut(), k=10, ef_search=96, min_bucket=64,
                 max_bucket=128)
    _, i = s.search(wl.queries)
    assert not s._device_out
    _, i_ref = Searcher(idx, k=10, ef_search=96, min_bucket=64,
                        max_bucket=128).search(wl.queries)
    np.testing.assert_array_equal(i, i_ref)


def test_auto_flush_at_max_bucket(served):
    idx, wl = served
    s = Searcher(idx, k=5, ef_search=64, min_bucket=64, max_bucket=64)
    hs = [s.submit(wl.queries[j * 16:(j + 1) * 16]) for j in range(4)]
    assert s.stats["launches"] == 1              # 64 rows: flushed
    for h in hs:
        assert s.result(h)[1].shape == (16, 5)


def test_searcher_matches_reference(served, monkeypatch):
    """Both front ends over the same graph (the port's save loaded by the
    reference; its K1 in interpret mode): direct requests of several sizes
    and a coalesced flush give the same counters and ids (>= 99% equal, the
    bar the search parity tests hold; distances within rtol 1e-5 where the
    ids agree)."""
    idx, wl = served
    ref = hnsw_tpu.HnswIndex.from_bytes(idx.to_bytes())
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    kw = dict(k=10, ef_search=64, min_bucket=32, max_bucket=128)
    port_s, ref_s = Searcher(idx, **kw), RefSearcher(ref, **kw)
    q = wl.queries
    for rows in (q[:1], q[:45], q[:200]):
        d, i = port_s.search(rows)
        rd, ri = ref_s.search(rows)
        same = i == ri
        assert same.mean() >= 0.99, (len(rows), same.mean())
        np.testing.assert_allclose(d[same], rd[same], rtol=1e-5, atol=1e-5)
    sizes = (3, 20, 9, 30)
    starts = np.cumsum((0,) + sizes)
    hp = [port_s.submit(q[a:a + n]) for a, n in zip(starts, sizes)]
    hr = [ref_s.submit(q[a:a + n]) for a, n in zip(starts, sizes)]
    port_s.flush()
    ref_s.flush()
    for a, b in zip(hp, hr):
        same = port_s.result(a)[1] == ref_s.result(b)[1]
        assert same.mean() >= 0.99
    assert port_s.stats == ref_s.stats
