"""Twins of tests/test_visited_modes.py on the port: the fast "buffer"
dedup is outcome-equivalent to the exact "bitmap" visited set (the
argument in ``ops/beam.py``), and each mode's result equals the
reference's on the same NumPy-built graph."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_tpu.search import compute_sqnorms
from hnsw_tpu.search import hnsw_search as ref_search
from hnsw_tpu_torch.graph import graph_from_numpy
from hnsw_tpu_torch.search import hnsw_search


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module (tests/test_torch_mutable.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _modes(host_index, queries, k, ef):
    """{mode: ((D, I) of the port, (D, I) of the reference)}."""
    g = host_index.to_graph_arrays()
    tg, tv = graph_from_numpy(g, "cpu"), torch.from_numpy(host_index.vectors)
    v = jnp.asarray(host_index.vectors)
    out = {}
    for mode in ("buffer", "bitmap"):
        d, i = hnsw_search(tg, tv, torch.from_numpy(queries), k=k,
                           ef_search=ef, metric="l2", max_level_cap=6,
                           visited_mode=mode)
        rd, ri = ref_search(g, v, compute_sqnorms(v), jnp.asarray(queries),
                            k=k, ef_search=ef, metric="l2", max_level_cap=6,
                            visited_mode=mode)
        out[mode] = ((d.numpy(), i.numpy()), (np.asarray(rd), np.asarray(ri)))
    return out


def _same(got, want, bar):
    same = got[1] == want[1]
    assert same.mean() >= bar, same.mean()
    np.testing.assert_allclose(got[0][same], want[0][same], rtol=1e-5,
                               atol=1e-5)


def test_buffer_equals_bitmap(host_index, small_workload):
    out = _modes(host_index, small_workload.queries, 10, 48)
    (buf, ref_buf), (bit, ref_bit) = out["buffer"], out["bitmap"]
    assert (buf[1] == bit[1]).mean() > 0.999
    np.testing.assert_allclose(buf[0], bit[0], rtol=1e-5, atol=1e-5)
    _same(buf, ref_buf, 0.99)
    _same(bit, ref_bit, 0.99)


def test_buffer_equals_bitmap_small_ef(host_index, small_workload):
    out = _modes(host_index, small_workload.queries[:40], 5, 8)
    (buf, ref_buf), (bit, ref_bit) = out["buffer"], out["bitmap"]
    assert (buf[1] == bit[1]).mean() > 0.99
    _same(buf, ref_buf, 0.99)
    _same(bit, ref_bit, 0.99)
