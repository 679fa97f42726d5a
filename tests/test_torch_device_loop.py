"""The search's loops with their conditions on the device (``graphs.py``,
``ops/beam.py``, ``search.py``), on the CPU.

  * every loop form returns the reference's ids, distances, ``hops`` and
    ``ndis`` on one shared graph, within the search parity tolerances
    (ids >= 99% equal, distances within rtol 1e-5 where they agree, a
    0.5% difference in total ndis for near-ties);
  * the same search read once a chunk of ``LOOP_CHUNK`` steps and read
    once a step returns exactly the same;
  * a search reads the card only through ``graphs.host_read``, at most
    ceil(hops / H) + ceil(descent steps / H) + 2 times;
  * steps past a loop's condition change nothing;
  * padded query rows come back empty and leave the real rows as they
    were;
  * the capture key follows the index tensors' identity, and
    ``HnswIndex.n_deleted`` is a host count equal to the tombstone mask's.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hnsw_tpu
import hnsw_tpu_torch
from hnsw_tpu.search import compute_sqnorms
from hnsw_tpu.search import hnsw_search as ref_search
from hnsw_tpu_torch import graphs, trace
from hnsw_tpu_torch import search as port_search
from hnsw_tpu_torch.graph import graph_from_numpy
from hnsw_tpu_torch.ops.storage import Storage
from hnsw_tpu_torch.utils.datasets import synthetic_workload

from torch_threads import one_torch_thread  # noqa: F401  (a fixture)

K = 10


@pytest.fixture(scope="module")
def shared(host_index, small_workload):
    """conftest's NumPy-built graph as the port's tensors and storage and
    the reference's arrays, and the queries."""
    g = host_index.to_graph_arrays()
    v = jnp.asarray(host_index.vectors)
    return (graph_from_numpy(g, "cpu"),
            Storage(torch.from_numpy(host_index.vectors)),
            g, v, compute_sqnorms(v), small_workload.queries)


def even_mask(n):
    return np.arange(n) % 2 == 0


# (keywords of both searches, environment of the reference's search)
CASES = {
    "fused": (dict(ef_search=48), {}),
    "fused_full_bucket": (dict(ef_search=64), {}),
    "max_hops_positive": (dict(ef_search=48, max_hops=7), {}),
    "max_hops_negative": (dict(ef_search=48, max_hops=-1), {}),
    "descend": (dict(ef_search=48, entry_mode="descend"), {}),
    # the fused beam's multi-seed buffer: the reference's fused beam
    # (its kernel in interpret mode)
    "seed": (dict(ef_search=64, entry_mode="seed"),
             {"HNSW_TPU_BEAM_KERNEL": "1"}),
    "filtered": (dict(ef_search=48, allowed="even"), {}),
    "n_expand_2": (dict(ef_search=48, n_expand=2), {}),
    "bitmap": (dict(ef_search=48, visited_mode="bitmap"), {}),
}


def port_kw(kw, n):
    """A case's keywords for the port: the "even" filter as a mask."""
    if kw.get("allowed") == "even":
        return {**kw, "allowed": torch.from_numpy(even_mask(n))}
    return kw


def port_run(shared, kw, queries=None):
    tg, tv, *_, q = shared
    d, i, st = port_search.hnsw_search(
        tg, tv, torch.from_numpy(q if queries is None else queries), k=K,
        metric="l2", max_level_cap=6, with_stats=True,
        **port_kw(kw, tv.rows.shape[0]))
    return d.numpy(), i.numpy(), st.hops, st.ndis.numpy()


def assert_same_run(a, b):
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])
    assert a[2] == b[2]
    np.testing.assert_array_equal(a[3], b[3])


@pytest.mark.parametrize("case", list(CASES))
def test_loop_forms_match_reference(shared, case, monkeypatch):
    kw, env = CASES[case]
    got = port_run(shared, kw)
    _, tv, g, v, sq, q = shared
    rkw = dict(kw)
    if rkw.get("allowed") == "even":
        rkw["allowed"] = jnp.asarray(even_mask(tv.rows.shape[0]))
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    rd, ri, rst = ref_search(g, v, sq, jnp.asarray(q), k=K, metric="l2",
                             max_level_cap=6, with_stats=True, **rkw)
    rd, ri = np.asarray(rd), np.asarray(ri)
    same = got[1] == ri
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(got[0][same], rd[same], rtol=1e-5, atol=1e-5)
    assert got[2] == int(rst.hops), (got[2], int(rst.hops))
    ndis, rndis = int(got[3].sum()), int(np.asarray(rst.ndis).sum())
    assert abs(ndis - rndis) <= 0.005 * rndis, (ndis, rndis)
    if "allowed" in kw:
        assert even_mask(tv.rows.shape[0])[got[1][got[1] >= 0]].all()


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_reads_equal_one_read_a_step(shared, case, monkeypatch):
    kw, _ = CASES[case]
    monkeypatch.setattr(graphs, "LOOP_CHUNK", 16)
    chunked = port_run(shared, kw)
    monkeypatch.setattr(graphs, "LOOP_CHUNK", 1)
    assert_same_run(chunked, port_run(shared, kw))


def counting_loops(monkeypatch):
    """Patch EagerLoop.run to count, per loop, the steps taken while the
    condition held (the reference's iterations); returns the list."""
    counts = []
    orig = graphs.EagerLoop.run

    def run(self, cond, step, state, bound=None):
        n = [0]

        def counted(s):
            n[0] += bool(cond(s))
            return step(s)

        out = orig(self, cond, counted, state, bound)
        counts.append(n[0])
        return out

    monkeypatch.setattr(graphs.EagerLoop, "run", run)
    return counts


def host_reads() -> int:
    return trace.totals().counters.get("host_reads", 0)


@pytest.mark.parametrize("case", ["fused", "descend", "filtered",
                                  "max_hops_negative"])
def test_reads_a_search(shared, case, monkeypatch):
    """The search reads the card only through graphs.host_read (every other
    way a tensor reaches the host raises inside it), at most ceil(hops /
    H) + ceil(steps / H) + 2 times; the loops' own iteration counts are
    the reference's (hops equals the stats')."""
    kw, _ = CASES[case]
    h = graphs.LOOP_CHUNK
    assert h >= 16
    inside = [False]
    orig_read = graphs.host_read

    def read(t):
        inside[0] = True
        try:
            return orig_read(t)
        finally:
            inside[0] = False

    def forbid(m, name):
        orig = getattr(torch.Tensor, name)

        def guarded(self, *a, **k):
            if not inside[0]:
                raise AssertionError(f"a host read by Tensor.{name}")
            return orig(self, *a, **k)

        m.setattr(torch.Tensor, name, guarded)

    with monkeypatch.context() as m:
        m.setattr(graphs, "host_read", read)
        for name in ("item", "__bool__", "__int__", "__float__",
                     "__index__", "tolist", "numpy", "__array__"):
            forbid(m, name)
        before = host_reads()
        d, i, st = port_search.hnsw_search(
            shared[0], shared[1], torch.from_numpy(shared[5]), k=K,
            metric="l2", max_level_cap=6, with_stats=True,
            **port_kw(kw, shared[1].rows.shape[0]))
        reads = host_reads() - before
    counts = counting_loops(monkeypatch)
    port_run(shared, kw)
    hops = counts[-1]
    steps = counts[0] if len(counts) == 2 else 0
    assert hops == st.hops
    assert reads <= math.ceil(hops / h) + math.ceil(steps / h) + 2, \
        (reads, hops, steps)


class Overrun(graphs.EagerLoop):
    """A loop runner that reads once a step and then takes 40 more steps
    past the end of the loop."""

    def __init__(self, chunk=None, phases=None):
        super().__init__(1, phases)

    def run(self, cond, step, state, bound=None):
        state = graphs.EagerLoop(1).run(cond, step, state, None)
        for _ in range(40):
            state = step(state)
        return state


@pytest.mark.parametrize("case", ["fused", "max_hops_positive", "descend",
                                  "filtered", "n_expand_2", "bitmap"])
def test_steps_past_the_condition_change_nothing(shared, case, monkeypatch):
    """Fused (stopped by convergence or by the hop cap, where K1 alone
    would go on expanding), the descent and the legacy beam (filtered,
    two expansions, the bitmap updated in place): 40 masked steps after
    each loop leave the result, hops and ndis as they were."""
    kw, _ = CASES[case]
    want = port_run(shared, kw)
    monkeypatch.setattr(port_search, "EagerLoop", Overrun)
    assert_same_run(port_run(shared, kw), want)


@pytest.mark.parametrize("case", ["fused", "descend", "filtered", "seed"])
def test_padded_rows_come_back_empty(shared, case, monkeypatch):
    kw, _ = CASES[case]
    q = shared[5][:100]
    want = port_run(shared, kw, q)
    monkeypatch.setattr(graphs, "CPU_Q_ALIGN", 64)
    assert graphs.padded_rows(100, torch.device("cpu")) == 128
    assert_same_run(port_run(shared, kw, q), want)
    graph, storage = shared[0], shared[1]
    st, _, _, inputs = port_search._plan(
        graph, storage, torch.from_numpy(q), k=K,
        **port_kw(kw, storage.rows.shape[0]))
    out = port_search._search_body(inputs, graphs.EagerLoop(), st, graph,
                                   storage, None)
    assert (out["i"][100:] == -1).all() and (out["ndis"][100:] == 0).all()
    assert torch.isinf(out["d"][100:]).all()


@pytest.fixture(scope="module")
def wl():
    return synthetic_workload(1500, 16, n_queries=64, metric="l2", seed=5)


def small_index(wl, n=1200, **kw):
    idx = hnsw_tpu_torch.HnswIndex(16, 8, "l2", capacity=2048,
                                   ef_construction=40, device="cpu", **kw)
    idx.train(wl.base)
    idx.add(wl.base[:n])
    return idx


def key_of(idx, wl, **kw):
    g, v, q, skw = idx._search_call(wl.queries, K,
                                    **{"packed": idx._packed, **kw})
    return port_search.search_key(g, v, q, **skw)


def test_pq_storage_descends_as_the_reference(wl, monkeypatch):
    """PQ storage always descends: its loop and the fused beam over ADC
    distances against the reference's fused beam (its kernel in interpret
    mode) on the same codes."""
    idx = small_index(wl, dtype="pq", pq_m=8, n=1500)
    ref = hnsw_tpu.HnswIndex.from_bytes(idx.to_bytes())
    for h in (16, 1):
        graphs.LOOP_CHUNK, before = h, graphs.LOOP_CHUNK
        try:
            got = idx.search(wl.queries, K, ef_search=48, with_stats=True)
        finally:
            graphs.LOOP_CHUNK = before
        if h == 16:
            first = got
    assert_same_run((first[0], first[1], first[2].hops, first[2].ndis),
                    (got[0], got[1], got[2].hops, got[2].ndis))
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    rd, ri, rst = ref.search(wl.queries, K, ef_search=48, with_stats=True)
    same = got[1] == np.asarray(ri)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(got[0][same], np.asarray(rd)[same],
                               rtol=1e-5, atol=1e-4)
    assert got[2].hops == int(rst.hops)
    ndis, rndis = int(got[2].ndis.sum()), int(np.asarray(rst.ndis).sum())
    assert abs(ndis - rndis) <= 0.005 * rndis, (ndis, rndis)


def test_capture_key_follows_index_identity(wl):
    idx = small_index(wl)
    k0 = key_of(idx, wl)
    idx.add(wl.base[1200:1300])               # into capacity: same tensors
    assert key_of(idx, wl) == k0
    assert key_of(idx, wl, ef_search=40) == key_of(idx, wl, ef_search=48)
    assert key_of(idx, wl, ef_search=40) != key_of(idx, wl, ef_search=64)
    idx.remove_ids(np.arange(0, 20))          # creates the tombstone mask
    k1 = key_of(idx, wl)
    assert k1 != k0
    idx.remove_ids(np.arange(20, 40))
    assert key_of(idx, wl) == k1
    assert key_of(idx, wl, allowed=np.arange(0, 1300, 3)) == k1
    idx.enable_packed(bits=8)
    k2 = key_of(idx, wl)
    assert k2 != k1
    idx.disable_packed()
    idx.enable_packed(bits=8, layout="words")
    assert key_of(idx, wl) not in (k1, k2)
    k3 = key_of(idx, wl)
    loaded = hnsw_tpu_torch.HnswIndex.from_bytes(idx.to_bytes(),
                                                 device="cpu")
    loaded.enable_packed(bits=8, layout="words")
    assert key_of(loaded, wl) != k3
    comp, _ = idx.compacted()
    assert key_of(comp, wl) != key_of(idx, wl, packed=None)
    idx.grow(4096)
    assert key_of(idx, wl) != k3


def test_n_deleted_is_kept_on_the_host(wl):
    idx = small_index(wl)

    def check(ix):
        want = 0 if ix._alive is None else \
            ix.ntotal - int(ix._alive[:ix.ntotal].sum())
        assert ix.n_deleted == want

    check(idx)
    assert idx.remove_ids(np.array([3, 3, 5, 7])) == 3
    check(idx)
    assert idx.remove_ids(np.array([5, 9])) == 1
    check(idx)
    idx.vacuum()
    check(idx)
    idx.grow(3000)
    check(idx)
    other = small_index(wl, n=300)
    other.remove_ids(np.arange(10))
    check(other)
    idx.merge_from(other)
    check(idx)
    assert idx.ntotal == 1200 + 290
    loaded = hnsw_tpu_torch.HnswIndex.from_bytes(idx.to_bytes(),
                                                 device="cpu")
    check(loaded)
    assert loaded.n_deleted == 4
    comp, _ = idx.compacted()
    check(comp)
    assert comp.n_deleted == 0
