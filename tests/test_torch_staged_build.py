"""The port's staged build (hnsw_tpu_torch.build: the schedule staged on the
device once, every insert batch at a static padded shape, the back-link
repair at static shapes) against the reference's staged build
(hnsw_tpu.build ``_insert_batch_staged`` / ``_get_step`` / ``_get_scan``),
on the CPU, with the kernels' plain versions.

The shapes are the reference's tests/test_staged_build.py: d=16, M=8,
efConstruction=40, capacity 8,192, ``max_batch=128``. Every graph array,
every scalar and the stored vectors must be equal. The replayed form of the
same batches runs on the card only (tests/test_torch_cuda.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_tpu import HnswConfig as RefConfig
from hnsw_tpu import build as ref_build
from hnsw_tpu.graph import empty_graph as ref_empty_graph
from hnsw_tpu.ops.repair import apply_backlinks as ref_backlinks
from hnsw_tpu_torch import build, graphs, trace
from hnsw_tpu_torch.config import HnswConfig
from hnsw_tpu_torch.graph import SCALAR_FIELDS, TENSOR_FIELDS, empty_graph
from hnsw_tpu_torch.ops.repair import apply_backlinks
from hnsw_tpu_torch.ops.storage import Storage

from torch_threads import one_torch_thread  # noqa: F401  (a fixture)

CPU = torch.device("cpu")
D, M, EFC, CAP, MAX_BATCH, SEED = 16, 8, 40, 8192, 128, 9


def _points(n, seed=3):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def _sq8_params(x):
    lo, hi = x.min(0), x.max(0)
    return lo.astype(np.float32), ((hi - lo) / 255.0).astype(np.float32)


def _sq8_hat(x, off, sc):
    """x̂: what the index hands the builder for sq8 storage."""
    u = np.clip(np.round((x - off) / sc), 0, 255)
    return (off + sc * u).astype(np.float32)


def _pq_codebooks(m_sub=4, ksub=256, seed=5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(m_sub, ksub, D // m_sub)).astype(np.float32)


def _pq_hat(x, cb):
    m_sub, _, dsub = cb.shape
    xs = x.reshape(len(x), m_sub, dsub)
    d = ((xs[:, :, None, :] - cb[None]) ** 2).sum(-1)
    codes = d.argmin(-1)
    return np.concatenate([cb[j, codes[:, j]] for j in range(m_sub)], 1)


def _codec(dtype):
    """(config kwargs, sq_params, pq_cb, x -> x̂) of a storage dtype."""
    if dtype == "sq8":
        off, sc = _sq8_params(_points(4000, seed=1))
        return {}, (off, sc), None, lambda x: _sq8_hat(x, off, sc)
    if dtype == "pq":
        cb = _pq_codebooks()
        return {"pq_m": 4}, None, cb, lambda x: _pq_hat(x, cb)
    return {}, None, None, lambda x: x


def ref_staged(batches, dtype="float32", scan_chunk=4):
    """The reference's staged build of each array in ``batches`` in turn
    (one ``add()`` each): its graph (numpy dict) and vectors."""
    kw, sq, pq, _ = _codec(dtype)
    cfg = RefConfig(dim=D, m=M, capacity=CAP, ef_construction=EFC, seed=SEED,
                    dtype=dtype, **kw)
    b = ref_build.DeviceBuilder(cfg, max_batch=MAX_BATCH, sq_params=sq,
                                pq_cb=pq)
    b.SCAN_CHUNK = scan_chunk
    g = ref_empty_graph(cfg)
    width = cfg.pq_m if dtype == "pq" else D
    vec = jnp.zeros((CAP, width), jnp.dtype(cfg.storage_dtype))
    sqn = jnp.zeros((CAP,), jnp.float32)
    for x in batches:
        g, vec, sqn = b.add(g, vec, sqn, x)
    return {f: np.asarray(getattr(g, f)) for f in g._fields}, vec


def port_staged(batches, dtype="float32", scan_chunk=4):
    """The port's staged build of the same inputs: (graph, vectors,
    builder)."""
    kw, sq, pq, _ = _codec(dtype)
    cfg = HnswConfig(dim=D, m=M, capacity=CAP, ef_construction=EFC,
                     seed=SEED, dtype=dtype, **kw)
    b = build.DeviceBuilder(cfg, max_batch=MAX_BATCH)
    b.SCAN_CHUNK = scan_chunk
    g = empty_graph(cfg, CPU)
    width = cfg.pq_m if dtype == "pq" else D
    st = Storage(torch.zeros((CAP, width),
                             dtype=getattr(torch, cfg.storage_dtype)),
                 sq=sq, pq=pq)
    for x in batches:
        b.add(g, st, x)
    return g, st.rows, b


def assert_same_build(ref, port):
    (rg, rvec), (g, vec) = ref, port[:2]
    for f in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(g, f).numpy(), rg[f],
                                      err_msg=f)
    for f in SCALAR_FIELDS:
        assert getattr(g, f) == int(rg[f]), f
    if vec.dtype == torch.bfloat16:   # compare the bits
        np.testing.assert_array_equal(vec.view(torch.int16).numpy(),
                                      np.asarray(rvec).view(np.int16))
    else:
        np.testing.assert_array_equal(vec.numpy(), np.asarray(rvec))


def assert_written_once(g, n):
    """Ids 0..n-1 hold a level and a level-0 row; no other row is
    written; the upper maps agree with each other."""
    lv = g.levels.numpy()
    assert (lv[:n] >= 0).all() and (lv[n:] == -1).all()
    assert (g.neighbors0.numpy()[:n, 0] >= 0).all()
    assert (g.neighbors0.numpy()[n:] == -1).all()
    slot = g.upper_slot.numpy()[:n]
    up = np.flatnonzero(lv[:n] >= 1)
    np.testing.assert_array_equal(np.sort(slot[up]), np.arange(len(up)))
    np.testing.assert_array_equal(g.upper_node.numpy()[slot[up]], up)
    assert g.ntotal == n and g.n_upper == len(up)


@pytest.fixture(scope="module")
def ref_f32():
    """The reference's staged build of 1,200 points (its scan path: 4
    full 128-batches a dispatch, tests/test_staged_build.py)."""
    return ref_staged([_points(1200)])


@pytest.mark.parametrize("scan_chunk", [4, 10 ** 9])
def test_staged_build_matches_reference(ref_f32, scan_chunk):
    """Twin of tests/test_staged_build.py::test_scan_path_matches_stepwise:
    the port's staged build, with 4 full batches between two syncs or
    none, equals the reference's staged build array for array."""
    port = port_staged([_points(1200)], scan_chunk=scan_chunk)
    assert_same_build(ref_f32, port)
    assert_written_once(port[0], 1200)
    st = port[2].last_stats
    assert st["batches"] == st["eager"] > 0 and st["capture_ms"] == []


def test_second_add_matches_reference():
    """Two add()s: the second plans and stages on a built graph."""
    x = _points(900, seed=4)
    ref = ref_staged([x[:500], x[500:]])
    port = port_staged([x[:500], x[500:]])
    assert_same_build(ref, port)
    assert_written_once(port[0], 900)


@pytest.mark.parametrize("dtype", ["sq8", "bfloat16", "pq"])
def test_codec_staged_build_matches_reference(dtype):
    """sq8 (one quantizer in both), bf16 rows, and PQ on codebooks carried
    across: the builder sees x̂ and stores its codes."""
    x = _codec(dtype)[3](_points(700, seed=6))
    ref = ref_staged([x], dtype=dtype)
    port = port_staged([x], dtype=dtype)
    assert_same_build(ref, port)
    assert_written_once(port[0], 700)


def test_forced_spill_matches_reference(monkeypatch):
    """``upper_batch_cap`` patched to 2 in both packages: a batch spills
    its tail once it holds 2 level>=1 points, and the upper levels run on
    the first 2 rows of every padded batch."""
    for mod in (ref_build, build):
        monkeypatch.setattr(mod, "upper_batch_cap", lambda size, m: 2)
    x = _points(600, seed=7)
    ref = ref_staged([x])
    port = port_staged([x])
    assert_same_build(ref, port)
    assert_written_once(port[0], 600)
    # ~1 point in 8 has a level >= 1: unpatched, 600 points take 8 batches
    assert port[2].last_stats["batches"] > 20


# ------------------------------------------------ the static back-link pass
def _backlink_case(codec, mode, seed):
    """Rows pre-filled to random widths, pairs overflowing rows (prune),
    sources already linked, one source to many rows and a few exact
    duplicate pairs, a hub past the R-window, invalid pairs (none, some or
    all), and the largest destination row last in sorted order (the tail
    group)."""
    rng = np.random.default_rng(seed)
    n, w, r, p = 60, 6, 4, 96
    adj = np.full((n, w), -1, np.int32)
    for i in range(n):
        kk = rng.integers(0, w + 1)
        adj[i, :kk] = rng.choice(np.delete(np.arange(n), i), size=kk,
                                 replace=False)
    dst = rng.integers(0, n - 1, size=p).astype(np.int32)
    dst[:10] = 7                          # a hub: 10 > R sources
    dst[-3:] = n - 1                      # the tail group
    src = rng.integers(0, n, size=p).astype(np.int32)
    src[20:26] = 11                       # one source, many rows
    src[30:34] = adj[dst[30:34], 0]       # already linked (or -1)
    dst[40:42], src[40:42] = 3, 5         # an exact duplicate pair
    valid = {"all": np.ones(p, bool), "some": rng.random(p) < 0.8,
             "none": np.zeros(p, bool)}[mode] & (dst != src) & (src >= 0)
    x = rng.normal(size=(n, D)).astype(np.float32)
    dequant = pq = None
    if codec == "sq8":
        off, sc = _sq8_params(x)
        vectors = np.clip(np.round((x - off) / sc), 0, 255).astype(np.uint8)
        dequant = (off, sc)
    elif codec == "pq":
        pq = _pq_codebooks(ksub=16, seed=seed)
        xs = x.reshape(n, 4, D // 4)
        vectors = ((xs[:, :, None, :] - pq[None]) ** 2).sum(-1).argmin(
            -1).astype(np.uint8)
    else:
        vectors = x
    return adj, dst, src, valid, vectors, dequant, pq, r


@pytest.mark.parametrize("mode", ["all", "some", "none"])
@pytest.mark.parametrize("codec", ["float32", "sq8", "pq"])
def test_static_backlinks_match_reference(codec, mode):
    """The static pass returns the reference's rows and drop count, bit
    for bit."""
    _backlinks_match_reference(codec, mode, "l2")


@pytest.mark.parametrize("mode", ["all", "some", "none"])
@pytest.mark.parametrize("codec", ["float32", "sq8", "pq"])
def test_static_backlinks_match_reference_ip(codec, mode):
    """The same under the inner-product metric, whose prune ranks the
    candidates by -dot: the reference's rows and drop count, bit for
    bit."""
    _backlinks_match_reference(codec, mode, "ip")


def _backlinks_match_reference(codec, mode, metric):
    drops = []
    for seed in range(3):
        adj, dst, src, valid, vectors, dequant, pq, r = _backlink_case(
            codec, mode, seed)

        def opt(a, conv):
            return None if a is None else conv(a)

        r_adj, r_drop = ref_backlinks(
            jnp.asarray(adj), jnp.asarray(dst), jnp.asarray(dst),
            jnp.asarray(src), jnp.asarray(valid), jnp.asarray(vectors),
            opt(dequant, lambda t: tuple(jnp.asarray(a) for a in t)),
            opt(pq, jnp.asarray), r_window=r, metric=metric)
        got, drop = apply_backlinks(
            torch.from_numpy(adj.copy()), torch.from_numpy(dst),
            torch.from_numpy(dst), torch.from_numpy(src),
            torch.from_numpy(valid),
            Storage(torch.from_numpy(vectors), sq=dequant, pq=pq),
            r_window=r, metric=metric)
        np.testing.assert_array_equal(got.numpy(), np.asarray(r_adj))
        assert int(drop) == int(r_drop)
        drops.append(int(drop))
        if mode == "none":
            np.testing.assert_array_equal(got.numpy(), adj)
    assert (min(drops) > 0) == (mode != "none")


# ------------------------------------------------------- reads of the card
def test_host_reads_per_batch(monkeypatch):
    """The design's host reads: inside a batch, one read of the descent's
    condition per ``DESCENT_CHUNK`` steps and nothing else (no
    ``.item()``, ``bool()``, ``int()``, ``tolist()`` or ``nonzero``
    outside ``graphs.host_read``); one read per ``add()`` of the batch and
    drop counters."""
    counts = {"other": 0, "nonzero": 0}
    exempt = [0]
    originals = {}

    def counting(name):
        orig = getattr(torch.Tensor, name)
        originals[name] = orig

        def f(self, *a, **k):
            if not exempt[0]:
                counts["other"] += 1
            return orig(self, *a, **k)
        return f

    for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "__index__"):
        monkeypatch.setattr(torch.Tensor, name, counting(name))
    orig_nonzero = torch.nonzero

    def nonzero(*a, **k):
        counts["nonzero"] += 1
        return orig_nonzero(*a, **k)
    monkeypatch.setattr(torch, "nonzero", nonzero)

    orig_read = graphs.host_read

    def host_read(t):
        exempt[0] += 1
        try:
            return orig_read(t)
        finally:
            exempt[0] -= 1
    monkeypatch.setattr(graphs, "host_read", host_read)

    loops = []                  # (steps the condition held, chunk)
    orig_run = graphs.EagerLoop.run

    def run(self, cond, step, state, bound=None):
        live = [0]

        def counted(s):
            exempt[0] += 1
            live[0] += int(cond(s))
            exempt[0] -= 1
            return step(s)
        out = orig_run(self, cond, counted, state, bound)
        loops.append((live[0], self.chunk))
        return out
    monkeypatch.setattr(graphs.EagerLoop, "run", run)

    before = trace.totals().counters.get("host_reads", 0)
    g, _, b = port_staged([_points(1200)])
    reads = trace.totals().counters.get("host_reads", 0) - before
    assert counts == {"other": 0, "nonzero": 0}
    assert loops and all(c == build.DESCENT_CHUNK for _, c in loops)
    # one descent a batch once the graph has an upper level
    assert len(loops) <= b.last_stats["batches"]
    assert reads == 1 + sum(max(1, math.ceil(n / c)) for n, c in loops)
    assert_written_once(g, 1200)
