"""The sampled entry scan (``_sample_seeds``) and K6's wrapper
(``ops/entry_kernel.py``) on the CPU: the wrapper's plain path returns what
the scan composed of PyTorch ops returned before K6 (the old
``_sample_seeds`` body, kept below as ``composed_sample_seeds``) bit for
bit and the reference's ``hnsw_tpu.search._sample_seeds`` up to near-ties,
a search counts which path its scan took, and the wrapper refuses what the
kernel does not take. K6 itself is held to the plain version on the card in
tests/test_torch_cuda.py."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hnsw_tpu.search import _sample_seeds as ref_sample_seeds

from hnsw_tpu_torch import search, trace
from hnsw_tpu_torch.config import IP, L2
from hnsw_tpu_torch.ops import entry_kernel
from hnsw_tpu_torch.ops.distances import decode_rows
from hnsw_tpu_torch.ops.storage import Storage

from torch_threads import one_torch_thread  # noqa: F401  (a fixture)

INF = float("inf")


def composed_sample_seeds(graph, vectors, queries, metric, dequant=None, *,
                          n_sample, n_seeds, ntotal, tile_q=2048):
    """``_sample_seeds`` as it was before K6: [tile_q, S] distance blocks
    and each stratum's argmin mapped to its id."""
    dev = vectors.device
    nt = ntotal.to(torch.int64).clamp(min=1)
    a = torch.arange(n_sample, dtype=torch.int64, device=dev)
    step, rem = nt // n_sample, nt % n_sample
    ids = torch.minimum(a * step + (a * rem) // n_sample, nt - 1)
    ok = (graph.levels[ids] >= 0) & (graph.neighbors0[ids, 0] >= 0)
    sv = decode_rows(vectors[ids], dequant)
    svsq = (sv * sv).sum(1)
    ss = n_sample // n_seeds
    base = torch.arange(n_seeds, device=dev)[None, :] * ss
    out = []
    for q0 in range(0, queries.shape[0], tile_q):
        dots = queries[q0:q0 + tile_q].float() @ sv.T
        dist = -dots if metric == IP else svsq[None, :] - 2.0 * dots
        dist = torch.where(ok[None, :], dist, INF).view(-1, n_seeds, ss)
        j = torch.argmin(dist, dim=2)
        cd = torch.gather(dist, 2, j[..., None])[..., 0]
        out.append(torch.where(torch.isfinite(cd), ids[base + j], -1))
    return torch.cat(out).to(torch.int32)


def scan_case(n, d, n_sample, seed, *, codec=None, dead=0.2,
              dead_stratum=None, n_seeds=1, ties=False):
    """A graph stand-in (levels, neighbors0) over n rows, ~``dead`` of them
    not inserted or isolated (one whole stratum of the sample dead with
    ``dead_stratum``), vectors (f32, or uint8 codes with an affine), and
    queries whose last eighth are all-zero padded rows. With ``ties`` the
    vectors are small integers, so many distances tie exactly."""
    g = torch.Generator().manual_seed(seed)
    levels = torch.zeros(n, dtype=torch.int32)
    nbr0 = torch.zeros((n, 4), dtype=torch.int32)
    gone = torch.rand(n, generator=g) < dead
    levels[gone & (torch.rand(n, generator=g) < 0.5)] = -1
    nbr0[gone, 0] = -1
    if dead_stratum is not None:
        ss = n_sample // n_seeds
        a = torch.arange(n_sample)
        ids = torch.minimum(a * (n // n_sample) + (a * (n % n_sample))
                            // n_sample, torch.tensor(n - 1))
        levels[ids[dead_stratum * ss:(dead_stratum + 1) * ss]] = -1
    dequant = None
    if codec == "sq8":
        vectors = torch.randint(0, 256, (n, d), generator=g,
                                dtype=torch.uint8)
        dequant = (torch.randn(d, generator=g),
                   torch.rand(d, generator=g) * 0.05 + 0.01)
    elif ties:
        vectors = torch.randint(-2, 3, (n, d), generator=g).float()
    else:
        vectors = torch.randn((n, d), generator=g)
    q = torch.randn((96, d), generator=g)
    if ties:
        q = torch.randint(-2, 3, (96, d), generator=g).float()
    q[-12:] = 0
    graph = SimpleNamespace(levels=levels, neighbors0=nbr0)
    return graph, vectors, q, dequant


CASES = {
    # name: (n, d, n_sample, n_seeds, metric, codec, kw)
    "l2_one": (3000, 24, 128, 1, L2, None, {}),
    "l2_four": (5000, 24, 512, 4, L2, None, {}),
    "ip_four": (5000, 24, 512, 4, IP, None, {}),
    "l2_seed16": (2000, 16, 128, 16, L2, None, {}),
    "ip_seed16": (2000, 16, 128, 16, IP, None, {}),
    "sq8_l2": (4000, 20, 256, 2, L2, "sq8", {}),
    "sq8_ip": (4000, 20, 256, 8, IP, "sq8", {}),
    "dead_stratum": (4000, 24, 256, 4, L2, None, dict(dead_stratum=2)),
    "all_dead": (1000, 8, 128, 4, L2, None, dict(dead=1.0)),
    "ties_l2": (3000, 12, 256, 4, L2, None, dict(ties=True)),
    "ties_ip": (3000, 12, 256, 4, IP, None, dict(ties=True)),
    "ntotal_below_sample": (100, 16, 128, 8, L2, None, {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_scan_equals_composed_bit_for_bit(name):
    """``_sample_seeds`` through the wrapper's plain path returns the old
    composed scan's seeds exactly: metrics, strata, sq8 rows, masked rows
    (a whole stratum dead: -1 there), exact ties (first index) and a
    sample larger than the index (repeated ids)."""
    n, d, n_sample, n_seeds, metric, codec, kw = CASES[name]
    graph, vectors, q, dequant = scan_case(n, d, n_sample, 11, codec=codec,
                                           n_seeds=n_seeds, **kw)
    nt = torch.tensor(n)
    got = search._sample_seeds(graph, Storage(vectors, sq=dequant), q,
                               metric, n_sample=n_sample, n_seeds=n_seeds,
                               ntotal=nt)
    want = composed_sample_seeds(graph, vectors, q, metric, dequant,
                                 n_sample=n_sample, n_seeds=n_seeds,
                                 ntotal=nt, tile_q=40)
    assert got.dtype == torch.int32 and got.shape == (q.shape[0], n_seeds)
    assert torch.equal(got, want)
    if "dead_stratum" in kw:
        assert bool((got[:, kw["dead_stratum"]] == -1).all())
    if kw.get("dead") == 1.0:
        assert bool((got == -1).all())


def assert_seeds_near(got, want, vectors, q, metric, dequant):
    """Seeds (ids) against another scan's: -1 exactly where it gives -1,
    equal on >= 99.9% of (query, stratum) pairs, and every other pair a
    near-tie: the two rows' float64 distances within 1e-5 relative."""
    got, want = got.long(), want.long()
    assert torch.equal(got < 0, want < 0)
    same = got == want
    assert same.float().mean() >= 0.999, same.float().mean()
    rows = vectors.double()
    if dequant is not None:
        rows = dequant[0].double() + dequant[1].double() * rows
    q64 = q.double()

    def dist(qi, ids):
        dot = (q64[qi] * rows[ids]).sum(1)
        return -dot if metric == IP else (rows[ids] ** 2).sum(1) - 2 * dot

    qi, j = torch.nonzero(~same, as_tuple=True)
    if len(qi):
        dg, dw = dist(qi, got[qi, j]), dist(qi, want[qi, j])
        rel = (dg - dw).abs() / torch.maximum(dg.abs(), dw.abs())
        assert float(rel.max()) <= 1e-5, float(rel.max())


@pytest.mark.parametrize("name", list(CASES))
def test_sample_seeds_match_the_reference(name):
    """``_sample_seeds`` against the reference's on the same graph rows,
    vectors and queries: L2 and IP, strata, sq8 rows, masked rows and a
    dead stratum, exact ties and a sample larger than the index."""
    n, d, n_sample, n_seeds, metric, codec, kw = CASES[name]
    graph, vectors, q, dequant = scan_case(n, d, n_sample, 11, codec=codec,
                                           n_seeds=n_seeds, **kw)
    got = search._sample_seeds(graph, Storage(vectors, sq=dequant), q,
                               metric, n_sample=n_sample, n_seeds=n_seeds,
                               ntotal=torch.tensor(n))
    ref_graph = SimpleNamespace(levels=jnp.asarray(graph.levels.numpy()),
                                neighbors0=jnp.asarray(
                                    graph.neighbors0.numpy()),
                                ntotal=jnp.int32(n))
    ref_dequant = None if dequant is None else tuple(
        jnp.asarray(t.numpy()) for t in dequant)
    want = ref_sample_seeds(ref_graph, jnp.asarray(vectors.numpy()),
                            jnp.asarray(q.numpy()), metric, ref_dequant,
                            n_sample=n_sample, n_seeds=n_seeds)
    want = torch.from_numpy(np.array(want))
    assert want.shape == got.shape
    assert_seeds_near(got, want, vectors, q, metric, dequant)


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("tile_q", [7, 2048])
def test_wrapper_plain_path_is_the_composition(metric, tile_q):
    """``entry_scan`` on CPU tensors is ``entry_scan_plain``; the query
    tile changes nothing."""
    g = torch.Generator().manual_seed(3)
    q, sv = torch.randn((50, 12), generator=g), torch.randn((64, 12),
                                                            generator=g)
    ok = torch.rand(64, generator=g) < 0.7
    svsq = (sv * sv).sum(1)
    got = entry_kernel.entry_scan(q, sv, svsq, ok, 8, metric)
    want = entry_kernel.entry_scan_plain(q, sv, svsq, ok, 8, metric,
                                         tile_q=tile_q)
    assert torch.equal(got, want)
    assert int(got.min()) >= -1 and int(got.max()) < 8


def test_searches_count_their_entry_path():
    """A sampled-entry search on the CPU counts one
    ``searches.composed_entry`` and no ``searches.kernel_entry``, in the
    seed mode too; a descending search counts neither."""
    from hnsw_tpu_torch import HnswIndex, synthetic_workload
    wl = synthetic_workload(600, 8, n_queries=20, seed=1)
    idx = HnswIndex(8, 8, capacity=700, ef_construction=40, device="cpu")
    idx.add(wl.base)
    with trace.collect() as t:
        idx.search(wl.queries, 5, ef_search=32)
        idx.search(wl.queries, 5, ef_search=32, entry_mode="seed")
        idx.search(wl.queries, 5, ef_search=32, entry_mode="descend")
    assert t.counters.get("searches.composed_entry") == 2
    assert "searches.kernel_entry" not in t.counters


def _fake_card(monkeypatch):
    """The wrapper as it runs for CUDA tensors, on CPU tensors: each launch
    recorded with its arguments, none run."""
    launched = []
    monkeypatch.setattr(entry_kernel, "on_cpu", lambda *t: False)
    monkeypatch.setattr(entry_kernel._ENTRY_SCAN, "launch",
                        lambda *a: launched.append(a))
    return launched


@pytest.mark.parametrize("n_sample,n_seeds,takes", [
    (128, 1, True), (128, 16, True), (16384, 4, True), (32768, 8, True),
    (128, 32, False),        # strata of 4 rows
    (120, 16, False),        # not cut into 16 equal strata
    (100, 3, False), (128, 0, False)])
def test_kernel_takes(monkeypatch, n_sample, n_seeds, takes):
    """On CUDA tensors the wrapper launches K6 for the samples a search
    makes (strata of 8 rows or more) and raises, launching nothing, for
    the rest."""
    launched = _fake_card(monkeypatch)
    q, sv = torch.zeros((4, 8)), torch.zeros((n_sample, 8))
    svsq, ok = torch.zeros(n_sample), torch.ones(n_sample, dtype=torch.bool)
    if takes:
        entry_kernel.entry_scan(q, sv, svsq, ok, n_seeds)
        assert len(launched) == 1
    else:
        with pytest.raises(ValueError):
            entry_kernel.entry_scan(q, sv, svsq, ok, n_seeds)
        assert not launched


def test_wrapper_launches_the_kernel_where_it_takes_the_shape(monkeypatch):
    launched = _fake_card(monkeypatch)
    q, sv = torch.zeros((40, 12)), torch.zeros((128, 12))
    svsq, ok = torch.zeros(128), torch.ones(128, dtype=torch.bool)
    out = entry_kernel.entry_scan(q, sv, svsq, ok, 16, IP)
    (a,) = launched
    assert out.shape == (40, 16) and out.dtype == torch.int32
    assert a[0] == q.data_ptr() and a[1:3] == (40, 12)
    assert a[3:6] == (sv.data_ptr(), svsq.data_ptr(), ok.data_ptr())
    assert a[6:9] == (128, 16, 1) and a[10] == out.data_ptr()


def test_wrapper_runs_plain_where_the_kernel_refuses(monkeypatch):
    """Strata of 4 rows: CPU tensors take the plain composition; CUDA
    tensors are refused with no launch, as no search makes them."""
    g = torch.Generator().manual_seed(5)
    q, sv = torch.randn((10, 6), generator=g), torch.randn((128, 6),
                                                           generator=g)
    svsq, ok = (sv * sv).sum(1), torch.ones(128, dtype=torch.bool)
    got = entry_kernel.entry_scan(q, sv, svsq, ok, 32)
    assert torch.equal(got, entry_kernel.entry_scan_plain(q, sv, svsq, ok,
                                                          32))
    launched = _fake_card(monkeypatch)
    with pytest.raises(ValueError, match="strata of 4 rows"):
        entry_kernel.entry_scan(q, sv, svsq, ok, 32)
    assert not launched


@pytest.mark.parametrize("bad", ["q_dtype", "sv_width", "svsq_len",
                                 "ok_dtype", "strided", "strata", "zero",
                                 "metric"])
def test_wrapper_refuses_bad_inputs(bad):
    q, sv = torch.zeros((8, 12)), torch.zeros((64, 12))
    svsq, ok = torch.zeros(64), torch.ones(64, dtype=torch.bool)
    n_seeds, metric = 4, L2
    if bad == "q_dtype":
        q = q.double()
    elif bad == "sv_width":
        sv = torch.zeros((64, 13))
    elif bad == "svsq_len":
        svsq = torch.zeros(63)
    elif bad == "ok_dtype":
        ok = ok.to(torch.uint8)
    elif bad == "strided":
        q = torch.zeros((12, 8)).T
    elif bad == "strata":
        n_seeds = 5
    elif bad == "zero":
        n_seeds = 0
    elif bad == "metric":
        metric = "cos"
    with pytest.raises(ValueError):
        entry_kernel.entry_scan(q, sv, svsq, ok, n_seeds, metric)
