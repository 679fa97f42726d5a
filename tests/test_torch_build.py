"""The port's build (hnsw_tpu_torch: select_neighbors, apply_backlinks,
DeviceBuilder via HnswIndex.add) against the reference on the same inputs,
on the CPU, and index files written by the reference loaded by the port."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hnsw_tpu
import hnsw_tpu_torch
from hnsw_tpu.ops.prune import select_neighbors as ref_select
from hnsw_tpu.ops.repair import apply_backlinks as ref_backlinks
from hnsw_tpu.utils.recall import recall_at_k
from hnsw_tpu_torch.ops.prune import select_neighbors
from hnsw_tpu_torch.ops.repair import apply_backlinks

from conftest import exact_knn


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_neighbors_matches_reference(metric, seed):
    rng = np.random.default_rng(seed)
    b, c, d, m = 16, 40, 12, 8
    ids = rng.permutation(4 * b * c)[:b * c].reshape(b, c).astype(np.int32)
    ids[rng.random((b, c)) < 0.2] = -1
    vecs = rng.normal(size=(b, c, d)).astype(np.float32)
    qs = rng.normal(size=(b, d)).astype(np.float32)
    if metric == "ip":
        dists = -np.einsum("bd,bcd->bc", qs, vecs)
    else:
        dists = ((vecs - qs[:, None, :]) ** 2).sum(-1)
    dists = dists.astype(np.float32)
    r_kept, r_mask = ref_select(jnp.asarray(ids), jnp.asarray(dists),
                                jnp.asarray(vecs), m=m, metric=metric)
    kept, mask = select_neighbors(torch.from_numpy(ids),
                                  torch.from_numpy(dists),
                                  torch.from_numpy(vecs), m=m, metric=metric)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(r_kept))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(r_mask))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_apply_backlinks_matches_reference(seed):
    """Random pre-filled rows, pairs that overflow rows (heuristic prune),
    duplicates of existing links, and a hub past the R-window (drops)."""
    rng = np.random.default_rng(seed)
    n, d, w, r = 60, 8, 6, 4
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    adj = np.full((n, w), -1, np.int32)
    for i in range(n):
        kk = rng.integers(0, w + 1)
        adj[i, :kk] = rng.choice(np.delete(np.arange(n), i), size=kk,
                                 replace=False)
    p = 80
    dst = rng.integers(0, n, size=p).astype(np.int32)
    dst[:10] = 7                                   # a hub: 10 > R sources
    src = rng.integers(0, n, size=p).astype(np.int32)
    valid = (rng.random(p) < 0.85) & (dst != src)
    seen = set()
    for i in range(p):    # one back-link per (dst, src) pair per batch
        if (dst[i], src[i]) in seen:
            valid[i] = False
        elif valid[i]:
            seen.add((dst[i], src[i]))
    r_adj, r_drop = ref_backlinks(
        jnp.asarray(adj), jnp.asarray(dst), jnp.asarray(dst),
        jnp.asarray(src), jnp.asarray(valid), jnp.asarray(vectors),
        r_window=r, metric="l2")
    got, drop = apply_backlinks(
        torch.from_numpy(adj.copy()), torch.from_numpy(dst),
        torch.from_numpy(dst), torch.from_numpy(src),
        torch.from_numpy(valid), torch.from_numpy(vectors), r_window=r,
        metric="l2")
    np.testing.assert_array_equal(got.numpy(), np.asarray(r_adj))
    assert int(drop) == int(r_drop) > 0


WL = dict(n=1500, d=24, n_queries=100, seed=21)
IDX = dict(capacity=2048, ef_construction=60, seed=13)


@pytest.fixture(scope="module")
def built():
    """The same workload and seed through both packages' device builds."""
    wl = hnsw_tpu_torch.synthetic_workload(WL["n"], WL["d"],
                                           n_queries=WL["n_queries"],
                                           seed=WL["seed"])
    ref = hnsw_tpu.HnswIndex(WL["d"], 8, "l2", **IDX)
    ref.add(wl.base)
    port = hnsw_tpu_torch.HnswIndex(WL["d"], 8, "l2", device="cpu", **IDX)
    port.add(wl.base)
    return wl, ref, port


def test_synthetic_workload_matches_reference():
    from hnsw_tpu.utils.datasets import synthetic_workload as ref_wl
    for metric in ("l2", "ip"):
        a = ref_wl(300, 16, n_queries=20, metric=metric, seed=4)
        b = hnsw_tpu_torch.synthetic_workload(300, 16, n_queries=20,
                                              metric=metric, seed=4)
        np.testing.assert_array_equal(a.base, b.base)
        np.testing.assert_array_equal(a.queries, b.queries)


def test_build_matches_reference(built, monkeypatch):
    """Identical seeded level draws, clean invariants, and recall@10 at
    ef=64 within 0.02 of the reference's build (a bit-identical graph is
    not expected: argsort ties and f32 summation order differ)."""
    wl, ref, port = built
    np.testing.assert_array_equal(port.graph.levels.numpy(),
                                  np.asarray(ref.graph.levels))
    assert port.graph.max_level == int(ref.graph.max_level)
    assert port.graph.entry_point == int(ref.graph.entry_point)
    assert port.graph.n_upper == int(ref.graph.n_upper)
    stats = port.check()
    assert stats["errors"] == []
    assert stats["isolated0"] == 0 and stats["deg0_max"] <= port.config.m0
    ref_stats = ref.check()
    assert abs(stats["reciprocity0"] - ref_stats["reciprocity0"]) < 0.03
    assert port._builder.last_backlink_dropped >= 0
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    _, ri = ref.search(wl.queries, k=10, ef_search=64)
    _, pi = port.search(wl.queries, k=10, ef_search=64)
    r_ref, r_port = recall_at_k(ri, gt, 10), recall_at_k(pi, gt, 10)
    assert r_port >= 0.9 and abs(r_port - r_ref) <= 0.02, (r_port, r_ref)


def test_build_is_deterministic(built):
    wl, _, port = built
    again = hnsw_tpu_torch.HnswIndex(WL["d"], 8, "l2", device="cpu", **IDX)
    again.add(wl.base)
    for k in ("neighbors0", "upper_neighbors", "upper_node", "upper_slot"):
        assert torch.equal(getattr(again.graph, k), getattr(port.graph, k)), k
    assert again.graph.entry_point == port.graph.entry_point


def test_load_reference_index_and_search_alike(built, tmp_path, monkeypatch):
    """A file from hnsw_tpu HnswIndex.save loads with identical arrays; both
    packages then search the same graph alike, unpacked and packed 8-bit."""
    wl, ref, _ = built
    path = tmp_path / "ref.npz"
    ref.save(str(path))
    port = hnsw_tpu_torch.HnswIndex.load(str(path), device="cpu")
    for k, v in port.graph.numpy().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ref.graph, k)))
    np.testing.assert_array_equal(port.vectors.numpy(),
                                  np.asarray(ref.vectors))
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    for packed in (False, True):
        if packed:
            ref.enable_packed(bits=8)
            port.enable_packed(bits=8)
        rd, ri, rst = ref.search(wl.queries, k=10, ef_search=40,
                                 with_stats=True)
        d, i, st = port.search(wl.queries, k=10, ef_search=40,
                               with_stats=True)
        same = i == ri
        assert same.mean() >= 0.99, (packed, same.mean())
        np.testing.assert_allclose(d[same], rd[same], rtol=1e-5, atol=1e-5)
        assert st.hops == int(rst.hops)
    ref.disable_packed()
    # the saved level-RNG state carries over: the next add draws the same
    # levels as the reference's next add
    assert port._builder.rng.random() == ref._builder.rng.random()


def test_default_device_requires_card(built, tmp_path, monkeypatch):
    """With no device given the index takes the card; with no card it
    raises and names device='cpu', in the constructor and in load()."""
    _, ref, _ = built
    path = tmp_path / "ref.npz"
    ref.save(str(path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hnsw_tpu_torch.HnswIndex(8, 4, capacity=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hnsw_tpu_torch.HnswIndex.load(str(path))
    assert hnsw_tpu_torch.HnswIndex.load(str(path), device="cpu").ntotal \
        == ref.ntotal


def test_api_filter_beam_keys_n_expand_match_reference(built, tmp_path,
                                                       monkeypatch):
    """HnswIndex.search(allowed=, beam_keys=) and the n_expand attribute,
    against the reference's HnswIndex on the same loaded graph: allowed as
    a numpy id list, a numpy bool mask (shorter than capacity) and a tensor
    id list; only allowed ids come back, as the reference's (ids >= 99%
    equal, hops equal)."""
    wl, ref, _ = built
    path = tmp_path / "ref.npz"
    ref.save(str(path))
    port = hnsw_tpu_torch.HnswIndex.load(str(path), device="cpu")
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    ids = np.flatnonzero(np.random.default_rng(4).random(WL["n"]) < 0.4)
    mask = np.zeros(WL["n"], bool)
    mask[ids] = True
    cases = [(ids, ids, "auto", 1), (mask, mask, "bf16", 2),
             (ids, torch.from_numpy(ids), "f32", 2)]
    for r_allowed, p_allowed, keys, n_expand in cases:
        ref.n_expand = port.n_expand = n_expand
        rd, ri, rst = ref.search(wl.queries, k=10, ef_search=40,
                                 allowed=r_allowed, beam_keys=keys,
                                 with_stats=True)
        d, i, st = port.search(wl.queries, k=10, ef_search=40,
                               allowed=p_allowed, beam_keys=keys,
                               with_stats=True)
        assert mask[i[i >= 0]].all()
        same = i == ri
        assert same.mean() >= 0.99, (keys, n_expand, same.mean())
        np.testing.assert_allclose(d[same], rd[same], rtol=1e-5, atol=1e-5)
        assert st.hops == int(rst.hops)
    ref.n_expand = 1
    with pytest.raises(TypeError):
        port.search(wl.queries[:2], k=5, allowed=np.ones(5, np.float32))
    with pytest.raises(ValueError, match="capacity"):
        port.search(wl.queries[:2], k=5, allowed=np.ones(5000, bool))


def test_ip_build_and_search():
    """Inner-product metric through the whole slice: build, invariants,
    unpacked and packed search (twin of test_device_build's IP case)."""
    wl = hnsw_tpu_torch.synthetic_workload(1000, 16, n_queries=60,
                                           metric="ip", seed=8)
    idx = hnsw_tpu_torch.HnswIndex(16, 8, "ip", capacity=2048,
                                   ef_construction=60, device="cpu")
    idx.add(wl.base)
    assert idx.check()["errors"] == []
    _, gt = exact_knn(wl.base, wl.queries, 10, "ip")
    _, i = idx.search(wl.queries, k=10, ef_search=64)
    assert recall_at_k(i, gt, 10) >= 0.92
    idx.enable_packed(bits=8)
    _, i = idx.search(wl.queries, k=10, ef_search=64)
    assert recall_at_k(i, gt, 10) >= 0.92


def test_index_api_edges():
    idx = hnsw_tpu_torch.HnswIndex(8, 4, capacity=64, device="cpu",
                                   ef_construction=20)
    x = np.random.default_rng(0).normal(size=(1, 8)).astype(np.float32)
    d, i = idx.search(x, k=1)                     # empty index
    assert i[0, 0] == -1 and np.isinf(d[0, 0])
    idx.add(x)
    d, i = idx.search(x, k=1)
    assert i[0, 0] == 0 and abs(d[0, 0]) < 1e-5
    idx.add(np.random.default_rng(1).normal(size=(5, 8)).astype(np.float32))
    assert idx.ntotal == 6 and idx.check()["errors"] == []
    _, i = idx.search(x, k=6)
    assert set(i[0].tolist()) == set(range(6))
    with pytest.raises(ValueError, match="capacity"):
        idx.add(np.zeros((100, 8), np.float32))
    idx.enable_packed(bits=4)
    with pytest.raises(NotImplementedError, match="disable_packed"):
        idx.add(x)
    with pytest.raises(NotImplementedError):
        hnsw_tpu_torch.HnswIndex(8, 4, capacity=64, build="host",
                                 device="cpu")
    # what stays unported: an index file with tombstones (deletion)
    from hnsw_tpu_torch.graph import save_graph
    buf = io.BytesIO()
    save_graph(buf, idx.graph, idx.vectors, idx.config,
               extra_arrays={"alive": np.ones(64, bool)})
    with pytest.raises(NotImplementedError, match="tombstones"):
        hnsw_tpu_torch.HnswIndex.from_bytes(buf.getvalue(), device="cpu")


def test_config_json_interchanges():
    from hnsw_tpu.config import HnswConfig as RefConfig
    for kw in (dict(dim=24, m=8), dict(dim=96, m=16, metric="ip",
                                       capacity=5000, dtype="sq8")):
        ref = RefConfig(**kw)
        port = hnsw_tpu_torch.HnswConfig.from_json(ref.to_json())
        assert port.to_json() == ref.to_json()
        assert RefConfig.from_json(port.to_json()) == ref
