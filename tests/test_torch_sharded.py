"""The port's sharded index (hnsw_tpu_torch.parallel.sharded) against the
reference's ``ShardedHnswIndex``, on the CPU: twins of tests/test_sharded.py
and of the two sharded cases of tests/test_vacuum.py.

Both packages get the same numpy inputs on the reference's own shapes (4
shards x q 2, d=16, M=8, efConstruction=60): the port's per-shard graphs,
user-id tables and counts must equal the reference's, array for array, and
searches on shared graphs (the port loads the reference's ``.npz``, the
reference the port's) must return the same ids on >= 99% of slots with the
distances of those within rtol 1e-5 + atol 1e-5. The reference runs on
its 8 virtual CPU devices (tests/conftest.py), the port on a mesh of the
CPU device repeated, with its kernels' plain versions. Where the
reference's case is marked slow, its twin checks the port's behaviour
alone at the same thresholds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_tpu.parallel import sharded as ref_sharded
from hnsw_tpu.parallel.sharded import ShardedHnswIndex as RefSharded
from hnsw_tpu.parallel.sharded import make_mesh as ref_mesh
from hnsw_tpu.utils.recall import recall_at_k
from hnsw_tpu_torch import (IdMapIndex, NormalizationTransform,
                            PreTransformIndex, Searcher, synthetic_workload)
from hnsw_tpu_torch.graph import SCALAR_FIELDS, TENSOR_FIELDS
from hnsw_tpu_torch.parallel import sharded
from hnsw_tpu_torch.parallel.sharded import (Mesh, ShardedHnswIndex,
                                             make_mesh, merge_topk)

from conftest import exact_knn
from torch_threads import one_torch_thread  # noqa: F401  (a fixture)

CPU = torch.device("cpu")
SMALL = dict(capacity_per_shard=1024, ef_construction=60)


def cpu_mesh(n_shards=4, q=2):
    return make_mesh(n_shards, q, devices=[CPU] * (n_shards * q))


def pair(base, d=16, m=8, metric="l2", train=False, **kw):
    """(reference, port) sharded indexes built alike on ``base``."""
    ref = RefSharded(d, m, metric, mesh=ref_mesh(4, 2), **kw)
    port = ShardedHnswIndex(d, m, metric, mesh=cpu_mesh(), **kw)
    for idx in (ref, port):
        if train:
            idx.train(base)
        idx.add(base)
    return ref, port


def assert_same_index(ref, port):
    """Per-shard graph arrays and scalars, vectors, user ids, counts."""
    for s in range(port.n_shards):
        g = port._graphs[s]
        for f in TENSOR_FIELDS:
            np.testing.assert_array_equal(
                getattr(g, f).numpy(), np.asarray(getattr(ref._graph, f))[s],
                err_msg=f"shard {s} {f}")
        for f in SCALAR_FIELDS:
            assert getattr(g, f) == int(np.asarray(getattr(ref._graph, f))[s])
        np.testing.assert_array_equal(port._storage[s].rows.numpy(),
                                      np.asarray(ref._vectors)[s])
        np.testing.assert_array_equal(port._global_ids[s].numpy(),
                                      np.asarray(ref._global_ids)[s])
    np.testing.assert_array_equal(port._counts, ref._counts)
    assert port.ntotal == ref.ntotal


def assert_same_search(ref_out, port_out):
    (rd, ri), (d, i) = ref_out, port_out
    assert i.shape == ri.shape and i.dtype == np.int64
    same = i == ri
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(d[same], rd[same], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def built():
    """The reference's ``sharded_built`` fixture, in both packages."""
    wl = synthetic_workload(4000, 16, n_queries=128, metric="l2", seed=31)
    ref, port = pair(wl.base, capacity_per_shard=2048, ef_construction=60,
                     seed=17)
    return ref, port, wl


@pytest.fixture(scope="module")
def files(built, tmp_path_factory):
    """``built`` saved by each package: (the reference's, the port's)."""
    ref, port, _ = built
    d = tmp_path_factory.mktemp("sharded")
    ref.save(str(d / "ref.npz"))
    port.save(str(d / "port.npz"))
    return str(d / "ref.npz"), str(d / "port.npz")


def fresh(files, which=0):
    """(reference, port) loaded from one file: ``which`` 0 the reference's
    save, 1 the port's."""
    p = files[which]
    return (RefSharded.load(p, mesh=ref_mesh(4, 2)),
            ShardedHnswIndex.load(p, mesh=cpu_mesh()))


# ---------------------------------------------------------------- the mesh
def test_mesh_shapes(monkeypatch):
    mesh = cpu_mesh()
    assert mesh.shape == {"shard": 4, "q": 2} == dict(ref_mesh(4, 2).shape)
    assert len(jax.devices()) == 8
    assert make_mesh(3, devices=[CPU] * 8).shape == {"shard": 3, "q": 1}
    assert make_mesh(devices=[CPU] * 8).shape == {"shard": 8, "q": 1}
    with pytest.raises(ValueError, match="devices"):
        make_mesh(4, 3, devices=[CPU] * 8)
    # a shard's state lives on one device: its q devices must be one
    with pytest.raises(ValueError, match="one device"):
        ShardedHnswIndex(8, 4, mesh=Mesh([[CPU, torch.device("meta")]]))
    # pq storage is refused, naming the single index
    with pytest.raises(ValueError, match="HnswIndex"):
        ShardedHnswIndex(16, 8, mesh=mesh, dtype="pq", pq_m=4)
    # the default is every CUDA device: with none, no fall back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_mesh, lambda: ShardedHnswIndex(8, 4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


# ------------------------------------------------------- build, edge for edge
def test_build_matches_reference(built):
    ref, port, _ = built
    assert_same_index(ref, port)
    assert sorted(port._counts.tolist()) == [1000] * 4


def test_sq8_build_search_and_files_match_reference(tmp_path):
    """sq8 storage, one quantizer for every shard: the same graphs and
    codes, the same searches; each package loads the other's file; the
    port's own save / load returns identical results (the twin of the
    reference's slow test_sharded_sq8_storage)."""
    wl = synthetic_workload(1200, 16, n_queries=64, metric="l2", seed=61)
    port = ShardedHnswIndex(16, 8, "l2", mesh=cpu_mesh(), dtype="sq8",
                            seed=11, **SMALL)
    assert not port.is_trained
    with pytest.raises(RuntimeError, match="train"):
        port.add(wl.base)
    ref, port = pair(wl.base, train=True, dtype="sq8", seed=11, **SMALL)
    assert port._storage[0].rows.dtype == torch.uint8
    arrays = port._codec.codec_arrays()
    for a, b in zip((arrays["sq_offset"], arrays["sq_scale"]), ref._sq_np):
        np.testing.assert_array_equal(a, b)
    assert_same_index(ref, port)
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    out = port.search(wl.queries, k=10, ef_search=64)
    assert_same_search(ref.search(wl.queries, k=10, ef_search=64), out)
    assert recall_at_k(out[1], gt, 10) >= 0.9
    assert all(s["ok"] for s in port.health_check())
    p_port, p_ref = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    port.save(p_port)
    ref.save(p_ref)
    with np.load(p_port) as a, np.load(p_ref) as b:
        assert sorted(a.files) == sorted(b.files)
    ref2 = RefSharded.load(p_port, mesh=ref_mesh(4, 2))
    assert_same_index(ref2, port)
    port2 = ShardedHnswIndex.load(p_ref, mesh=cpu_mesh())
    assert port2.is_trained and port2._storage[0].rows.dtype == torch.uint8
    d2, i2 = port2.search(wl.queries, k=10, ef_search=64)
    np.testing.assert_array_equal(i2, out[1])
    np.testing.assert_array_equal(d2, out[0])


def test_spilled_batches_match_reference(monkeypatch):
    """A batch whose level>=1 points pass ``upper_batch_cap`` spills its
    tail, and the levels drawn for the spilled rows are thrown away. With
    the cap patched to 2 in both packages, spills happen in most batches:
    the graphs stay equal, and differ from an unpatched build's levels."""
    wl = synthetic_workload(800, 16, n_queries=8, metric="l2", seed=5)
    plain = ShardedHnswIndex(16, 8, "l2", mesh=cpu_mesh(), seed=5, **SMALL)
    plain.add(wl.base)
    for mod in (ref_sharded, sharded):
        monkeypatch.setattr(mod, "upper_batch_cap", lambda size, m: 2)
    ref, port = pair(wl.base, seed=5, **SMALL)
    assert_same_index(ref, port)
    assert not all(torch.equal(a.levels, b.levels)
                   for a, b in zip(port._graphs, plain._graphs))
    for st in port.check():
        assert st["errors"] == []


# --------------------------------------------------- search on shared graphs
SEARCH_CASES = ("unpacked", "bytes", "words", "filtered-bool", "filtered-int",
                "tombstoned", "degraded")


@pytest.mark.parametrize("case", SEARCH_CASES)
def test_search_matches_reference(built, files, case):
    """Both packages search one graph (loaded from the reference's save):
    unpacked, packed bytes and words rows, a bool and an int user-id
    filter, tombstones, and a failed shard."""
    _, _, wl = built
    ref, port = fresh(files)
    q, kw = wl.queries, dict(k=10, ef_search=64)
    if case in ("bytes", "words"):
        assert ref.enable_packed(8, layout=case) > 0
        assert port.enable_packed(8, layout=case) > 0
    elif case == "filtered-bool":
        allowed = np.zeros(4000, bool)
        allowed[::3] = True
        kw.update(ef_search=128, allowed=allowed)
    elif case == "filtered-int":
        kw.update(ef_search=128, allowed=np.arange(100, 1700))
    elif case == "tombstoned":
        dead = np.random.default_rng(3).choice(4000, 400, replace=False)
        assert ref.remove_ids(dead) == port.remove_ids(dead) == 400
    elif case == "degraded":
        ref.mark_shard_failed(1)
        port.mark_shard_failed(1)
    out = port.search(q, **kw)
    assert_same_search(ref.search(q, **kw), out)
    if case == "degraded":
        live = out[1][out[1] >= 0]
        assert live.size and not (live % 4 == 1).any()


def test_reference_searches_the_ports_file(built, files):
    """The reference loads the port's save: the same arrays, and its
    search returns the port's."""
    _, port, wl = built
    ref, _ = fresh(files, which=1)
    assert_same_index(ref, port)
    assert_same_search(ref.search(wl.queries, k=10, ef_search=64),
                       port.search(wl.queries, k=10, ef_search=64))


def test_merge_tie_order_matches_reference():
    """Per-shard results with distances tied across shards (and inf pads)
    merge into the reference's order: its ``all_gather`` + ``top_k`` on
    the same values keeps the lower shard first."""
    rng = np.random.default_rng(0)
    S, Q, k = 4, 64, 10
    d = np.sort(rng.integers(0, 6, (S, Q, k)).astype(np.float32), axis=2)
    d[rng.random((S, Q, k)) < 0.1] = np.inf
    d = np.sort(d, axis=2)
    i = rng.integers(0, 1 << 20, (S, Q, k)).astype(np.int32)
    flat_d = jnp.moveaxis(jnp.asarray(d), 0, 1).reshape(Q, S * k)
    flat_i = jnp.moveaxis(jnp.asarray(i), 0, 1).reshape(Q, S * k)
    neg, pos = jax.lax.top_k(-flat_d, k)
    want_i = np.asarray(jnp.take_along_axis(flat_i, pos, axis=1))
    got_d, got_i = merge_topk([torch.from_numpy(x) for x in d],
                              [torch.from_numpy(x) for x in i], k)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.numpy(), -np.asarray(neg))


def test_duplicates_across_shards_merge_like_reference():
    """Each point stored four times in a row, so every shard holds a copy
    and every query's distances tie across shards: both packages return
    the same ids in the same order, the copies lower shard first."""
    rng = np.random.default_rng(9)
    base = np.repeat(rng.standard_normal((100, 16)).astype(np.float32), 4,
                     axis=0)
    q = base[::4][:32] + 0.3 * rng.standard_normal((32, 16)).astype(
        np.float32)
    ref, port = pair(base, seed=3, **SMALL)
    rd, ri = ref.search(q, k=8, ef_search=32)
    d, i = port.search(q, k=8, ef_search=32)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(d, rd, rtol=1e-5, atol=1e-5)
    assert (i[:, :4] == 4 * (i[:, :1] // 4) + np.arange(4)).all()


# --------------------------------------------- behaviour (test_sharded.py)
def test_sharded_recall(built):
    _, idx, wl = built
    assert idx.ntotal == 4000
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    _, i = idx.search(wl.queries, k=10, ef_search=64)
    assert recall_at_k(i, gt, 10) >= 0.95


def test_user_ids_are_insertion_order(built):
    _, idx, wl = built
    d, i = idx.search(wl.base[:64], k=1, ef_search=32)
    assert (i[:, 0] == np.arange(64)).mean() > 0.95
    assert (d[:, 0] < 1e-3).mean() > 0.95


def test_results_sorted_and_unique(built):
    _, idx, wl = built
    d, i = idx.search(wl.queries[:32], k=10)
    assert (np.diff(d, axis=1) >= -1e-6).all()
    for row in i:
        vals = row[row >= 0]
        assert len(set(vals.tolist())) == len(vals)


def test_query_padding(built):
    _, idx, wl = built
    d, i = idx.search(wl.queries[:7], k=5)
    assert i.shape == (7, 5)
    _, i2 = idx.search(wl.queries[:8], k=5)
    assert (i == i2[:7]).all()


def test_empty_and_errors():
    idx = ShardedHnswIndex(8, 4, mesh=cpu_mesh(), capacity_per_shard=64)
    d, i = idx.search(np.zeros((3, 8), np.float32), k=2)
    assert (i == -1).all() and np.isinf(d).all()
    with pytest.raises(ValueError, match="expected"):
        idx.add(np.zeros((4, 9), np.float32))
    with pytest.raises(ValueError, match="capacity_per_shard"):
        idx.add(np.zeros((4 * 64 + 1, 8), np.float32))
    with pytest.raises(ValueError, match="empty"):
        idx.enable_packed()
    # fewer points than shards: empty shards answer (inf, -1)
    idx.add(np.eye(8, dtype=np.float32)[:3])
    assert idx._counts.tolist() == [1, 1, 1, 0]
    _, i = idx.search(np.eye(8, dtype=np.float32)[:3], k=2)
    np.testing.assert_array_equal(i[:, 0], [0, 1, 2])


def test_sharded_save_load(built, files, tmp_path):
    _, idx, wl = built
    d1, i1 = idx.search(wl.queries[:32], k=5)
    idx2 = ShardedHnswIndex.load(files[1], mesh=idx.mesh)
    assert idx2.ntotal == idx.ntotal
    d2, i2 = idx2.search(wl.queries[:32], k=5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)
    with pytest.raises(ValueError, match="shards"):
        ShardedHnswIndex.load(files[1], mesh=cpu_mesh(2))
    idx2.add(np.asarray(wl.base[:8], np.float32) + 0.01)
    assert idx2.ntotal == idx.ntotal + 8


def test_sharded_invariants(built):
    _, idx, _ = built
    for st in idx.check():
        assert st["errors"] == []


def test_sharded_deletion_and_filtering(built, files):
    _, idx, wl = built
    idx = ShardedHnswIndex.load(files[1], mesh=cpu_mesh())
    _, gt = exact_knn(wl.base, wl.queries, 1, "l2")
    victims = np.unique(gt[:, 0])[:20]
    assert idx.remove_ids(victims) == len(victims) == idx.n_deleted
    _, i = idx.search(wl.queries, k=10, ef_search=64)
    assert not np.isin(i, victims).any()
    allowed = np.zeros(idx.ntotal, bool)
    allowed[:500] = True
    allowed[victims] = True           # tombstones still win
    _, fi = idx.search(wl.queries[:32], k=5, ef_search=128, allowed=allowed)
    valid = fi[fi >= 0]
    assert (valid < 500).all() and not np.isin(valid, victims).any()
    _, wi = idx.search(wl.queries[:8], k=5, ef_search=128,
                       allowed=torch.arange(100, 200))
    wv = wi[wi >= 0]
    assert ((wv >= 100) & (wv < 200)).all()
    with pytest.raises(IndexError):
        idx.remove_ids(np.asarray([idx.ntotal]))
    with pytest.raises(TypeError):
        idx.search(wl.queries[:2], k=5, allowed=np.ones(4, np.float32))


def test_sharded_deletion_survives_save_load(built, files, tmp_path):
    _, _, wl = built
    idx = ShardedHnswIndex.load(files[1], mesh=cpu_mesh())
    idx.remove_ids(np.arange(0, 4000, 9))
    p = str(tmp_path / "del.npz")
    idx.save(p)
    idx2 = ShardedHnswIndex.load(p, mesh=cpu_mesh())
    assert idx2.n_deleted == idx.n_deleted == 445
    _, i = idx2.search(wl.queries[:16], k=10, ef_search=64)
    assert not np.isin(i, np.flatnonzero(idx._removed)).any()


def test_sharded_ip_metric():
    wl = synthetic_workload(3000, 16, n_queries=96, metric="ip", seed=53)
    idx = ShardedHnswIndex(16, 8, "ip", mesh=cpu_mesh(), seed=19, **SMALL)
    idx.add(wl.base)
    _, gt = exact_knn(wl.base, wl.queries, 10, "ip")
    _, i = idx.search(wl.queries, k=10, ef_search=64)
    assert recall_at_k(i, gt, 10) >= 0.93


def test_uneven_shard_counts():
    """3 shards on the 8-device CPU list, 1000 points (334/333/333)."""
    mesh = make_mesh(n_shards=3, q_parallel=1, devices=[CPU] * 8)
    wl = synthetic_workload(1000, 12, n_queries=64, metric="l2", seed=59)
    idx = ShardedHnswIndex(12, 8, "l2", mesh=mesh, capacity_per_shard=512,
                           ef_construction=60, seed=23)
    idx.add(wl.base)
    assert idx.ntotal == 1000
    assert sorted(idx._counts.tolist()) == [333, 333, 334]
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    _, i = idx.search(wl.queries, k=10, ef_search=64)
    assert recall_at_k(i, gt, 10) >= 0.95
    for st in idx.check():
        assert st["errors"] == []


def test_sharded_packed_serving(built, files):
    """Packed per-shard tables: recall within 0.02 of unpacked, exact
    distances where the ids agree, tombstones filtered; ``add()`` and
    ``vacuum()`` drop the tables."""
    _, _, wl = built
    idx = ShardedHnswIndex.load(files[1], mesh=cpu_mesh())
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    d_u, i_u = idx.search(wl.queries, k=10, ef_search=96)
    assert idx.enable_packed(bits=8) > 0 and idx.packed_enabled
    assert len(idx._packed) == 4
    assert idx._packed[0].nbr_codes.shape == (1000, 16 * 16)
    d_p, i_p = idx.search(wl.queries, k=10, ef_search=96)
    assert recall_at_k(i_p, gt, 10) >= recall_at_k(i_u, gt, 10) - 0.02
    match = i_p == i_u
    np.testing.assert_allclose(d_p[match], d_u[match], rtol=1e-4, atol=1e-4)
    idx.remove_ids(np.arange(0, 4000, 7))
    _, i_f = idx.search(wl.queries, k=10, ef_search=96)
    assert (i_f[i_f >= 0] % 7 != 0).all()
    idx2 = ShardedHnswIndex(16, 8, "l2", mesh=cpu_mesh(), seed=5, **SMALL)
    idx2.add(wl.base[:1000])
    idx2.enable_packed()
    idx2.add(wl.base[1000:2000])
    assert not idx2.packed_enabled
    idx2.enable_packed()
    idx2.remove_ids(np.arange(100))
    idx2.vacuum()
    assert not idx2.packed_enabled


def test_sharded_packed_sq8_and_4bit():
    wl = synthetic_workload(2000, 16, n_queries=64, metric="l2", seed=71)
    idx = ShardedHnswIndex(16, 8, "l2", mesh=cpu_mesh(), seed=9,
                           dtype="sq8", **SMALL)
    idx.train(wl.base)
    idx.add(wl.base)
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    _, i_u = idx.search(wl.queries, k=10, ef_search=96)
    r_u = recall_at_k(i_u, gt, 10)
    idx.enable_packed(bits=8)
    # sq8 at 8 bits: the stored codes are the routing codes
    assert idx._packed[0].scale is idx._storage[0].sq[1]
    _, i_p = idx.search(wl.queries, k=10, ef_search=96)
    assert recall_at_k(i_p, gt, 10) >= r_u - 0.02
    idx.disable_packed()
    idx.enable_packed(bits=4)
    assert idx._packed[0].nbr_codes.shape[1] == idx.config.m0 * 8
    _, i_4 = idx.search(wl.queries, k=10, ef_search=192)
    assert recall_at_k(i_4, gt, 10) >= r_u - 0.05


def test_sharded_packed_words_layout_parity(built, files):
    """Words rows return what bytes rows do, bit for bit; "auto" is
    bytes."""
    _, _, wl = built
    idx = ShardedHnswIndex.load(files[1], mesh=cpu_mesh())
    idx.enable_packed(bits=8, layout="bytes")
    assert idx._packed[0].nbr_codes.dtype == torch.uint8
    d_b, i_b = idx.search(wl.queries, k=10, ef_search=64)
    idx.enable_packed(bits=8, layout="words")
    assert idx._packed[0].nbr_codes.dtype == torch.int32
    d_w, i_w = idx.search(wl.queries, k=10, ef_search=64)
    np.testing.assert_array_equal(i_b, i_w)
    np.testing.assert_array_equal(d_b, d_w)
    idx.enable_packed(bits=8)
    assert idx._packed[0].nbr_codes.dtype == torch.uint8


def test_sharded_composes_with_wrappers():
    rng = np.random.default_rng(73)
    base = (rng.standard_normal((2000, 16)) *
            rng.uniform(0.1, 5.0, (2000, 1))).astype(np.float32)
    queries = rng.standard_normal((64, 16)).astype(np.float32)
    inner = ShardedHnswIndex(16, 8, "ip", mesh=cpu_mesh(), **SMALL)
    idx = PreTransformIndex(NormalizationTransform(16, device="cpu"), inner)
    idx.train(base)
    idx.add(base)
    _, i = idx.search(queries, 10, ef_search=96)
    cos = (queries / np.linalg.norm(queries, axis=1, keepdims=True)) @ \
        (base / np.linalg.norm(base, axis=1, keepdims=True)).T
    gt = np.argsort(-cos, axis=1)[:, :10]
    assert recall_at_k(np.asarray(i), gt, 10) >= 0.9
    inner2 = ShardedHnswIndex(16, 8, "l2", mesh=cpu_mesh(), **SMALL)
    im = IdMapIndex(inner2)
    ids = np.arange(2000) * 10 + 7
    im.add_with_ids(base, ids)
    _, mi = im.search(base[:4], 1, ef_search=32)
    np.testing.assert_array_equal(mi[:, 0], ids[:4])
    s = Searcher(inner2, k=5, ef_search=64, min_bucket=64)
    d, i = s.search(base[:3])
    assert i.shape == (3, 5) and i[0, 0] == 0


# ------------------------------------------------- vacuum (test_vacuum.py)
def test_sharded_vacuum_matches_reference(built, files):
    """Both packages vacuum one graph (the reference's save) of the same
    800 ids: the same per-shard graphs, no live link to a dead id, the
    same searches, none of them returning a dead id."""
    _, _, wl = built
    ref, port = fresh(files)
    dead_ids = np.random.default_rng(1).choice(4000, 800, replace=False)
    for idx in (ref, port):
        idx.remove_ids(dead_ids)
        assert not idx._routing_clean
        assert idx.vacuum() == 800 and idx._routing_clean
    for s in range(4):
        g = port._graphs[s]
        for f in ("neighbors0", "upper_neighbors"):
            np.testing.assert_array_equal(
                getattr(g, f).numpy(), np.asarray(getattr(ref._graph, f))[s])
        assert (g.entry_point, g.max_level) == (
            int(ref._graph.entry_point[s]), int(ref._graph.max_level[s]))
    for chk in port.check(strict=True):
        assert chk["links_to_dead"] == 0
    alive = np.ones(4000, bool)
    alive[dead_ids] = False
    out = port.search(wl.queries, 10, ef_search=96)
    assert_same_search(ref.search(wl.queries, 10, ef_search=96), out)
    assert alive[out[1][out[1] >= 0]].all()
    live_ids = np.flatnonzero(alive)
    _, gt_l = exact_knn(wl.base[live_ids], wl.queries, 10, "l2")
    assert recall_at_k(out[1], live_ids[gt_l], 10) >= 0.85


def test_sharded_vacuum_save_load(tmp_path):
    """A save before vacuum() keeps filtering after a load, in either
    package; one after it keeps the clean flag."""
    wl = synthetic_workload(1200, 16, n_queries=32, metric="l2", seed=23)
    idx = ShardedHnswIndex(16, 8, "l2", mesh=cpu_mesh(), **SMALL)
    idx.add(wl.base)
    idx.remove_ids(np.arange(0, 1200, 5))
    p = str(tmp_path / "pre.npz")
    idx.save(p)
    for other in (ShardedHnswIndex.load(p, mesh=cpu_mesh()),
                  RefSharded.load(p, mesh=ref_mesh(4, 2))):
        assert not other._routing_clean
        _, i2 = other.search(wl.queries, 5, ef_search=64)
        assert (i2[i2 >= 0] % 5 != 0).all()
    idx.vacuum()
    p2 = str(tmp_path / "post.npz")
    idx.save(p2)
    idx3 = ShardedHnswIndex.load(p2, mesh=cpu_mesh())
    assert idx3._routing_clean
    _, i3 = idx3.search(wl.queries, 5, ef_search=64)
    assert (i3[i3 >= 0] % 5 != 0).all()


def test_sharded_vacuum_then_add_keeps_a_live_entry(built, files):
    """Each shard's entry point removed and vacuumed: every shard enters
    at a live node, and still does after an add (the reference's vacuum
    leaves its host copies of the entry points stale, and its next add
    writes the dead ones back)."""
    _, _, wl = built
    idx = ShardedHnswIndex.load(files[1], mesh=cpu_mesh())
    entry_uids = [int(idx._global_ids[s][g.entry_point])
                  for s, g in enumerate(idx._graphs)]
    idx.remove_ids(entry_uids)
    idx.vacuum()
    idx.add(wl.base[:8] + 0.01)
    for s, g in enumerate(idx._graphs):
        assert int(idx._global_ids[s][g.entry_point]) not in entry_uids
        assert g.levels[g.entry_point] == g.max_level
        assert (g.neighbors0[g.entry_point] >= 0).any()
    _, i = idx.search(wl.base[:8] + 0.01, k=1, ef_search=32)
    np.testing.assert_array_equal(i[:, 0], np.arange(4000, 4008))
