"""The port's mutable index against the reference, on the CPU: packed rows
kept across add() (``row_fingerprints``, ``update_packed_rows``,
``update_packed_pq_rows``, ``HnswIndex._refresh_packed``), tombstones and
``vacuum`` / ``compacted``. Twins of the packed-maintenance cases of
tests/test_packed.py, tests/test_packed_words.py and tests/test_pq.py, of
tests/test_deletion.py and of the unsharded tests/test_vacuum.py (range
search, grow, the tuners and merge_from: tests/test_torch_index_api.py).

Graphs are shared by loading the port's save into the reference, so both
packages maintain, vacuum and search the same graph."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hnsw_tpu
import hnsw_tpu_torch
from hnsw_tpu.ops import packed as ref_packed
from hnsw_tpu.utils.recall import recall_at_k
from hnsw_tpu_torch.ops import packed
from hnsw_tpu_torch.ops.packed import (_pack_nibbles, pack_neighbors,
                                       quantize_codes)
from hnsw_tpu_torch.ops.storage import Storage

from conftest import exact_knn
from torch_threads import one_torch_thread  # noqa: F401  (a fixture)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def port_index(n, d=24, m=8, metric="l2", seed=7, capacity=None, efc=60,
               **kw):
    """A port index over ``synthetic_workload(n, d, seed=seed)`` and the
    workload."""
    wl = hnsw_tpu_torch.synthetic_workload(n, d, n_queries=128,
                                           metric=metric, seed=seed)
    idx = hnsw_tpu_torch.HnswIndex(d, m, metric, device="cpu",
                                   capacity=capacity or n + 512,
                                   ef_construction=efc, **kw)
    idx.train(wl.base)
    idx.add(wl.base)
    return idx, wl


def copy_of(idx):
    return hnsw_tpu_torch.HnswIndex.from_bytes(idx.to_bytes(), device="cpu")


def ref_of(idx):
    """The reference's index loaded from the port's save."""
    return hnsw_tpu.HnswIndex.from_bytes(idx.to_bytes())


def assert_same_search(got, want):
    """The port's (D, I) against the reference's on the same graph and
    queries: ids >= 99% equal (the bar of the search parity tests) and
    distances within rtol 1e-5 where they agree."""
    (d, i), (rd, ri) = got[:2], want[:2]
    same = np.asarray(i) == np.asarray(ri)
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(np.asarray(d)[same], np.asarray(rd)[same],
                               rtol=1e-5, atol=1e-5)


def assert_same_arrays(port, ref):
    """Graph, stored vectors, capacity and tombstones equal."""
    assert port.config.to_json() == ref.config.to_json()
    for k, v in port.graph.numpy().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ref.graph, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(port.vectors.numpy(),
                                  np.asarray(ref.vectors))
    assert (port._alive is None) == (ref._alive is None)
    if port._alive is not None:
        np.testing.assert_array_equal(port._alive.numpy(),
                                      np.asarray(ref._alive))


def live_truth(base, queries, alive, k):
    live = np.flatnonzero(alive)
    _, gt = exact_knn(base[live], queries, k, "l2")
    return live[gt]


@pytest.fixture(scope="module")
def f32():
    """3,000 x 24 f32 index (m=8): the shared graph."""
    return port_index(3000, capacity=4096)


# ---------------------------------------------------------------------------
# row maintenance: ops against the reference
# ---------------------------------------------------------------------------

def test_row_fingerprints_match_reference(monkeypatch):
    """Bit for bit, on ids over the whole int32 range, -1 pads and rows of
    only pads (int64 here, the reference's uint32 values), over several
    256-row steps of the loop."""
    monkeypatch.setattr(packed, "_FP_CHUNK", 256)
    rng = np.random.default_rng(0)
    nb = rng.integers(-1, 2 ** 31 - 1, size=(700, 64)).astype(np.int32)
    nb[rng.random(nb.shape) < 0.3] = -1
    nb[:3] = -1
    want = np.asarray(ref_packed.row_fingerprints(jnp.asarray(nb)))
    got = packed.row_fingerprints(t(nb))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def maintenance_case(seed, n=600, m0=16, d=20, cap=700):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(cap, d)).astype(np.float32)
    nb = rng.integers(0, n, size=(cap, m0)).astype(np.int32)
    nb[rng.random(nb.shape) < 0.2] = -1
    nb[n:] = -1
    levels = np.where(np.arange(cap) < n, 0, -1).astype(np.int32)
    nb2 = nb.copy()
    moved = rng.choice(n, 150, replace=False)
    nb2[moved] = rng.integers(-1, n, size=(150, m0))
    ids = np.full(192, -1, np.int32)
    ids[:170] = np.r_[moved, rng.choice(n, 20)][:170]
    rng.shuffle(ids)
    return x, nb, nb2, levels, ids


@pytest.mark.parametrize("kind", ["bytes8", "bytes4", "words8", "sq8"])
def test_update_packed_rows_match_reference(kind):
    """Tables packed by both packages with chunk=256 (pad rows included)
    are equal; ``update_packed_rows`` of the same ids (−1 pads among them)
    after a change of adjacency leaves them equal again: codes bit for
    bit, ``nbr_sq`` within rtol 1e-6 (sums of d terms in another order)."""
    x, nb, nb2, levels, ids = maintenance_case(1)
    bits = 4 if kind == "bytes4" else 8
    layout = "words" if kind == "words8" else "bytes"
    vec, deq, rdeq = x, None, None
    if kind == "sq8":
        off, sc = packed.quantization_params(t(x), t(levels >= 0), 8)
        vec = quantize_codes(t(x), off, sc, 8).numpy()
        deq, rdeq = (off, sc), (jnp.asarray(off.numpy()),
                                jnp.asarray(sc.numpy()))
    kw = dict(bits=bits, n_rows=600, chunk=256, layout=layout)
    ref = ref_packed.pack_neighbors(jnp.asarray(nb), jnp.asarray(vec),
                                    jnp.asarray(levels), dequant=rdeq, **kw)
    st = Storage(t(vec), sq=deq)
    port = pack_neighbors(t(nb), st, t(levels), **kw)
    assert port.nbr_codes.shape == (768, ref.nbr_codes.shape[1])
    np.testing.assert_array_equal(port.nbr_codes.numpy(),
                                  np.asarray(ref.nbr_codes))
    np.testing.assert_allclose(port.nbr_sq.numpy(), np.asarray(ref.nbr_sq),
                               rtol=1e-6)
    rc, rs = ref_packed.update_packed_rows(
        ref.nbr_codes, ref.nbr_sq, jnp.asarray(nb2), jnp.asarray(vec),
        ref.offset, ref.scale, jnp.asarray(ids), rdeq, bits=bits)
    pc, ps = packed.update_packed_rows(
        port.nbr_codes, port.nbr_sq, t(nb2), st, port.offset, port.scale,
        t(ids), bits=bits)
    assert pc is port.nbr_codes                        # in place
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), rtol=1e-6)
    # and it is the table a fresh pack of the new adjacency holds there
    fresh = pack_neighbors(t(nb2), st, t(levels), **kw)
    rows = np.unique(ids[ids >= 0])
    np.testing.assert_array_equal(pc.numpy()[rows],
                                  fresh.nbr_codes.numpy()[rows])


@pytest.mark.parametrize("pq_bits", [8, 4])
def test_update_packed_pq_rows_match_reference(pq_bits):
    x, nb, nb2, _, ids = maintenance_case(2)
    rng = np.random.default_rng(3)
    pm, ksub = 6, 1 << pq_bits
    codes = rng.integers(0, ksub, size=(x.shape[0], pm)).astype(np.uint8)
    cb = rng.normal(size=(pm, ksub, 2)).astype(np.float32)
    ref = ref_packed.pack_pq_neighbors(jnp.asarray(nb), jnp.asarray(codes),
                                       cb, pq_bits=pq_bits, n_rows=600,
                                       chunk=256)
    port = packed.pack_pq_neighbors(t(nb), t(codes), t(cb), pq_bits=pq_bits,
                                    n_rows=600, chunk=256)
    np.testing.assert_array_equal(port.nbr_codes.numpy(),
                                  np.asarray(ref.nbr_codes))
    want = ref_packed.update_packed_pq_rows(
        ref.nbr_codes, jnp.asarray(nb2), jnp.asarray(codes),
        jnp.asarray(ids), pq_bits=pq_bits)
    got = packed.update_packed_pq_rows(port.nbr_codes, t(nb2), t(codes),
                                       t(ids), pq_bits=pq_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# add() with live tables: twins, and the same refresh as the reference
# ---------------------------------------------------------------------------

def test_packed_survives_add_and_use_packed_flag(f32):
    idx, wl = f32
    idx = copy_of(idx)
    idx.enable_packed()
    idx.add(wl.base[:8])
    assert idx.packed_enabled
    # the added rows are copies of ids 0..7: either copy is nearest
    d, i = idx.search(wl.base[:4], 1, ef_search=64, use_packed=True)
    ok = (i[:, 0] == np.arange(4)) | (i[:, 0] == 3000 + np.arange(4))
    assert ok.all() and np.allclose(d[:, 0], 0.0, atol=1e-5), (i[:, 0], d)
    idx.disable_packed()
    with pytest.raises(ValueError, match="use_packed"):
        idx.search(wl.queries[:4], 5, use_packed=True)
    d, i = idx.search(wl.queries[:4], 5, use_packed=False)
    assert i.shape == (4, 5)


@pytest.mark.parametrize("bits", [8, 4])
def test_incremental_packed_maintenance_parity(f32, bits):
    """After enable_packed(), add() leaves the tables equal to a re-pack of
    the current adjacency under the RETAINED quantization (the rows the
    build changed and the new ids re-packed in place)."""
    idx, wl = f32
    idx = copy_of(idx)
    extra = hnsw_tpu_torch.synthetic_workload(200, 24, n_queries=1,
                                              seed=31).base
    idx.enable_packed(bits=bits, reserve=256, chunk=256)
    pad_cap = idx._packed.nbr_sq.shape[0]
    offset, scale = idx._packed.offset.clone(), idx._packed.scale.clone()
    idx.add(extra)
    assert idx.packed_enabled and idx._last_refresh["branch"] == \
        "incremental"
    pk, n = idx._packed, idx.ntotal
    assert n <= pad_cap == pk.nbr_sq.shape[0]
    assert torch.equal(pk.offset, offset) and torch.equal(pk.scale, scale)
    codes_all = quantize_codes(idx.vectors, offset, scale, bits).numpy()
    xhat = offset.numpy() + scale.numpy() * codes_all.astype(np.float32)
    safe = np.maximum(idx.graph.neighbors0[:n].numpy(), 0)
    want = codes_all[safe]
    if bits == 4:
        want = _pack_nibbles(t(want)).numpy()
    np.testing.assert_array_equal(pk.nbr_codes[:n].numpy(),
                                  want.reshape(n, -1))
    np.testing.assert_allclose(pk.nbr_sq[:n].numpy(),
                               (xhat ** 2).sum(1)[safe], rtol=1e-5,
                               atol=1e-5)
    _, ii = idx.search(extra[:32], 1, ef_search=64, use_packed=True)
    assert (ii[:, 0] == np.arange(3000, 3032)).mean() >= 0.9


def test_packed_full_repack_when_headroom_exhausted():
    """An add past the table's rows re-packs in full (retrained) instead of
    serving a truncated table."""
    wl = hnsw_tpu_torch.synthetic_workload(1300, 24, n_queries=8, seed=37)
    idx = hnsw_tpu_torch.HnswIndex(24, 8, "l2", device="cpu", capacity=2048,
                                   ef_construction=60)
    idx.add(wl.base[:1000])
    idx.enable_packed(bits=8)   # chunk-aligned pad == n: no headroom
    assert idx._packed.nbr_sq.shape[0] == 1000
    idx.add(wl.base[1000:1300])
    assert idx.packed_enabled and idx._last_refresh["branch"] == "full"
    assert idx._packed.nbr_sq.shape[0] >= 1300
    _, ii = idx.search(wl.base[1000:1016], 1, ef_search=64, use_packed=True)
    assert (ii[:, 0] == np.arange(1000, 1016)).mean() >= 0.9


def test_packed_composes_with_filters_and_deletion(f32):
    idx, wl = f32
    idx = copy_of(idx)
    flat = hnsw_tpu_torch.FlatIndex(24, "l2", device="cpu")
    flat.add(wl.base)
    _, gt = flat.search(wl.queries, 1)
    victim = int(gt[0, 0])
    idx.enable_packed()
    idx.remove_ids(np.asarray([victim]))
    assert idx.packed_enabled        # deletion filters results, not routing
    _, i = idx.search(wl.queries[:1], 5, ef_search=64)
    assert victim not in i[0]
    allowed = np.zeros(idx.config.capacity, bool)
    allowed[:200] = True
    _, i = idx.search(wl.queries[:8], 5, ef_search=128, allowed=allowed)
    assert (i[i >= 0] < 200).all()


def test_words_layout_incremental_maintenance(f32):
    idx, wl = f32
    idx = copy_of(idx)
    idx.enable_packed(bits=8, layout="words")
    idx.add(wl.base[:8])
    assert idx.packed_enabled and idx._packed.layout == "words"
    fresh = pack_neighbors(idx.graph.neighbors0, idx._storage,
                           idx.graph.levels, bits=8, n_rows=idx.ntotal,
                           layout="words")
    n = idx.ntotal
    assert torch.equal(idx._packed.nbr_codes[:n], fresh.nbr_codes[:n])
    assert torch.equal(idx._packed.nbr_sq[:n], fresh.nbr_sq[:n])
    d, i = idx.search(wl.base[:4], 1, ef_search=64, use_packed=True)
    ok = (i[:, 0] == np.arange(4)) | (i[:, 0] == 3000 + np.arange(4))
    assert ok.all() and np.allclose(d[:, 0], 0.0, atol=1e-5)


def test_pq_packed_incremental_add():
    """PQ storage: add() keeps the PackedPQ rows; the search then equals
    one on a fresh re-pack."""
    idx, wl = port_index(1500, dtype="pq", pq_m=8, capacity=2048)
    idx.enable_packed(reserve=256)
    idx.add(np.asarray(wl.base[:128] + 0.01, np.float32))
    assert idx.packed_enabled and idx._last_refresh["branch"] == \
        "incremental"
    d1, i1 = idx.search(wl.queries, 10, ef_search=96)
    idx.disable_packed()
    idx.enable_packed(reserve=0)
    d2, i2 = idx.search(wl.queries, 10, ef_search=96)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["bytes chunk=256", "bytes no headroom",
                                  "words chunk=256", "pq rows chunk=256"])
def test_refresh_takes_the_reference_branch(f32, case, monkeypatch):
    """The same add() on both packages: the port adds; the reference, given
    the port's pre-add tables' fingerprints and then the port's post-add
    graph, runs its own ``_refresh_packed``. Both take the same branch
    (incremental or full re-pack) and leave equal tables (codes bit for
    bit, ``nbr_sq`` within rtol 1e-6)."""
    idx, wl = f32
    if case.startswith("pq"):
        idx, wl = port_index(1500, dtype="pq", pq_m=8, capacity=2048)
    port = copy_of(idx)
    ref = ref_of(idx)
    opts = {"bytes chunk=256": dict(bits=8, chunk=256),
            "bytes no headroom": dict(bits=8),
            "words chunk=256": dict(bits=4, layout="words", chunk=256),
            "pq rows chunk=256": dict(chunk=256, reserve=64)}[case]
    port.enable_packed(**opts)
    ref.enable_packed(**opts)
    fp_old = ref_packed.row_fingerprints(ref.graph.neighbors0)
    packed_was, old_n = ref._packed, ref.ntotal
    port.add(np.asarray(wl.base[:40] + 0.02, np.float32))
    after = ref_of(port)
    ref._graph, ref._vectors, ref._sqnorms = (after._graph, after._vectors,
                                              after._sqnorms)
    calls = []
    enable = ref.enable_packed
    monkeypatch.setattr(ref, "enable_packed",
                        lambda **kw: calls.append(kw) or enable(**kw))
    ref._refresh_packed(packed_was, fp_old, old_n)
    branch = "full" if calls else "incremental"
    assert port._last_refresh["branch"] == branch
    assert branch == ("full" if case == "bytes no headroom"
                      else "incremental")
    assert ref.packed_enabled and port.packed_enabled
    np.testing.assert_array_equal(port._packed.nbr_codes.numpy(),
                                  np.asarray(ref._packed.nbr_codes))
    if not case.startswith("pq"):
        np.testing.assert_allclose(port._packed.nbr_sq.numpy(),
                                   np.asarray(ref._packed.nbr_sq), rtol=1e-6)
        np.testing.assert_array_equal(port._packed.offset.numpy(),
                                      np.asarray(ref._packed.offset))


@pytest.mark.parametrize("drop", ["disable_packed", "vacuum"])
def test_pq_routing_codes_follow_adds_without_tables(f32, drop):
    """PQ routing rows over f32 storage: an add() while the tables are
    dropped (disable_packed(), or vacuum()) still encodes the new ids'
    routing codes, so a later enable_packed(mode="pq") on the kept
    codebooks packs the rows a fresh pack of those codebooks holds (the
    reference routes such ids on stale codes: ROADMAP.md Queue C)."""
    from hnsw_tpu_torch.ops.pq import encode_pq
    idx, wl = f32
    idx = copy_of(idx)
    idx.enable_packed(mode="pq", pq_m=4, train_x=wl.base)
    cb = idx._route[0]
    if drop == "vacuum":
        idx.remove_ids(np.arange(0, 3000, 7))
        idx.vacuum()
    else:
        idx.disable_packed()
    assert not idx.packed_enabled
    idx.add(hnsw_tpu_torch.synthetic_workload(64, 24, n_queries=1,
                                              seed=9).base)
    idx.enable_packed(mode="pq")
    assert idx._route[0] is cb
    n = idx.ntotal
    codes = encode_pq(idx.vectors[:n], cb)
    assert torch.equal(idx._route[1][:n], codes)
    fresh = packed.pack_pq_neighbors(idx.graph.neighbors0, codes, cb,
                                     n_rows=n)
    assert torch.equal(idx._packed.nbr_codes[:n], fresh.nbr_codes[:n])



# ---------------------------------------------------------------------------
# tombstones (twins of tests/test_deletion.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def didx():
    """2,000 x 16 index with every 4th id removed (and what remove_ids
    returned), and the reference's load of it (the same graph and
    tombstones): each test reads them the same way in any order."""
    idx, wl = port_index(2000, d=16, seed=61, capacity=2048)
    newly = idx.remove_ids(np.arange(0, 2000, 4))
    return idx, wl, newly, ref_of(idx)


def test_removed_ids_never_returned(didx, monkeypatch):
    """Filtered by tombstones, as the reference's search of the same graph
    and tombstones (its K1 in interpret mode) filters."""
    idx, wl, newly, ref = didx
    removed = np.arange(0, 2000, 4)
    assert newly == len(removed)
    assert idx.n_deleted == ref.n_deleted == len(removed)
    got = idx.search(wl.queries, k=10, ef_search=96)
    assert not np.isin(got[1][got[1] >= 0], removed).any()
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    assert_same_search(got, ref.search(wl.queries, k=10, ef_search=96))
    assert idx.remove_ids(removed[:10]) == 0          # again: a no-op


def test_recall_on_survivors(didx, monkeypatch):
    idx, wl, _, ref = didx
    alive = np.arange(2000) % 4 != 0
    got = idx.search(wl.queries, k=10, ef_search=128)
    assert recall_at_k(got[1], live_truth(wl.base, wl.queries, alive, 10),
                       10) >= 0.85
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    assert_same_search(got, ref.search(wl.queries, k=10, ef_search=128))


def test_composes_with_user_filter(didx, monkeypatch):
    idx, wl, _, ref = didx
    user = np.zeros(2000, bool)
    user[:1000] = True
    got = idx.search(wl.queries[:20], k=5, ef_search=96, allowed=user)
    i = got[1][got[1] >= 0]
    assert (i < 1000).all() and (i % 4 != 0).all()
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    assert_same_search(got, ref.search(wl.queries[:20], k=5, ef_search=96,
                                       allowed=user))


def test_deletion_survives_save_load(didx, tmp_path, monkeypatch):
    """Either package's load of the port's file filters alike."""
    idx, wl = didx[:2]
    p = str(tmp_path / "del.npz")
    idx.save(p)
    idx2 = hnsw_tpu_torch.HnswIndex.load(p, device="cpu")
    ref2 = hnsw_tpu.HnswIndex.load(p)
    assert idx2.n_deleted == idx.n_deleted == ref2.n_deleted
    assert not idx2._routing_clean and not ref2._routing_clean
    got = idx2.search(wl.queries[:20], k=5, ef_search=96)
    assert (got[1][got[1] >= 0] % 4 != 0).all()
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    assert_same_search(got, ref2.search(wl.queries[:20], k=5, ef_search=96))


def test_remove_out_of_range(didx):
    idx = didx[0]
    with pytest.raises(IndexError):
        idx.remove_ids([99999])


def test_tombstoned_files_load_both_ways(didx, tmp_path):
    """Files with tombstones written by either package, before and after
    vacuum(), load in the other with the same mask, flag and graph; a
    pre-vacuum file keeps filtering."""
    idx, wl = didx[:2]
    ref = ref_of(idx)                                 # port -> reference
    np.testing.assert_array_equal(np.asarray(ref._alive),
                                  idx._alive.numpy())
    assert not ref._routing_clean
    ref.remove_ids(np.arange(1, 40, 4))
    p = str(tmp_path / "pre.npz")
    ref.save(p)                                       # reference -> port
    pre = hnsw_tpu_torch.HnswIndex.load(p, device="cpu")
    assert pre.n_deleted == ref.n_deleted and not pre._routing_clean
    _, i = pre.search(wl.queries[:20], 5, ef_search=64)
    assert not np.isin(i[i >= 0], np.flatnonzero(~np.asarray(
        ref._alive)[:2000])).any()
    ref.vacuum()
    ref.save(p)
    post = hnsw_tpu_torch.HnswIndex.load(p, device="cpu")
    assert post._routing_clean
    for k, v in post.graph.numpy().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ref.graph, k)))
    pre.vacuum()                                      # port -> reference
    back = ref_of(pre)
    assert back._routing_clean and back.n_deleted == pre.n_deleted


# ---------------------------------------------------------------------------
# vacuum and compacted (twins of the unsharded tests/test_vacuum.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "sq8"])
def test_vacuum_matches_reference(f32, dtype):
    """vacuum() of the same graph and tombstones in both packages: the same
    level-0 and upper adjacency edge for edge, entry point and max level
    (the port patches only the rows with a dead neighbor, through K3's
    plain version here; the reference computes every row)."""
    idx = f32[0] if dtype == "float32" else \
        port_index(1500, d=16, dtype="sq8", capacity=2048, seed=5)[0]
    port, ref = copy_of(idx), ref_of(idx)
    n = idx.ntotal
    dead = np.random.default_rng(0).choice(n, n // 5, replace=False)
    port.remove_ids(dead)
    ref.remove_ids(dead)
    assert port.vacuum() == ref.vacuum() == len(dead)
    assert port._last_vacuum["level0"] > n // 4
    np.testing.assert_array_equal(port.graph.neighbors0.numpy(),
                                  np.asarray(ref.graph.neighbors0))
    np.testing.assert_array_equal(port.graph.upper_neighbors.numpy(),
                                  np.asarray(ref.graph.upper_neighbors))
    assert port.graph.entry_point == int(ref.graph.entry_point)
    assert port.graph.max_level == int(ref.graph.max_level)


def test_vacuum_noop_without_deletions(f32):
    idx = copy_of(f32[0])
    before = idx.graph.neighbors0.clone()
    assert idx.vacuum() == 0
    assert torch.equal(idx.graph.neighbors0, before)


def test_vacuum_removes_dead_from_routing(f32):
    idx, wl = f32
    idx = copy_of(idx)
    dead = np.random.default_rng(0).choice(3000, 600, replace=False)
    idx.remove_ids(dead)
    assert not idx._routing_clean
    assert idx.vacuum() == 600 and idx._routing_clean
    assert idx.check(strict=True)["links_to_dead"] == 0
    assert (idx.graph.neighbors0[:3000].numpy()[dead] == -1).all()
    assert bool(idx._alive[idx.graph.entry_point])
    alive = np.ones(3000, bool)
    alive[dead] = False
    _, i = idx.search(wl.queries, 10, ef_search=96)
    assert alive[i[i >= 0]].all(), "vacuumed search returned a dead id"
    assert recall_at_k(i, live_truth(wl.base, wl.queries, alive, 10),
                       10) >= 0.9


def test_vacuum_recall_matches_filtered_search(f32):
    idx, wl = f32
    idx = copy_of(idx)
    dead = np.random.default_rng(3).choice(3000, 500, replace=False)
    idx.remove_ids(dead)
    _, i_f = idx.search(wl.queries, 10, ef_search=96)     # filtered
    idx.vacuum()
    _, i_v = idx.search(wl.queries, 10, ef_search=96)     # routed clean
    alive = np.ones(3000, bool)
    alive[dead] = False
    gt = live_truth(wl.base, wl.queries, alive, 10)
    r_f, r_v = recall_at_k(i_f, gt, 10), recall_at_k(i_v, gt, 10)
    assert r_v >= r_f - 0.02, (r_v, r_f)


def test_vacuum_then_add_stays_clean(f32):
    idx, wl = f32
    idx = copy_of(idx)
    idx.remove_ids(np.arange(100))
    idx.vacuum()
    idx.add(np.asarray(wl.base[:64], np.float32) + 0.01)
    _, i = idx.search(wl.queries, 10, ef_search=64)
    assert (i[i >= 0] >= 100).all(), "new links resurrected a dead id"
    assert idx.check(strict=True)["links_to_dead"] == 0


def test_vacuum_all_deleted(f32):
    idx, wl = f32
    idx = copy_of(idx)
    idx.remove_ids(np.arange(3000))
    idx.vacuum()
    assert idx.graph.entry_point == -1
    d, i = idx.search(wl.queries[:8], 5)
    assert (i == -1).all() and np.isinf(d).all()
    idx.check(strict=True)    # an all-dead graph is structurally legal


def test_vacuum_save_load_roundtrip(f32, tmp_path):
    idx, wl = f32
    idx = copy_of(idx)
    idx.remove_ids(np.arange(0, 3000, 5))
    idx.vacuum()
    d1, i1 = idx.search(wl.queries[:32], 5, ef_search=64)
    p = str(tmp_path / "v.npz")
    idx.save(p)
    idx2 = hnsw_tpu_torch.HnswIndex.load(p, device="cpu")
    assert idx2._routing_clean
    d2, i2 = idx2.search(wl.queries[:32], 5, ef_search=64)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)


def test_vacuum_sq8_storage():
    idx, wl = port_index(1500, d=16, dtype="sq8", capacity=2048, seed=5)
    idx.remove_ids(np.arange(0, 1500, 4))
    idx.vacuum()
    assert idx.check(strict=True)["links_to_dead"] == 0
    _, i = idx.search(wl.queries, 5, ef_search=64)
    assert (i[i >= 0] % 4 != 0).all()


def test_compacted_renumbers(f32, monkeypatch):
    """The reference's compacted() of the same graph and tombstones: the
    same old_ids and the same new index, edge for edge, whose searches
    agree (>= 99% equal ids) and find the survivors' neighbours."""
    idx, wl = f32
    idx = copy_of(idx)
    dead = np.arange(0, 3000, 3)
    idx.remove_ids(dead)
    ref = ref_of(idx)
    new, old_ids = idx.compacted(wl.base)
    rnew, rold = ref.compacted(wl.base)
    np.testing.assert_array_equal(old_ids, rold)
    assert new.device == idx.device
    assert new.ntotal == len(old_ids) == 3000 - len(dead)
    assert (old_ids % 3 != 0).all()
    assert_same_arrays(new, rnew)
    got = new.search(wl.queries, 5, ef_search=64)
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    assert_same_search(got, rnew.search(wl.queries, 5, ef_search=64))
    i_new = got[1]
    assert (old_ids[i_new[i_new >= 0]] % 3 != 0).all()
    full = np.where(i_new >= 0, old_ids[np.maximum(i_new, 0)], -1)
    gt = live_truth(wl.base, wl.queries, np.arange(3000) % 3 != 0, 5)
    assert recall_at_k(full, gt, 5) >= 0.9


def test_vacuum_invalidates_packed(f32):
    idx, wl = f32
    idx = copy_of(idx)
    idx.enable_packed()
    idx.remove_ids(np.arange(64))
    idx.vacuum()
    assert not idx.packed_enabled
    idx.enable_packed()
    _, i = idx.search(wl.queries, 5, ef_search=64)
    assert (i[i >= 0] >= 64).all()
