"""``ops/storage.py``: the stored rows and their codec as one object.

Its host encode is the reference's x̂ bit for bit, and the codes it writes
decode to that x̂; flat rows are written and read unchanged; its exact
distance routes agree with each other and with float64 over the decoded
rows; the codec's tensors are made once, so two searches key alike on the
storage's own offset and scale, through a second ``add()`` and a
``grow()``, and a staged build keys on them too. Two guards on the
package's layering parse its imports: nothing under ``ops/`` imports the
layers above it, and no module imports a private name of another
subpackage."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hnsw_tpu
import hnsw_tpu_torch
from hnsw_tpu.ops.pq import decode_pq as ref_decode_pq
from hnsw_tpu.ops.pq import encode_pq as ref_encode_pq
from hnsw_tpu_torch import build, graphs, search
from hnsw_tpu_torch.ops.storage import Storage

from torch_threads import one_torch_thread  # noqa: F401  (a fixture)

D, N, PQ_M, KSUB = 16, 400, 4, 16
PKG = pathlib.Path(hnsw_tpu_torch.__file__).parent


def _points(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, D)) * rng.uniform(0.2, 3.0, D)).astype(
        np.float32)


def _codebooks(seed=1):
    return np.random.default_rng(seed).normal(
        size=(PQ_M, KSUB, D // PQ_M)).astype(np.float32)


def _codec_case(codec):
    """(storage with the codec and N empty rows, points, the reference's
    x̂ of the points)."""
    if codec == "sq8":
        ref = hnsw_tpu.HnswIndex(D, 8, capacity=64, dtype="sq8")
        x = _points()
        ref.train(x)
        q = x * 1.2 + 0.1                          # clips at both ends too
        st = Storage(torch.zeros((N, D), dtype=torch.uint8), sq=ref._sq_np)
        return st, q, ref._sq_encode(q)
    cb = _codebooks()
    rng = np.random.default_rng(2)
    # points near drawn centroids: no near-tie between two codes
    codes = rng.integers(0, KSUB, size=(N, PQ_M))
    x = np.concatenate([cb[j, codes[:, j]] for j in range(PQ_M)], 1)
    x = (x + rng.normal(scale=1e-3, size=x.shape)).astype(np.float32)
    want = np.asarray(ref_decode_pq(ref_encode_pq(jnp.asarray(x),
                                                  jnp.asarray(cb)),
                                    jnp.asarray(cb)))
    st = Storage(torch.zeros((N, PQ_M), dtype=torch.uint8), pq=cb)
    return st, x, want


@pytest.mark.parametrize("codec", ["sq8", "pq"])
def test_host_encode_is_the_reference_xhat(codec):
    """``encode`` gives the reference's x̂ bit for bit, and the codes
    ``write`` stores from x̂ decode to that x̂ again."""
    st, x, want = _codec_case(codec)
    xhat = st.encode(x)
    assert xhat.dtype == np.float32
    np.testing.assert_array_equal(xhat, want)
    st.write(slice(None), torch.from_numpy(xhat))
    np.testing.assert_array_equal(st.decode(st.rows).numpy(), xhat)
    ids = torch.tensor([3, 0, 3, N - 1])
    np.testing.assert_array_equal(st.read(ids).numpy(), xhat[ids.numpy()])


@pytest.mark.parametrize("codec", ["sq8", "pq"])
def test_codec_arrays_round_trip(codec):
    """The codec's save arrays under the reference's npz keys; a storage
    set from them encodes alike, with its own tensors on its device."""
    st, x, _ = _codec_case(codec)
    arrays = st.codec_arrays()
    keys = {"sq8": {"sq_offset", "sq_scale"}, "pq": {"pq_codebooks"}}
    assert set(arrays) == keys[codec] and st.coded
    other = Storage(torch.zeros_like(st.rows))
    assert not other.coded and other.codec_arrays() == {}
    other.set_codec(arrays)
    np.testing.assert_array_equal(other.encode(x), st.encode(x))
    for a, b in zip(other.refs()[1:], st.refs()[1:]):
        assert a is not b and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_rows_write_and_read_unchanged(dtype):
    """Flat storage: ``encode`` is the identity, ``write`` stores the rows
    in the storage's dtype (bf16 rounds to nearest even, as ``.to``) and
    ``decode`` widens them to f32 unchanged; ``refs`` is the rows alone."""
    x = _points(64)
    st = Storage(torch.zeros((100, D), dtype=dtype))
    assert st.encode(x) is x and not st.coded and st.dim == D
    st.write(torch.arange(10, 74), torch.from_numpy(x))
    want = torch.from_numpy(x).to(dtype)
    assert torch.equal(st.rows[10:74], want)
    assert (st.rows[:10] == 0).all() and (st.rows[74:] == 0).all()
    assert torch.equal(st.read(torch.arange(10, 74)), want.float())
    assert len(st.refs()) == 1 and st.refs()[0] is st.rows


@pytest.mark.parametrize("codec", ["float32", "bfloat16", "sq8", "pq"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_distance_routes_agree(codec, metric):
    """``distance_fn``, ``hop_distances`` and ``rerank`` on the same ids:
    the surrogate over x̂ (float64 reference within 1e-4), the hop form
    equal to the ids form where a candidate exists (+inf or unread
    elsewhere), and ``exact_topk``'s ids the float64 top-k over x̂ (up to
    the order of ties)."""
    rng = np.random.default_rng(7)
    x = _points(N, seed=3)
    if codec in ("sq8", "pq"):
        st, x, _ = _codec_case(codec)
        st.write(slice(None), torch.from_numpy(st.encode(x)))
    else:
        st = Storage(torch.zeros((N, D), dtype=getattr(torch, codec)))
        st.write(slice(None), torch.from_numpy(x))
    xhat = st.decode(st.rows).double()
    q = torch.from_numpy(rng.normal(size=(20, D)).astype(np.float32))
    nbrs = torch.from_numpy(rng.integers(-1, N, size=(N, 8)).astype(np.int32))
    cur = torch.from_numpy(rng.integers(0, N, size=20).astype(np.int32))
    ids = nbrs[cur.long()]
    ok = ids >= 0
    dist = st.distance_fn(q, metric)
    got = dist(ids, ok)
    rows = xhat[torch.where(ok, ids, 0).long()]
    dots = (rows * q.double()[:, None, :]).sum(-1)
    want = -dots if metric == "ip" else (rows * rows).sum(-1) - 2 * dots
    np.testing.assert_allclose(got[ok].numpy(), want[ok].numpy(),
                               rtol=1e-4, atol=1e-3)
    hop = st.hop_distances(q, nbrs, metric, dist)(cur)
    assert torch.equal(hop[ok], got[ok])
    rr = st.rerank(torch.where(ok, ids, -1), q, metric)
    assert torch.equal(rr[ok], got[ok])
    _, top = st.exact_topk(q, 5, metric, N)
    full = q.double() @ xhat.T
    ref = -full if metric == "ip" else (xhat * xhat).sum(1)[None] - 2 * full
    np.testing.assert_allclose(
        ref.gather(1, top).numpy(),
        torch.topk(ref, 5, largest=False).values.numpy(), rtol=1e-5,
        atol=1e-4)


@pytest.fixture(scope="module")
def sq8_index():
    wl = hnsw_tpu_torch.synthetic_workload(900, D, n_queries=16, seed=4)
    idx = hnsw_tpu_torch.HnswIndex(D, 8, capacity=1024, ef_construction=40,
                                   dtype="sq8", device="cpu")
    idx.train(wl.base)
    idx.add(wl.base[:600])
    return idx, wl


def _key_and_refs(idx, queries):
    g, st, q, kw = idx._search_call(queries, 5)
    _, key, refs, _ = search._plan(g, st, q, **kw)
    assert key == search.search_key(g, st, q, **kw)
    return key, refs


def test_search_keys_hold_the_storage_codec(sq8_index, monkeypatch):
    """Two searches key alike, on the storage's own offset and scale (the
    same objects in both), through a second ``add()`` and a ``grow()``:
    the codec's tensors are made once, and ``grow`` pads only the
    capacity-sized rows. The staged build of that ``add()`` keys on the
    same codec tensors, not copies."""
    idx, wl = sq8_index
    st = idx._storage
    off, sc = st.sq
    first, refs1 = _key_and_refs(idx, wl.queries)
    second, refs2 = _key_and_refs(idx, wl.queries)
    assert first == second
    for refs in (refs1, refs2):
        assert any(t is off for t in refs) and any(t is sc for t in refs)
        assert any(t is st.rows for t in refs)
    for t in (off, sc, st.rows):
        assert graphs.tensor_identity(t) in first[-1]
    runs = []
    real = build.StagedBuild.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        runs.append(list(self.refs))
    monkeypatch.setattr(build.StagedBuild, "__init__", spy)
    idx.add(wl.base[600:])
    assert runs and all(any(t is off for t in r) and any(t is sc for t in r)
                        for r in runs)
    assert idx._storage is st and st.sq[0] is off and st.sq[1] is sc
    third, _ = _key_and_refs(idx, wl.queries)
    assert third == _key_and_refs(idx, wl.queries)[0]
    rows_before = st.rows
    idx.grow(2048)
    assert st.rows is not rows_before and st.rows.shape[0] == 2048
    assert st.sq[0] is off and st.sq[1] is sc
    assert torch.equal(st.rows[:idx.ntotal], rows_before[:idx.ntotal])
    grown, refs = _key_and_refs(idx, wl.queries)
    assert grown == _key_and_refs(idx, wl.queries)[0]
    assert any(t is off for t in refs) and any(t is st.rows for t in refs)


def _imports(path: pathlib.Path):
    """(module it names, [imported names]) of every import in ``path``,
    relative imports resolved against the package."""
    rel = path.relative_to(PKG.parent).with_suffix("")
    pkg = list(rel.parts[:-1])
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, []
        elif isinstance(node, ast.ImportFrom):
            base = pkg[:len(pkg) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            yield mod, [a.name for a in node.names]


def _modules():
    return sorted(p for p in PKG.rglob("*.py") if "_build" not in p.parts)


def test_ops_import_nothing_above():
    """No module under ``ops/`` imports the search, the build, the
    models, the shards, the serving front end, the factory or the dry run
    (``from .. import search`` counts too)."""
    above = {f"hnsw_tpu_torch.{m}" for m in (
        "search", "build", "models", "parallel", "serving", "factory",
        "dryrun")}
    bad = []
    for path in _modules():
        if path.parent.name != "ops":
            continue
        for mod, names in _imports(path):
            targets = [mod] + [f"{mod}.{n}" for n in names]
            for t in targets:
                if any(t == a or t.startswith(a + ".") for a in above):
                    bad.append((path.name, t))
    assert not bad, bad


def test_no_private_names_across_subpackages():
    """No module imports a ``_``-prefixed name from a module of another
    subpackage (``hnsw_tpu_torch`` itself, ``ops``, ``models``,
    ``parallel``, ...): what crosses a package line is public."""
    bad = []
    for path in _modules():
        here = ".".join(path.relative_to(PKG.parent).parts[:-1])
        for mod, names in _imports(path):
            if not mod.startswith("hnsw_tpu_torch"):
                continue
            target = PKG.parent.joinpath(*mod.split("."))
            # the subpackage the names come from: a package's own, or the
            # package holding the module
            there = mod if target.is_dir() else mod.rpartition(".")[0]
            if there != here:
                bad += [(str(path.relative_to(PKG)), mod, n) for n in names
                        if n.startswith("_")]
    assert not bad, bad
