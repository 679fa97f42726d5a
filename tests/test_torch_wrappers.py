"""The port's faiss wrappers against the reference, on the CPU: the vector
transforms and ``PreTransformIndex`` (twins of tests/test_transforms.py),
``IdMapIndex`` (tests/test_idmap.py), ``RefineFlatIndex``
(tests/test_refine.py) and ``index_factory`` (tests/test_factory.py).

Tolerances, set from f32 sums in another order than the reference's:

  * ``RandomRotation.a`` is the same numpy draw: equal bit for bit.
  * PCA: eigenvalues within rtol 1e-5; each row of ``a`` within 1e-5 of the
    reference's up to its sign, on rows whose eigenvalue stands at least 5%
    clear of its neighbours (closer ones may mix); ``b`` likewise.
  * OPQ runs 16 alternations of k-means, which drift apart in another
    order of summation, so it is held two ways: one alternation from the
    same (a, cb), the codebooks within 1e-4 and the rotation within 1e-3
    (on well-conditioned data: see the test), and the final PQ
    reconstruction error within 2% of the reference's.
  * Transforms applied: rtol 1e-5 (atol 1e-5).
  * The refine's (D, I): D within rtol 1e-5, I equal except where two
    candidates' distances tie within that tolerance.

Trained state crosses between the packages both ways: ``state()`` dicts
and the ``.vt.npz``, ``.ids.npy`` and ``.rflat.npz`` files."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hnsw_tpu
import hnsw_tpu_torch
from hnsw_tpu.ops import pq as ref_pq
from hnsw_tpu.ops import transforms as ref_tf
from hnsw_tpu.models.refine import _rerank as ref_rerank
from hnsw_tpu.utils.datasets import synthetic_workload
from hnsw_tpu.utils.recall import recall_at_k
from hnsw_tpu_torch import (FlatIndex, IdMapIndex, PreTransformIndex,
                            RefineFlatIndex)
from hnsw_tpu_torch.models.refine import rerank
from hnsw_tpu_torch.ops import transforms as tf

from torch_threads import one_torch_thread  # noqa: F401  (a fixture)


def factory(d, spec, metric="l2", **kw):
    return hnsw_tpu_torch.index_factory(d, spec, metric, device="cpu", **kw)


def _aniso(n, d, seed=0):
    """Correlated, anisotropic data: the regime PCA and OPQ exist for."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d, d)) * np.linspace(2.0, 0.05, d)[None, :]
    return (rng.standard_normal((n, d)) @ w.T).astype(np.float32)


def assert_same_rows_up_to_sign(a, ref_a, ev, gap=0.05):
    """Rows of ``a`` equal the reference's up to their sign, where the
    eigenvalue ``ev[j]`` stands ``gap`` (relative) clear of its
    neighbours. Returns the signs."""
    sign = np.sign((a * ref_a).sum(1))
    rel = np.abs(np.diff(ev)) / np.abs(ev[:-1])
    clear = np.ones(len(ev), bool)
    clear[:-1] &= rel >= gap
    clear[1:] &= rel >= gap
    assert clear.sum() >= len(ev) // 2, clear
    np.testing.assert_allclose((sign[:, None] * a)[clear], ref_a[clear],
                               atol=1e-5)
    return sign, clear


# ---------------------------------------------------------------------------
# transforms (twins of tests/test_transforms.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d_in,d_out,seed", [(32, 32, 7), (32, 16, 3)])
def test_random_rotation_matches_reference(d_in, d_out, seed):
    t = tf.RandomRotation(d_in, d_out, seed=seed, device="cpu")
    ref = ref_tf.RandomRotation(d_in, d_out, seed=seed)
    np.testing.assert_array_equal(t.a, ref.a)          # bit for bit
    np.testing.assert_allclose(t.a @ t.a.T, np.eye(d_out), atol=1e-5)
    x = np.random.default_rng(0).standard_normal((64, d_in)) \
        .astype(np.float32)
    y = t.apply(x)
    np.testing.assert_allclose(y, ref.apply(x), rtol=1e-5, atol=1e-5)
    if d_out == d_in:   # a rotation keeps norms and inverts exactly
        np.testing.assert_allclose(np.linalg.norm(y, axis=1),
                                   np.linalg.norm(x, axis=1), rtol=1e-4)
        np.testing.assert_allclose(t.reverse_transform(y), x, atol=1e-4)
    yt = t.apply(torch.from_numpy(x))                 # a tensor stays one
    assert isinstance(yt, torch.Tensor)
    np.testing.assert_array_equal(yt.numpy(), y)


def test_l2norm():
    t = tf.NormalizationTransform(8, device="cpu")
    x = np.random.default_rng(1).standard_normal((100, 8)).astype(np.float32)
    y = t.apply(x)
    np.testing.assert_allclose(np.linalg.norm(y, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(y, ref_tf.NormalizationTransform(8).apply(x),
                               rtol=1e-5, atol=1e-6)
    assert np.isfinite(t.apply(np.zeros((3, 8), np.float32))).all()


def test_pca_matches_reference():
    x = _aniso(4096, 24, seed=2)
    t = tf.PCAMatrix(24, 8, device="cpu")
    t.train(x)
    ref = ref_tf.PCAMatrix(24, 8)
    ref.train(x)
    np.testing.assert_allclose(t.eigenvalues, ref.eigenvalues, rtol=1e-5)
    sign, clear = assert_same_rows_up_to_sign(t.a, ref.a, ref.eigenvalues)
    np.testing.assert_allclose((sign * t.b)[clear], ref.b[clear], atol=1e-4)
    # the twin's checks: centered, decorrelated, variances = eigenvalues
    y = t.apply(x)
    np.testing.assert_allclose(y.mean(0), 0.0, atol=1e-2)
    cov = np.cov(y.T)
    np.testing.assert_allclose(cov, np.diag(np.diag(cov)),
                               atol=np.diag(cov).max() * 1e-3)
    ref_ev = np.linalg.eigvalsh(np.cov(x.T))[::-1][:8]
    np.testing.assert_allclose(np.sort(np.diag(cov))[::-1], ref_ev,
                               rtol=5e-3)
    rr = tf.RandomRotation(24, 8, seed=0, device="cpu")
    assert (y ** 2).sum() > (rr.apply(x - x.mean(0)) ** 2).sum()
    # the reference's trained state, carried here, applies as it does there
    carried = tf.VectorTransform.from_state(ref.state(), device="cpu")
    np.testing.assert_allclose(carried.apply(x), ref.apply(x), rtol=1e-5,
                               atol=1e-4)


def test_pca_whitening():
    x = _aniso(4096, 16, seed=4)
    t = tf.PCAMatrix(16, 8, eigen_power=-0.5, device="cpu")
    t.train(x)
    np.testing.assert_allclose(np.var(t.apply(x), axis=0), 1.0, rtol=5e-2)
    ref = ref_tf.PCAMatrix(16, 8, eigen_power=-0.5)
    ref.train(x)
    assert_same_rows_up_to_sign(t.a / t.a.std(1, keepdims=True),
                                ref.a / ref.a.std(1, keepdims=True),
                                ref.eigenvalues)


def test_pca_random_rotation_flag():
    x = _aniso(2048, 16, seed=5)
    t = tf.PCAMatrix(16, 16, random_rotation=True, device="cpu")
    t.train(x)
    np.testing.assert_allclose(t.a @ t.a.T, np.eye(16), atol=1e-4)


def _ref_alternation(x, a, cb, m, ksub, seed, pq_iters=4, max_points=32768):
    """One OPQ alternation of the reference (the body of
    ``hnsw_tpu.ops.transforms.OPQMatrix.train``'s loop), on its own
    functions."""
    n, d_out = len(x), a.shape[0]
    x_dev = jnp.asarray(x)
    xr = np.asarray(ref_tf._apply_linear(
        x_dev, jnp.asarray(a.T.astype(np.float32)),
        jnp.zeros(d_out, jnp.float32)))
    cb = ref_pq.train_pq(xr, m, ksub=ksub, iters=pq_iters, seed=seed,
                         init_cb=cb, max_points=max_points)
    cb_dev = jnp.asarray(cb)
    xh = ref_pq.decode_pq(ref_pq.encode_pq(jnp.asarray(xr), cb_dev), cb_dev)
    g = np.asarray(ref_tf._cross_term(x_dev, xh, chunk=min(n, 32768)),
                   np.float64)
    u, _, vt = np.linalg.svd(g, full_matrices=False)
    return (u @ vt).T, cb


def test_opq_one_alternation_matches_reference():
    """From the same rotation and codebooks (the reference's first
    alternation, carried), one alternation of each package: the new
    codebooks within 1e-4 and the rotation within 1e-3.

    The Procrustes step is ill-conditioned where X and X̂ decorrelate: on
    ``_aniso`` data (scales down to 0.05) the smallest singular value of
    XᵀX̂ is ~2e-3 and f32 sums in another order turn the rotation by up
    to 0.44 in one alternation, in either package alike. So this test
    draws moderately anisotropic data (scales 2.0 to 0.5), where the step
    is well posed; the reconstruction-error test keeps ``_aniso``."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((32, 32)) * np.linspace(2.0, 0.5, 32)[None, :]
    x = (rng.standard_normal((4096, 32)) @ w.T).astype(np.float32)
    m, ksub = 4, 64
    a0 = ref_tf._random_rotation(32, 32, 0).astype(np.float64)
    a1, cb1 = _ref_alternation(x, a0, None, m, ksub, seed=0)
    want_a, want_cb = _ref_alternation(x, a1, cb1, m, ksub, seed=0)
    t = tf.OPQMatrix(32, m, ksub=ksub, seed=0, device="cpu")
    got_a, got_cb = t.alternate(torch.from_numpy(x), a1, cb1, ksub)
    np.testing.assert_allclose(got_cb, want_cb, atol=1e-4)
    np.testing.assert_allclose(got_a, want_a, atol=1e-3)


def test_opq_reconstruction_error_matches_reference():
    """The twin of test_opq_beats_plain_pq, with the port's trained OPQ held
    to the reference's by its PQ reconstruction error (within 2%)."""
    x = _aniso(8192, 32, seed=6)
    m = 4

    def pq_err(xt):
        cb = jnp.asarray(ref_pq.train_pq(xt, m, ksub=64, iters=10, seed=0))
        xh = np.asarray(ref_pq.decode_pq(ref_pq.encode_pq(
            jnp.asarray(xt), cb), cb))
        return float(((xt - xh) ** 2).sum())

    t = tf.OPQMatrix(32, m, ksub=64, niter=8, seed=0, device="cpu")
    t.train(x)
    ref = ref_tf.OPQMatrix(32, m, ksub=64, niter=8, seed=0)
    ref.train(x)
    np.testing.assert_allclose(t.a @ t.a.T, np.eye(32), atol=1e-4)
    err_plain, err_opq, err_ref = (pq_err(x), pq_err(t.apply(x)),
                                   pq_err(ref.apply(x)))
    assert err_opq < 0.9 * err_plain, (err_opq, err_plain)
    assert abs(err_opq - err_ref) <= 0.02 * err_ref, (err_opq, err_ref)


def test_opq_dimension_reducing_starts_from_pca():
    x = _aniso(2048, 24, seed=8)
    t = tf.OPQMatrix(24, 4, 16, ksub=32, niter=2, seed=1, device="cpu")
    t.train(x)
    assert t.a.shape == (16, 24) and (t.b == 0).all()
    np.testing.assert_allclose(t.a @ t.a.T, np.eye(16), atol=1e-4)


def _trained_transforms():
    x = _aniso(2048, 16, seed=9)
    ts = [tf.NormalizationTransform(16, device="cpu"),
          tf.LinearTransform(16, 8, a=np.eye(8, 16, dtype=np.float32),
                             b=np.arange(8, dtype=np.float32), device="cpu"),
          tf.RandomRotation(16, 12, seed=4, device="cpu"),
          tf.PCAMatrix(16, 8, eigen_power=-0.5, device="cpu"),
          tf.OPQMatrix(16, 4, ksub=16, niter=2, seed=2, device="cpu")]
    for t in ts[3:]:
        t.train(x)
    return x, ts


def test_transform_state_crosses_both_ways():
    """Each kind's state() loads in the other package, key for key, and
    applies there as here."""
    x, ts = _trained_transforms()
    for t in ts:
        st = t.state()
        ref = ref_tf.VectorTransform.from_state(st)
        back = tf.VectorTransform.from_state(ref.state(), device="cpu")
        assert type(back) is type(t) and sorted(st) == sorted(ref.state())
        for k, v in st.items():
            np.testing.assert_array_equal(np.asarray(ref.state()[k]),
                                          np.asarray(v), err_msg=k)
        want = ref.apply(x)
        np.testing.assert_allclose(t.apply(x), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(back.apply(x), want, rtol=1e-5,
                                   atol=1e-5)


def test_factory_transform_specs():
    idx = factory(32, "PCA16,HNSW8,Flat")
    assert isinstance(idx, PreTransformIndex)
    assert idx.d == 32 and idx.index.d == 16
    assert not idx.is_trained
    with pytest.raises(ValueError):
        factory(32, "PCA16")                # a transform with no index
    with pytest.raises(ValueError):
        factory(32, "OPQ5,HNSW8,Flat")      # 5 does not divide 32
    chain = factory(32, "PCA16,RR8,HNSW8,Flat")
    assert [t.d_out for t in chain.transforms] == [16, 8]
    opq = factory(32, "OPQ4_16,HNSW8,PQ4")
    assert opq.index.config.is_pq and opq.index.d == 16


def test_pretransform_end_to_end():
    wl = synthetic_workload(3000, 32, n_queries=64, metric="l2", seed=9)
    base, queries = np.asarray(wl.base), np.asarray(wl.queries)
    idx = factory(32, "PCA16,HNSW16,Flat", capacity=4096, ef_construction=60)
    idx.train(base)
    assert idx.is_trained
    idx.add(base)
    assert idx.ntotal == 3000
    _, i = idx.search(queries, 10, ef_search=64)
    # the oracle in the transformed space: the metric the index serves
    t = idx.transforms[0]
    tb, tq = t.apply(base), t.apply(queries)
    gt = np.argsort(((tq[:, None] - tb[None]) ** 2).sum(-1), 1)[:, :10]
    r = recall_at_k(i, gt, 10)
    assert r >= 0.9
    assert idx.reconstruct(5).shape == (32,)
    # the reference's pipeline on the same data and spec
    ref = hnsw_tpu.index_factory(32, "PCA16,HNSW16,Flat", capacity=4096,
                                 ef_construction=60)
    ref.train(base)
    ref.add(base)
    r_ref = recall_at_k(np.asarray(ref.search(queries, 10, ef_search=64)[1]),
                        gt, 10)
    assert abs(r - r_ref) <= 0.02, (r, r_ref)
    lims, d, ri = idx.range_search(queries[:8], float(np.median(
        ((tq[:8, None] - tb[None]) ** 2).sum(-1))))
    assert lims[-1] == len(d) == len(ri)


def test_l2norm_cosine_search():
    """L2norm,HNSW,ip == cosine similarity search (the faiss recipe)."""
    rng = np.random.default_rng(11)
    base = rng.standard_normal((2000, 16)).astype(np.float32) * \
        rng.uniform(0.1, 10.0, (2000, 1)).astype(np.float32)
    queries = rng.standard_normal((32, 16)).astype(np.float32)
    idx = factory(16, "L2norm,HNSW16,Flat", metric="ip", capacity=2048,
                  ef_construction=60)
    idx.train(base)
    idx.add(base)
    _, i = idx.search(queries, 10, ef_search=96)
    cos = (queries / np.linalg.norm(queries, axis=1, keepdims=True)) @ \
        (base / np.linalg.norm(base, axis=1, keepdims=True)).T
    gt = np.argsort(-cos, axis=1)[:, :10]
    assert recall_at_k(i, gt, 10) >= 0.9


def test_pretransform_save_load_across_packages(tmp_path):
    """The port's save loads here and in the reference, and the reference's
    loads here: transforms bit for bit, searches the same."""
    wl = synthetic_workload(1500, 24, n_queries=16, metric="l2", seed=13)
    base, queries = np.asarray(wl.base), np.asarray(wl.queries)
    idx = factory(24, "OPQ4_8,HNSW8,PQ4", capacity=2048, ef_construction=40,
                  seed=1)
    idx.train(base)
    idx.add(base)
    d1, i1 = idx.search(queries, 5, ef_search=48)
    p = str(tmp_path / "pt.npz")
    idx.save(p)
    back = PreTransformIndex.load(p, device="cpu")
    assert len(back.transforms) == 1
    np.testing.assert_array_equal(back.transforms[0].a, idx.transforms[0].a)
    d2, i2 = back.search(queries, 5, ef_search=48)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)
    ref = hnsw_tpu.PreTransformIndex.load(p)
    np.testing.assert_array_equal(ref.transforms[0].a, idx.transforms[0].a)
    _, ri = ref.search(queries, 5, ef_search=48)
    assert (np.asarray(ri) == i1).mean() >= 0.95
    q = str(tmp_path / "ref.npz")
    ref.save(q)
    mine = PreTransformIndex.load(q, device="cpu")
    np.testing.assert_array_equal(mine.transforms[0].a, idx.transforms[0].a)
    np.testing.assert_array_equal(mine.search(queries, 5, ef_search=48)[1],
                                  i1)


# ---------------------------------------------------------------------------
# IdMapIndex (twins of tests/test_idmap.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def built():
    wl = synthetic_workload(1500, 16, n_queries=32, metric="l2", seed=87)
    inner = hnsw_tpu_torch.HnswIndex(16, 8, "l2", capacity=2048,
                                     ef_construction=60, device="cpu")
    idx = IdMapIndex(inner)
    ids = 10_000_000_000 + np.arange(1500, dtype=np.int64) * 7
    idx.add_with_ids(np.asarray(wl.base), ids)
    return idx, wl, ids


def test_search_returns_user_ids(built):
    idx, wl, ids = built
    assert idx.ntotal == 1500
    d, i = idx.search(np.asarray(wl.base[:16], np.float32), 1, ef_search=64)
    np.testing.assert_array_equal(i[:, 0], ids[:16])
    np.testing.assert_allclose(d[:, 0], 0, atol=1e-4)
    _, rows = idx.index.search(np.asarray(wl.queries), 5, ef_search=64)
    _, got = idx.search(np.asarray(wl.queries), 5, ef_search=64)
    np.testing.assert_array_equal(got, ids[rows])


def test_add_requires_ids(built):
    idx, wl, _ = built
    with pytest.raises(RuntimeError, match="add_with_ids"):
        idx.add(np.asarray(wl.base[:4]))
    with pytest.raises(ValueError, match="ids"):
        idx.add_with_ids(np.asarray(wl.base[:4]), np.arange(3))


def test_remove_and_reconstruct_by_user_id(built):
    idx, wl, ids = built
    np.testing.assert_allclose(idx.reconstruct(int(ids[5])),
                               np.asarray(wl.base[5], np.float32), atol=1e-6)
    with pytest.raises(KeyError):
        idx.reconstruct(123)
    assert idx.remove_ids(np.asarray([ids[5], 123])) == 1
    assert idx.index.n_deleted == 1
    _, i = idx.search(np.asarray(wl.base[5:6], np.float32), 5, ef_search=64)
    assert ids[5] not in i


def test_idmap_holes_map_to_minus_one():
    """A search with fewer than k reachable rows returns -1, not the id of
    row 0."""
    x = np.random.default_rng(3).standard_normal((3, 8)).astype(np.float32)
    idx = factory(8, "IDMap,HNSW8", capacity=64)
    idx.add_with_ids(x, np.array([11, 22, 33]))
    d, i = idx.search(x[:2], 5, ef_search=16)
    assert (i[:, 3:] == -1).all() and set(i[0, :3]) == {11, 22, 33}


def test_idmap_factory_and_save_load_across_packages(tmp_path):
    wl = synthetic_workload(600, 12, n_queries=8, metric="l2", seed=88)
    idx = factory(12, "IDMap,HNSW8", capacity=1024, ef_construction=60)
    assert isinstance(idx, IdMapIndex)
    ids = np.arange(600, dtype=np.int64) * 3 + 1
    idx.add_with_ids(np.asarray(wl.base), ids)
    p = str(tmp_path / "idmap.npz")
    idx.save(p)
    d1, i1 = idx.search(np.asarray(wl.queries), 5, ef_search=64)
    back = IdMapIndex.load(p, device="cpu")
    np.testing.assert_array_equal(back.search(np.asarray(wl.queries), 5,
                                              ef_search=64)[1], i1)
    ref = hnsw_tpu.IdMapIndex.load(p)
    np.testing.assert_array_equal(ref._ids, ids)
    assert (ref.search(np.asarray(wl.queries), 5, ef_search=64)[1]
            == i1).mean() >= 0.95
    q = str(tmp_path / "ref.npz")
    ref.save(q)
    mine = IdMapIndex.load(q, device="cpu")
    np.testing.assert_array_equal(mine._ids, ids)
    np.testing.assert_array_equal(mine.search(np.asarray(wl.queries), 5,
                                              ef_search=64)[1], i1)
    with pytest.raises(ValueError, match="IDMap"):
        factory(12, "IDMap")


# ---------------------------------------------------------------------------
# RefineFlatIndex (twins of tests/test_refine.py)
# ---------------------------------------------------------------------------

def assert_same_rerank(got, want, rtol=1e-5):
    """D within rtol; I equal except where the reference's distances tie
    within that tolerance with a neighbour's (either order is right)."""
    (d, i), (rd, ri) = got, [np.asarray(a) for a in want]
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(np.isfinite(d), fin)
    np.testing.assert_allclose(d[fin], rd[fin], rtol=rtol, atol=1e-5)
    tol = rtol * np.abs(rd) + 1e-5
    tie = np.zeros_like(fin)
    with np.errstate(invalid="ignore"):          # inf - inf at the holes
        close = np.abs(np.diff(rd, axis=1)) <= tol[:, 1:]
    tie[:, 1:] |= close
    tie[:, :-1] |= close
    np.testing.assert_array_equal(i[~tie], ri[~tie])


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_rerank_matches_reference_with_holes(metric):
    """``rerank`` (K3's plain version here) against the reference's
    ``_rerank`` on the same store, queries and candidate ids, K=40, with
    -1 holes; a query of only holes comes back (inf or -inf, -1)."""
    rng = np.random.default_rng(5)
    store = rng.standard_normal((500, 24)).astype(np.float32)
    qs = rng.standard_normal((64, 24)).astype(np.float32)
    ids = rng.integers(0, 500, size=(64, 40)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.2] = -1
    ids[3] = -1
    got = rerank(torch.from_numpy(store), torch.from_numpy(qs),
                 torch.from_numpy(ids), k=10, metric=metric)
    want = ref_rerank(jnp.asarray(store), jnp.asarray(qs), jnp.asarray(ids),
                      k=10, metric=metric)
    assert got[1].dtype == torch.int32
    assert_same_rerank((got[0].numpy(), got[1].numpy().astype(np.int64)),
                       want)
    assert (got[1][3] == -1).all() and torch.isinf(got[0][3]).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_refine_matches_reference_on_one_graph(metric):
    """The same sq8 inner index in both packages (the reference's, loaded
    here), the same f32 store: the refined (D, I) agree."""
    rng = np.random.default_rng(21)
    wl = synthetic_workload(1000, 16, n_queries=48, metric=metric, seed=22)
    base, queries = np.asarray(wl.base), np.asarray(wl.queries)
    ref = hnsw_tpu.index_factory(16, "HNSW8,SQ8,RFlat", metric=metric,
                                 capacity=1024, ef_construction=40)
    ref.train(base)
    ref.add(base)
    inner = hnsw_tpu_torch.HnswIndex.from_bytes(ref.index.to_bytes(),
                                                device="cpu")
    idx = RefineFlatIndex(inner, k_factor=ref.k_factor)
    idx._chunks = [base]
    assert idx.device == torch.device("cpu")
    k = int(rng.integers(5, 11))
    got = idx.search(queries, k, ef_search=48)
    assert_same_rerank(got, ref.search(queries, k, ef_search=48))


def test_refine_recovers_sq8_recall():
    wl = synthetic_workload(3000, 32, n_queries=64, metric="l2", seed=21)
    base, queries = np.asarray(wl.base), np.asarray(wl.queries)
    flat = FlatIndex(32, device="cpu")
    flat.add(base)
    gt = flat.search(queries, 10)[1]
    inner = factory(32, "HNSW16,SQ8", capacity=4096, ef_construction=60)
    idx = RefineFlatIndex(inner, k_factor=4.0)
    idx.train(base)
    idx.add(base)
    assert idx.ntotal == 3000
    d, i = idx.search(queries, 10, ef_search=96)
    assert recall_at_k(i, gt, 10) >= 0.95
    _, i_inner = inner.search(queries, 10, ef_search=96)
    assert recall_at_k(i, gt, 10) >= recall_at_k(i_inner, gt, 10)
    # true f32 squared L2, not code-space, ascending with no holes
    np.testing.assert_allclose(d[0, 0], ((queries[0] - base[i[0, 0]]) ** 2)
                               .sum(), rtol=1e-4)
    assert (np.diff(d, axis=1) >= -1e-6).all()


def test_refine_factory_and_k_factor():
    wl = synthetic_workload(2000, 16, n_queries=32, metric="l2", seed=22)
    base, queries = np.asarray(wl.base), np.asarray(wl.queries)
    idx = factory(16, "HNSW16,SQ8,RFlat", capacity=2048, ef_construction=60,
                  k_factor=1.0)
    assert isinstance(idx, RefineFlatIndex)
    idx.train(base)
    idx.add(base)
    flat = FlatIndex(16, device="cpu")
    flat.add(base)
    gt = flat.search(queries, 10)[1]
    r1 = recall_at_k(idx.search(queries, 10, ef_search=96)[1], gt, 10)
    idx.k_factor = 8.0          # mutable, as in faiss
    r8 = recall_at_k(idx.search(queries, 10, ef_search=96)[1], gt, 10)
    assert r8 >= r1
    with pytest.raises(ValueError):
        factory(16, "RFlat")


def test_refine_ip_metric():
    rng = np.random.default_rng(3)
    base = rng.standard_normal((2000, 16)).astype(np.float32)
    queries = rng.standard_normal((32, 16)).astype(np.float32)
    idx = factory(16, "HNSW16,SQ8,RFlat", metric="ip", capacity=2048,
                  ef_construction=60)
    idx.train(base)
    idx.add(base)
    d, i = idx.search(queries, 5, ef_search=64)
    gt = np.argsort(-(queries @ base.T), axis=1)[:, :5]
    assert recall_at_k(i, gt, 5) >= 0.9
    assert (np.diff(d, axis=1) <= 1e-6).all()          # dots descend
    np.testing.assert_allclose(d[0, 0], queries[0] @ base[i[0, 0]],
                               rtol=1e-4)


def test_refine_save_load_across_packages(tmp_path):
    wl = synthetic_workload(1000, 16, n_queries=16, metric="l2", seed=24)
    base, queries = np.asarray(wl.base), np.asarray(wl.queries)
    idx = factory(16, "HNSW8,SQ8,RFlat", capacity=1024, ef_construction=40)
    idx.train(base)
    idx.add(base)
    d1, i1 = idx.search(queries, 5, ef_search=48)
    p = str(tmp_path / "rf.npz")
    idx.save(p)
    back = RefineFlatIndex.load(p, device="cpu")
    assert back.k_factor == idx.k_factor
    d2, i2 = back.search(queries, 5, ef_search=48)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)
    ref = hnsw_tpu.RefineFlatIndex.load(p)
    assert ref.k_factor == idx.k_factor
    np.testing.assert_array_equal(np.asarray(ref._materialize()), base)
    assert_same_rerank((d1, i1), ref.search(queries, 5, ef_search=48))
    q = str(tmp_path / "ref.npz")
    ref.save(q)
    mine = RefineFlatIndex.load(q, device="cpu")
    np.testing.assert_array_equal(mine._materialize().numpy(), base)
    np.testing.assert_array_equal(mine.search(queries, 5, ef_search=48)[1],
                                  i1)


def test_refine_small_index_edge():
    """kk > ntotal clamps; holes (-1) stay holes with inf distances."""
    base = np.random.default_rng(0).standard_normal((8, 16)) \
        .astype(np.float32)
    inner = factory(16, "HNSW8,Flat", capacity=64, ef_construction=20)
    idx = RefineFlatIndex(inner, k_factor=16.0)
    idx.add(base)
    d, i = idx.search(base[:2], 12, ef_search=32)
    assert (i[:, :8] >= 0).all() and (i[:, 8:] == -1).all()
    assert np.isinf(d[:, 8:]).all()
    assert i[0, 0] == 0 and d[0, 0] < 1e-5     # self-queries first
    empty = RefineFlatIndex(factory(16, "HNSW8,Flat", capacity=64))
    d, i = empty.search(base[:2], 3)
    assert (i == -1).all() and np.isinf(d).all()


def test_refine_over_idmap_takes_the_inner_device():
    """With no ``device``, the refine's store goes where the wrapped index
    lives, also through an IdMapIndex (which forwards ``device``): the
    factory's ``IDMap,...,RFlat`` with no ``device`` builds so."""
    inner = IdMapIndex(hnsw_tpu_torch.HnswIndex(16, 8, capacity=512,
                                                device="cpu"))
    assert inner.device == torch.device("cpu")
    assert RefineFlatIndex(inner).device == torch.device("cpu")
    spec = factory(16, "IDMap,HNSW8,SQ8,RFlat", capacity=512)
    assert spec.device == spec.index.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# index_factory (twins of tests/test_factory.py)
# ---------------------------------------------------------------------------

def test_hnsw_specs():
    idx = factory(64, "HNSW16", capacity=1024)
    assert isinstance(idx, hnsw_tpu_torch.HnswIndex)
    assert idx.config.m == 16 and idx.config.m0 == 32
    assert factory(32, "HNSW32,Flat", capacity=512).config.m == 32
    idx = factory(32, "HNSW", metric="ip", capacity=512)
    assert idx.config.metric == "ip" and idx.config.m == 32


def test_flat_spec():
    assert isinstance(factory(16, "Flat"), FlatIndex)


def test_codec_specs():
    assert factory(16, "HNSW32,SQ8", capacity=512).config.is_sq
    idx = factory(16, "HNSW32,PQ8", capacity=512)
    assert idx.config.is_pq and idx.config.pq_m == 8


@pytest.mark.parametrize("spec", ["IVF100,Flat", "", "Flat,Flat",
                                  "HNSW32,PQ5"])
def test_unsupported(spec):
    with pytest.raises(ValueError):
        factory(16, spec)
    with pytest.raises(ValueError):
        hnsw_tpu.index_factory(16, spec)


# every spec in the reference factory's docstring, and the wrapped ones
DOC_SPECS = ["HNSW", "HNSW32", "HNSW16,Flat", "HNSW32,SQ8", "HNSW32,PQ16",
             "HNSW32,PQ32x4", "Flat", "IDMap,HNSW32", "L2norm,HNSW32,Flat",
             "PCA64,HNSW32,Flat", "PCAW64,HNSW32,Flat", "PCAR64,HNSW32,Flat",
             "RR64,HNSW32,Flat", "OPQ16,HNSW32,PQ16", "OPQ16_64,HNSW32,PQ16",
             "HNSW32,SQ8,RFlat", "IDMap,PCA64,HNSW32,Flat",
             "OPQ12,HNSW32,PQ12,RFlat"]


def tree(idx) -> list:
    """The wrapper tree as comparable tuples, outermost first."""
    name = type(idx).__name__
    if name == "PreTransformIndex":
        return [(name, [(type(t).__name__, t.d_in, t.d_out,
                         getattr(t, "seed", None)) for t in idx.transforms])
                ] + tree(idx.index)
    if name == "RefineFlatIndex":
        return [(name, idx.k_factor)] + tree(idx.index)
    if name == "IdMapIndex":
        return [(name,)] + tree(idx.index)
    if name == "FlatIndex":
        return [(name, idx.dim, idx.metric)]
    return [(name, idx.config.to_json())]


@pytest.mark.parametrize("spec", DOC_SPECS)
def test_factory_builds_the_reference_tree(spec):
    got = factory(96 if "12" in spec else 128, spec, capacity=256, seed=5)
    want = hnsw_tpu.index_factory(96 if "12" in spec else 128, spec,
                                  capacity=256, seed=5)
    assert tree(got) == tree(want)
    first = got.transforms[0] if isinstance(got, PreTransformIndex) else None
    if isinstance(first, tf.RandomRotation):
        np.testing.assert_array_equal(first.a, want.transforms[0].a)
