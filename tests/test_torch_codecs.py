"""The port's storage codecs (hnsw_tpu_torch: sq8, bf16 and PQ storage, PQ
codec ops, PQ-coded packed rows, the exact oracle over x̂, FlatIndex)
against the reference on the same inputs, on the CPU. Twins of
tests/test_sq.py, tests/test_pq.py and the codec cases of
tests/test_distances.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hnsw_tpu
import hnsw_tpu_torch
from hnsw_tpu.ops import pq as ref_pq
from hnsw_tpu.ops.distances import brute_force_topk as ref_brute
from hnsw_tpu.ops.packed import pack_neighbors as ref_pack
from hnsw_tpu.ops.packed import pack_pq_neighbors as ref_pack_pq
from hnsw_tpu.ops.packed import make_packed_pq_expand as ref_pq_expand
from hnsw_tpu.ops.packed import quantization_params as ref_qparams
from hnsw_tpu.ops.packed import quantize_codes as ref_qcodes
from hnsw_tpu.utils.recall import recall_at_k
from hnsw_tpu_torch.build import _encode_rows
from hnsw_tpu_torch.ops import pq
from hnsw_tpu_torch.ops.distances import brute_force_topk
from hnsw_tpu_torch.ops.packed import (make_packed_pq_expand, pack_neighbors,
                                       pack_pq_neighbors, quantization_params,
                                       quantize_codes)

# f32 sums of d terms taken in another order than the reference's
RTOL, ATOL = 1e-5, 1e-4


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.mark.parametrize("kw", [dict(dtype="float32"), dict(dtype="bfloat16"),
                                dict(dtype="sq8"),
                                dict(dtype="pq", pq_m=8, pq_bits=4)])
def test_config_storage_properties_match_reference(kw):
    ref = hnsw_tpu.HnswConfig(dim=24, **kw)
    port = hnsw_tpu_torch.HnswConfig(dim=24, **kw)
    for name in ("is_sq", "is_pq", "pq_ksub", "storage_dtype",
                 "storage_width"):
        assert getattr(port, name) == getattr(ref, name), name


def test_sq_params_codes_and_encode_bit_for_bit():
    """quantization_params, quantize_codes, HnswIndex.train and _sq_encode
    (numpy on the host) give the reference's bits."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(700, 24)) * rng.uniform(0.1, 5, 24)).astype(
        np.float32)
    x[:, 3] = 1.5                                  # a constant dim
    live = rng.random(700) < 0.9
    r_off, r_sc = ref_qparams(jnp.asarray(x), jnp.asarray(live), 8)
    off, sc = quantization_params(t(x), t(live), 8)
    np.testing.assert_array_equal(off.numpy(), np.asarray(r_off))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(r_sc))
    for bits in (8, 4):
        np.testing.assert_array_equal(
            quantize_codes(t(x), off, sc, bits).numpy(),
            np.asarray(ref_qcodes(jnp.asarray(x), r_off, r_sc, bits)))
    ref = hnsw_tpu.HnswIndex(24, 8, capacity=64, dtype="sq8")
    port = hnsw_tpu_torch.HnswIndex(24, 8, capacity=64, dtype="sq8",
                                    device="cpu")
    ref.train(x)
    port.train(x)
    for a, b in zip(port._sq_np, ref._sq_np):
        np.testing.assert_array_equal(a, b)
    q = (x + rng.normal(size=x.shape).astype(np.float32)) * 1.1  # clips too
    np.testing.assert_array_equal(port._sq_encode(q), ref._sq_encode(q))


def test_bf16_storage_write_bit_for_bit():
    """The build's storage write of bf16 rows rounds as the reference's
    ``astype(bfloat16)`` (to nearest even), ties and subnormals included."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(500, 24)).astype(np.float32)
    x[0, :4] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, 1e-40, -0.0]   # ties, subnormal
    got = _encode_rows(t(x), torch.bfloat16, None, None)
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), want)


def test_assign_update_matches_reference():
    """One Lloyd step on the same points and codebooks: counts exactly
    equal, sums within rtol 1e-5 (one-hot products summed in another
    order), the sse alike."""
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(3000, 4, 6)).astype(np.float32)
    cb = rng.normal(size=(4, 32, 6)).astype(np.float32)
    r_sums, r_counts, r_sse = ref_pq._assign_update(
        jnp.asarray(xs[:2048]), jnp.asarray(cb), chunk=512)
    sums, counts, sse = pq._assign_update(t(xs[:2048]), t(cb), chunk=500)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(r_counts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(r_sums), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(sse), float(r_sse), rtol=1e-5)


def test_train_pq_sample_and_steps():
    """train_pq draws the reference's sample and initial codebooks from the
    same numpy generator (iters=0: bit for bit), is deterministic, fills
    every cluster, and lowers the quantization error step by step."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5000, 24)).astype(np.float32)
    for kw in (dict(ksub=256, max_points=4096), dict(ksub=16)):
        np.testing.assert_array_equal(
            pq.train_pq(x, 6, iters=0, seed=5, device="cpu", **kw),
            ref_pq.train_pq(x, 6, iters=0, seed=5, **kw))
    a = pq.train_pq(x, 6, ksub=16, iters=8, seed=5, device="cpu")
    assert a.shape == (6, 16, 4) and a.dtype == np.float32
    np.testing.assert_array_equal(
        a, pq.train_pq(x, 6, ksub=16, iters=8, seed=5, device="cpu"))

    def err(cb):
        c = t(cb)
        return float(((pq.decode_pq(pq.encode_pq(t(x), c), c) - t(x)) ** 2)
                     .sum())

    init = pq.train_pq(x, 6, ksub=16, iters=0, seed=5, device="cpu")
    assert err(a) < 0.8 * err(init)
    with pytest.raises(ValueError, match="divide"):
        pq.train_pq(x, 7, device="cpu")
    with pytest.raises(ValueError, match="256"):
        pq.train_pq(x[:100], 6, device="cpu")


@pytest.mark.parametrize("with_dequant", [False, True])
def test_encode_pq_matches_reference(with_dequant):
    """encode_pq on the reference's codebooks (chunked, and from sq8 codes
    through the affine): >= 99.9% of codes equal, and every code that
    differs is a near-tie, within 1e-5 of the reference code's surrogate."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4000, 24)).astype(np.float32)
    cb = ref_pq.train_pq(x, 6, iters=3, seed=1)
    deq = None
    if with_dequant:
        off, sc = quantization_params(t(x), torch.ones(4000, dtype=bool), 8)
        x_in = quantize_codes(t(x), off, sc, 8)
        deq = (off, sc)
        r_codes = ref_pq.encode_pq(jnp.asarray(x_in.numpy()), jnp.asarray(cb),
                                   chunk=1024,
                                   dequant=(jnp.asarray(off.numpy()),
                                            jnp.asarray(sc.numpy())))
        xhat = off + sc * x_in.float()
    else:
        x_in = t(x)
        r_codes = ref_pq.encode_pq(jnp.asarray(x), jnp.asarray(cb), chunk=1024)
        xhat = x_in
    codes = pq.encode_pq(x_in, t(cb), chunk=1000, dequant=deq)
    r_codes = np.asarray(r_codes)
    same = codes.numpy() == r_codes
    assert same.mean() >= 0.999, same.mean()
    surr = (t(cb) ** 2).sum(-1)[None] - 2 * torch.einsum(
        "nmd,mkd->nmk", pq.split_sub(xhat, 6), t(cb))        # [n, m, ksub]
    mine = torch.gather(surr, 2, codes.long()[..., None])[..., 0]
    theirs = torch.gather(surr, 2, t(r_codes).long()[..., None])[..., 0]
    assert ((mine - theirs).abs()[~t(same)] <= 1e-5).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("ksub", [256, 16])
def test_pq_ops_match_reference(metric, ksub):
    """decode_pq and pq_sqnorms (a gather: bit for bit / rtol 1e-6),
    pq_lut, adc_distance and adc_decode_distance at both ``exact`` (rtol
    1e-5, atol 1e-4), and ADC equal to the distance to the decoded x̂."""
    rng = np.random.default_rng(ksub)
    cb = rng.normal(size=(6, ksub, 4)).astype(np.float32)
    codes = rng.integers(0, ksub, size=(40, 64, 6)).astype(np.uint8)
    qs = rng.normal(size=(40, 24)).astype(np.float32)
    jcb, jq, jc = jnp.asarray(cb), jnp.asarray(qs), jnp.asarray(codes)
    np.testing.assert_array_equal(pq.decode_pq(t(codes), t(cb)).numpy(),
                                  np.asarray(ref_pq.decode_pq(jc, jcb)))
    np.testing.assert_allclose(pq.pq_sqnorms(t(codes), t(cb)).numpy(),
                               np.asarray(ref_pq.pq_sqnorms(jc, jcb)),
                               rtol=1e-6)
    lut = pq.pq_lut(t(qs), t(cb), metric)
    r_lut = ref_pq.pq_lut(jq, jcb, metric)
    np.testing.assert_allclose(lut.numpy(), np.asarray(r_lut), rtol=RTOL,
                               atol=ATOL)
    want = np.asarray(ref_pq.adc_distance(r_lut, jc))
    np.testing.assert_allclose(pq.adc_distance(lut, t(codes)).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    for exact in (False, True):
        r = np.asarray(ref_pq.adc_decode_distance(jcb, jq, jc, metric,
                                                  exact=exact))
        got = pq.adc_decode_distance(t(cb), t(qs), t(codes), metric,
                                     exact=exact)
        np.testing.assert_allclose(got.numpy(), r, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("codec", ["sq8", "pq"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_brute_force_topk_over_codes_matches_reference(codec, metric):
    """The x̂ oracle: brute_force_topk(dequant=) / (pq=) over stored codes,
    tiled (tile_n 700 of 2,500 rows) with an n_valid cut: ids equal,
    distances within rtol 1e-5; and equal to an f32 search of the decoded
    table."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2500, 24)).astype(np.float32)
    qs = rng.normal(size=(30, 24)).astype(np.float32)
    kw, rkw = {}, {}
    if codec == "sq8":
        off, sc = quantization_params(t(x), torch.ones(2500, dtype=bool), 8)
        base = quantize_codes(t(x), off, sc, 8)
        kw["dequant"] = (off, sc)
        rkw["dequant"] = (jnp.asarray(off.numpy()), jnp.asarray(sc.numpy()))
        xhat = off + sc * base.float()
    else:
        cb = rng.normal(size=(6, 256, 4)).astype(np.float32)
        base = t(rng.integers(0, 256, size=(2500, 6)).astype(np.uint8))
        kw["pq"], rkw["pq"] = t(cb), jnp.asarray(cb)
        xhat = pq.decode_pq(base, t(cb))
    rd, ri = ref_brute(jnp.asarray(qs), jnp.asarray(base.numpy()), k=10,
                       metric=metric, tile_n=700, n_valid=2300, **rkw)
    d, i = brute_force_topk(t(qs), base, 10, metric, tile_n=700,
                            tile_q=16, n_valid=2300, **kw)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=RTOL,
                               atol=ATOL)
    d2, i2 = brute_force_topk(t(qs), xhat, 10, metric, n_valid=2300)
    np.testing.assert_array_equal(i2.numpy(), i.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_flat_index_matches_reference(dtype, metric):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(900, 16)).astype(np.float32)
    qs = rng.normal(size=(20, 16)).astype(np.float32)
    ref = hnsw_tpu.FlatIndex(16, metric, dtype)
    port = hnsw_tpu_torch.FlatIndex(16, metric, dtype, device="cpu")
    empty_d, empty_i = port.search(qs, 3)
    assert (empty_i == -1).all() and np.isinf(empty_d).all()
    for f in (ref, port):
        f.add(x[:500])
        f.add(x[500:])
    assert port.ntotal == ref.ntotal == 900
    rd, ri = ref.search(qs, 10, tile_n=256)
    d, i = port.search(qs, 10, tile_n=256)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(d, rd, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(port.reconstruct(7), ref.reconstruct(7))
    radius = float(np.median(d[:, 4])) if metric == "l2" \
        else float(np.median(-d[:, 4]))
    for a, b in zip(port.range_search(qs, radius),
                    ref.range_search(qs, radius)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


class _Graph:
    """The two level-0 arrays packing reads, as numpy."""

    def __init__(self, neighbors0, levels):
        self.neighbors0, self.levels = neighbors0, levels


@pytest.fixture(scope="module")
def small_graph():
    """(graph, f32 vectors, ntotal): 1,800 of 2,048 slots filled, each row
    up to 16 distinct neighbors, -1 padded (packing reads rows, not graph
    structure)."""
    rng = np.random.default_rng(9)
    cap, n, m0 = 2048, 1800, 16
    nb = np.full((cap, m0), -1, np.int32)
    for i in range(n):
        deg = rng.integers(1, m0 + 1)
        nb[i, :deg] = rng.choice(n, deg, replace=False)
    levels = np.where(np.arange(cap) < n, 0, -1).astype(np.int32)
    v = rng.normal(size=(cap, 32)).astype(np.float32)
    return _Graph(nb, levels), v, n


@pytest.mark.parametrize("bits", [8, 4])
def test_pack_neighbors_from_sq8_storage_bit_for_bit(small_graph, bits):
    """Packed sq rows built from sq8 storage codes (8-bit: the stored codes
    and affine; 4-bit: x̂ quantized anew): tables bit for bit, norms to f32
    rounding."""
    g, v, n = small_graph
    off, sc = quantization_params(t(v), torch.ones(len(v), dtype=bool), 8)
    codes = quantize_codes(t(v), off, sc, 8)
    ref = ref_pack(jnp.asarray(g.neighbors0), jnp.asarray(codes.numpy()),
                   jnp.asarray(g.levels),
                   bits=bits, n_rows=n,
                   dequant=(jnp.asarray(off.numpy()), jnp.asarray(sc.numpy())))
    got = pack_neighbors(t(g.neighbors0), codes, t(g.levels), bits=bits,
                         n_rows=n, dequant=(off, sc))
    np.testing.assert_array_equal(got.nbr_codes.numpy(),
                                  np.asarray(ref.nbr_codes)[:n])
    np.testing.assert_array_equal(got.offset.numpy(), np.asarray(ref.offset))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_allclose(got.nbr_sq.numpy(),
                               np.asarray(ref.nbr_sq)[:n], rtol=1e-6)


@pytest.mark.parametrize("pq_bits", [8, 4])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pack_pq_neighbors_and_expand_match_reference(small_graph, pq_bits,
                                                      metric):
    """pack_pq_neighbors (8-bit, and 4-bit nibbles): tables bit for bit;
    make_packed_pq_expand: neighbors equal, ADC distances rtol 1e-5, shift
    0; the budget counts the port's exact row count."""
    g, v, n = small_graph
    rng = np.random.default_rng(pq_bits)
    ksub = 1 << pq_bits
    cb = rng.normal(size=(8, ksub, 4)).astype(np.float32)
    codes = rng.integers(0, ksub, size=(len(v), 8)).astype(np.uint8)
    ref = ref_pack_pq(jnp.asarray(g.neighbors0), jnp.asarray(codes),
                      jnp.asarray(cb), pq_bits=pq_bits, n_rows=n)
    got = pack_pq_neighbors(t(g.neighbors0), t(codes), t(cb),
                            pq_bits=pq_bits, n_rows=n)
    np.testing.assert_array_equal(got.nbr_codes.numpy(),
                                  np.asarray(ref.nbr_codes)[:n])
    assert got.pq_bits == ref.pq_bits_for(16) == pq_bits
    qs = rng.normal(size=(50, 32)).astype(np.float32)
    cur = rng.integers(0, n, size=(50, 2)).astype(np.int32)
    r_exp, r_shift = ref_pq_expand(ref, jnp.asarray(g.neighbors0),
                                   jnp.asarray(qs), metric)
    exp, shift = make_packed_pq_expand(got, t(g.neighbors0), t(qs), metric)
    ok = np.ones((50, 2), bool)
    r_nb, r_d = r_exp(jnp.asarray(cur), jnp.asarray(ok))
    nb, d = exp(t(cur), t(ok))
    np.testing.assert_array_equal(nb.numpy(), np.asarray(r_nb))
    np.testing.assert_allclose(d.numpy(), np.asarray(r_d), rtol=RTOL,
                               atol=ATOL)
    assert float(r_shift) == 0 and not shift.any()
    need = n * 16 * (8 if pq_bits == 8 else 4)
    with pytest.raises(ValueError, match="budget"):
        pack_pq_neighbors(t(g.neighbors0), t(codes), t(cb), pq_bits=pq_bits,
                          n_rows=n, max_bytes=need - 1)
    assert pack_pq_neighbors(t(g.neighbors0), t(codes), t(cb),
                             pq_bits=pq_bits, n_rows=n,
                             max_bytes=need).nbytes == need + cb.nbytes


# -- builds and searches: the same workload through both packages ----------

WL = dict(n=1500, d=24, n_queries=100, seed=21)
IDX = dict(capacity=2048, ef_construction=60, seed=13)
PQ_M = 6


@pytest.fixture(scope="module")
def workload():
    return hnsw_tpu_torch.synthetic_workload(WL["n"], WL["d"],
                                             n_queries=WL["n_queries"],
                                             seed=WL["seed"])


@pytest.fixture(scope="module")
def builds(workload):
    """dtype -> (reference index, port index), built on demand from the same
    workload and seed; the port's PQ index carries the reference's
    codebooks (k-means in another order of summation drifts)."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            kw = dict(pq_m=PQ_M) if dtype == "pq" else {}
            ref = hnsw_tpu.HnswIndex(WL["d"], 8, "l2", dtype=dtype, **IDX,
                                     **kw)
            port = hnsw_tpu_torch.HnswIndex(WL["d"], 8, "l2", dtype=dtype,
                                            device="cpu", **IDX, **kw)
            ref.train(workload.base)
            if dtype == "pq":
                port._set_pq(ref._pq_np)
            else:
                port.train(workload.base)
            ref.add(workload.base)
            port.add(workload.base)
            cache[dtype] = ref, port
        return cache[dtype]

    return get


@pytest.mark.parametrize("dtype", ["sq8", "bfloat16", "pq"])
def test_codec_build_matches_reference(builds, dtype):
    """sq8 and bf16 builds edge for edge (as the f32 build); PQ on the
    carried codebooks with >= 99% of edges equal; stored rows equal,
    invariants clean, the same level draws and entry point."""
    ref, port = builds(dtype)
    a, b = port.graph.neighbors0.numpy(), np.asarray(ref.graph.neighbors0)
    ua = port.graph.upper_neighbors.numpy()
    ub = np.asarray(ref.graph.upper_neighbors)
    if dtype == "pq":
        assert (a == b).mean() >= 0.99 and (ua == ub).mean() >= 0.99
    else:
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ua, ub)
    np.testing.assert_array_equal(port.vectors.float().numpy(),
                                  np.asarray(ref.vectors, np.float32))
    assert port.vectors.dtype == getattr(torch, port.config.storage_dtype)
    assert port.graph.entry_point == int(ref.graph.entry_point)
    assert port.check()["errors"] == []


def test_reconstruct_matches_reference(builds, workload):
    """reconstruct / _n / _batch and search_and_reconstruct return x̂ as the
    reference's, NaN rows for missing results."""
    for dtype in ("sq8", "pq"):
        ref, port = builds(dtype)
        np.testing.assert_array_equal(port.reconstruct_n(0, 300),
                                      ref.reconstruct_n(0, 300))
        np.testing.assert_array_equal(port.reconstruct(17),
                                      ref.reconstruct(17))
        ids = np.array([5, -1, 5, 1499])
        np.testing.assert_array_equal(port.reconstruct_batch(ids),
                                      ref.reconstruct_batch(ids))
        with pytest.raises(IndexError):
            port.reconstruct(WL["n"])
        d, i, r = port.search_and_reconstruct(workload.queries[:5], 3)
        np.testing.assert_array_equal(r, ref.reconstruct_batch(i.reshape(-1))
                                      .reshape(5, 3, WL["d"]))


# (storage, packed routing, options): unpacked (K3 with the affine / bf16
# rows / ADC), packed sq rows from sq8 storage, PQ routing rows over sq8
# storage (the port's routing codebooks carried across), PQ storage's
# own packed rows, and the legacy beam (bf16 merge keys under PQ)
SEARCH_CASES = {
    "sq8": ("sq8", None, {}),
    "sq8-packed8": ("sq8", "sq", {}),
    "sq8-packed-pq": ("sq8", "pq", {}),
    "sq8-n_expand2": ("sq8", None, {"n_expand": 2}),
    "bf16": ("bfloat16", None, {}),
    "pq": ("pq", None, {}),
    "pq-packed": ("pq", "pq", {}),
    "pq-n_expand2": ("pq", None, {"n_expand": 2}),
}


@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_codec_search_matches_reference(builds, workload, tmp_path,
                                        monkeypatch, case):
    """A reference-built codec index saved and loaded into the port: ids
    >= 99% equal, distances of matched ids rtol 1e-5, recall within 0.005
    (against the x̂ oracle), hops equal, total ndis within 0.5%; returned
    distances exact over x̂."""
    dtype, packed, kw = SEARCH_CASES[case]
    ref, _ = builds(dtype)
    path = str(tmp_path / "ref.npz")
    ref.save(path)
    if dtype == "bfloat16":   # the reference's bf16 file: see test_persist
        ref_file = np.load(path)
        assert ref_file["vectors"].dtype.kind == "V"
    port = hnsw_tpu_torch.HnswIndex.load(path, device="cpu")
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    if packed == "sq":
        ref.enable_packed(bits=8)
        port.enable_packed(bits=8)
    elif packed == "pq" and dtype == "pq":
        ref.enable_packed()
        port.enable_packed()
    elif packed == "pq":
        # routing codebooks trained by the port, carried to the reference
        port.enable_packed(mode="pq", pq_m=PQ_M, train_x=workload.base)
        cb, codes, _ = port._route
        ref._route = (jnp.asarray(cb.numpy()), jnp.asarray(codes.numpy()))
        ref.enable_packed(mode="pq")
    ref.n_expand = port.n_expand = kw.get("n_expand", 1)
    try:
        rd, ri, rst = ref.search(workload.queries, k=10, ef_search=40,
                                 with_stats=True)
        d, i, st = port.search(workload.queries, k=10, ef_search=40,
                               with_stats=True)
    finally:
        ref.disable_packed(reset_routing=True)
        ref.n_expand = 1
    same = i == ri
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(d[same], rd[same], rtol=1e-5, atol=1e-5)
    assert st.hops == int(rst.hops)
    ndis, rndis = int(st.ndis.sum()), int(np.asarray(rst.ndis).sum())
    assert abs(ndis - rndis) <= 0.005 * rndis, (ndis, rndis)
    xhat = port.reconstruct_n(0, WL["n"])
    _, gt = brute_force_topk(t(workload.queries), t(xhat), 10)
    gt = gt.numpy()
    assert abs(recall_at_k(i, gt, 10) - recall_at_k(ri, gt, 10)) <= 0.005
    assert recall_at_k(i, gt, 10) >= 0.9
    exact = ((workload.queries[:, None, :] - xhat[i]) ** 2).sum(-1)
    np.testing.assert_allclose(d, exact, rtol=1e-4, atol=1e-3)


def test_codec_api_edges(builds, workload):
    """train before add, no retrain after it, sq rows refused on pq storage,
    routing codebooks kept until reset, and PQ routing rows on flat
    storage."""
    idx = hnsw_tpu_torch.HnswIndex(8, 4, capacity=64, dtype="sq8",
                                   device="cpu")
    assert not idx.is_trained and idx.vectors.dtype == torch.uint8
    with pytest.raises(RuntimeError, match="train"):
        idx.add(np.zeros((4, 8), np.float32))
    idx.train(np.random.default_rng(0).normal(size=(32, 8)).astype(
        np.float32))
    idx.add(np.zeros((2, 8), np.float32))
    with pytest.raises(RuntimeError, match="train"):
        idx.train(np.zeros((4, 8), np.float32))
    _, port = builds("pq")
    assert port.vectors.shape == (IDX["capacity"], PQ_M)
    with pytest.raises(ValueError, match="sq packed rows"):
        port.enable_packed(mode="sq")
    flat = hnsw_tpu_torch.HnswIndex(WL["d"], 8, device="cpu", **IDX)
    flat.add(workload.base[:600])
    with pytest.raises(ValueError, match="pq_m"):
        flat.enable_packed(mode="pq", pq_m=5)
    nbytes = flat.enable_packed(mode="pq", pq_m=PQ_M, pq_bits=4)
    assert flat.packed_enabled and nbytes == 600 * 16 * 3 + 6 * 16 * 4 * 4
    with pytest.raises(ValueError, match="reset_routing"):
        flat.enable_packed(mode="pq", pq_m=4)
    _, i = flat.search(workload.queries, 10, ef_search=48)
    _, gt = brute_force_topk(t(workload.queries), t(workload.base[:600]), 10)
    assert recall_at_k(i, gt.numpy(), 10) >= 0.9
    flat.disable_packed(reset_routing=True)
    assert not flat.packed_enabled and flat._route is None
