"""The port's five kernels (hnsw_tpu_torch: K1 beam_update, K2
packed_row_dist, K3 gathered_vec_dist, K4 packed_row_dist_words, K5
fused_gather_distances) against the reference Pallas kernels run in
interpret mode, on the CPU, where each wrapper runs its plain PyTorch
version. The same inputs, made with numpy from a seed, go to both.

The CUDA kernels themselves are held against the plain versions on the
card: by tests/test_torch_cuda.py (skipped without a card) and by
``chip_smoke.py``."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnsw_tpu.ops.beam_kernel import beam_update as ref_beam_update
from hnsw_tpu.ops.dist_kernel import gathered_vec_dist as ref_vec_dist
from hnsw_tpu.ops.dist_kernel import packed_row_dist as ref_packed_dist
from hnsw_tpu.ops.dist_kernel import packed_row_dist_words as ref_words_dist
from hnsw_tpu.ops.dist_kernel import words_query_planes
from hnsw_tpu.ops.hop_kernel import BLOCK_Q
from hnsw_tpu.ops.hop_kernel import fused_gather_distances as ref_gather_dist
from hnsw_tpu.ops.packed import pack_words as ref_pack_words
from hnsw_tpu_torch.ops import (_cuda, beam_kernel, dist_kernel, entry_kernel,
                                hop_kernel)
from hnsw_tpu_torch.ops.packed import word_width
from test_torch_cuda import BEAM_EDGES, beam_case, beam_edge_case

from torch_threads import one_torch_thread  # noqa: F401  (a fixture)

REPO = Path(__file__).resolve().parent.parent
# f32 sums taken in another order than the reference's
RTOL, ATOL = 1e-5, 1e-4


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [32, 100])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "u8"])
def test_gathered_vec_dist_matches_reference(dtype, d, metric):
    rng = np.random.default_rng(d * 10 + len(dtype))
    q, k = 64, 16
    qs = rng.normal(size=(q, d)).astype(np.float32)
    dq_np = None
    if dtype == "u8":
        vecs = rng.integers(0, 256, size=(q, k, d), dtype=np.uint8)
        dq_np = (rng.normal(size=d).astype(np.float32),
                 rng.uniform(0.002, 0.01, size=d).astype(np.float32))
    else:
        vecs = rng.normal(size=(q, k, d)).astype(np.float32)
    jv = jnp.asarray(vecs, jnp.bfloat16) if dtype == "bf16" \
        else jnp.asarray(vecs)
    tv = torch.from_numpy(vecs)
    if dtype == "bf16":
        tv = tv.to(torch.bfloat16)
    want = ref_vec_dist(jv, jnp.asarray(qs),
                        None if dq_np is None else tuple(map(jnp.asarray,
                                                             dq_np)),
                        metric=metric, interpret=True)
    got = dist_kernel.gathered_vec_dist(
        tv, torch.from_numpy(qs),
        None if dq_np is None else tuple(map(torch.from_numpy, dq_np)),
        metric=metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "u8"])
def test_gathered_vec_dist_gist_width_matches_reference(dtype, metric):
    """The same comparison at GIST's d = 960, which the CUDA kernel walks
    in passes of 128 dims (no shared-memory limit on d any more)."""
    test_gathered_vec_dist_matches_reference(dtype, 960, metric)


def test_gathered_vec_dist_ids_matches_pregathered():
    """The ids entry point (the search path's) gathers inside; the
    pre-gathered one runs it on vecs.view(Q*K, d) with ids = arange."""
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(size=(500, 24)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 500, size=(40, 12),
                                        dtype=np.int32))
    qs = torch.from_numpy(rng.normal(size=(40, 24)).astype(np.float32))
    a = dist_kernel.gathered_vec_dist_ids(table, ids, qs, metric="l2")
    b = dist_kernel.gathered_vec_dist(table[ids.long()].contiguous(), qs,
                                      metric="l2")
    assert torch.equal(a, b)


def _nibble_rows(vals: np.ndarray) -> np.ndarray:
    q, k, d = vals.shape
    if d % 2:
        vals = np.concatenate([vals, np.zeros((q, k, 1), np.uint8)], axis=2)
    return (vals[..., 0::2] | (vals[..., 1::2] << 4)).reshape(q, -1)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [32, 31])
@pytest.mark.parametrize("bits", [8, 4])
def test_packed_row_dist_matches_reference(bits, d, metric):
    rng = np.random.default_rng(bits * 100 + d)
    q, k = 64, 16
    vals = rng.integers(0, 1 << bits, size=(q, k, d), dtype=np.uint8)
    rows = vals.reshape(q, -1) if bits == 8 else _nibble_rows(vals)
    # qs = q * scale: per-dim scales of an 8/4-bit code range
    qs = (rng.normal(size=(q, d)) * 0.01).astype(np.float32)
    sq = rng.uniform(1, 10, size=(q, k)).astype(np.float32)
    want = ref_packed_dist(jnp.asarray(rows), jnp.asarray(qs),
                           jnp.asarray(sq), k=k, bits=bits, metric=metric,
                           interpret=True)
    got = dist_kernel.packed_row_dist(
        torch.from_numpy(rows), torch.from_numpy(qs), torch.from_numpy(sq),
        k=k, bits=bits, metric=metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bits", [8, 4])
def test_packed_row_dist_main_width_matches_reference(bits, metric):
    """The same comparison at the main path's d = 128, the width at which
    the CUDA kernel runs on K4's engine (whole 4-byte words a segment)."""
    test_packed_row_dist_matches_reference(bits, 128, metric)


def test_packed_row_dist_ids_reads_row_by_node():
    """The ids entry point reads code row cur[q] of the table and its norm
    row: the same values as gathering those rows first."""
    rng = np.random.default_rng(5)
    n, k, d = 300, 8, 20
    codes = torch.from_numpy(rng.integers(0, 256, size=(n, k * d),
                                          dtype=np.uint8))
    nbr_sq = torch.from_numpy(rng.uniform(1, 5, size=(n, k))
                              .astype(np.float32))
    cur = torch.from_numpy(rng.integers(0, n, size=32, dtype=np.int32))
    qs = torch.from_numpy(rng.normal(size=(32, d)).astype(np.float32))
    a = dist_kernel.packed_row_dist_ids(codes, nbr_sq, cur, qs, bits=8,
                                        metric="l2")
    b = dist_kernel.packed_row_dist(codes[cur.long()], qs,
                                    nbr_sq[cur.long()], k=k, bits=8,
                                    metric="l2")
    assert torch.equal(a, b)


@pytest.mark.parametrize("bits", [8, 4])
def test_packed_row_dist_t_axis(bits):
    """cur [Q, T]: row b of the flattened T axis reads code row cur.flat[b]
    against query b // T, as T separate calls would."""
    rng = np.random.default_rng(9 + bits)
    n, k, d, q, t = 200, 8, 21, 16, 3
    db = d if bits == 8 else (d + 1) // 2
    codes = torch.from_numpy(rng.integers(0, 256, size=(n, k * db),
                                          dtype=np.uint8))
    nbr_sq = torch.from_numpy(rng.uniform(1, 5, size=(n, k))
                              .astype(np.float32))
    cur = torch.from_numpy(rng.integers(0, n, size=(q, t), dtype=np.int32))
    qs = torch.from_numpy(rng.normal(size=(q, d)).astype(np.float32))
    for metric in ("l2", "ip"):
        got = dist_kernel.packed_row_dist_ids(codes, nbr_sq, cur, qs,
                                              bits=bits, metric=metric)
        want = torch.cat([dist_kernel.packed_row_dist_ids(
            codes, nbr_sq, cur[:, i].contiguous(), qs, bits=bits,
            metric=metric) for i in range(t)], 1)
        assert torch.equal(got, want)


@pytest.mark.parametrize("d,bits", [(32, 8), (128, 4), (100, 8), (17, 4)])
def test_packed_row_dist_words_matches_reference(d, bits):
    """K4's plain version against the Pallas words kernel (interpret mode)
    fed the reference's own query planes. m0 tiles the reference's 128 / wp
    candidate groups at each (d, bits): 16, or 32 at d = 17 4-bit (4 words
    a segment, 3 of them carrying values). Tolerance RTOL/ATOL: f32 sums in
    another order."""
    rng = np.random.default_rng(d * 10 + bits)
    wp = word_width(d, bits)
    q, k = 64, max(16, 128 // wp)
    vals = rng.integers(0, 1 << bits, size=(q, k, d), dtype=np.uint8)
    vals[0] = (1 << bits) - 1                 # the wrapped high byte / nibble
    qs = (rng.normal(size=(q, d)) * 0.01).astype(np.float32)
    words = np.array(ref_pack_words(jnp.asarray(vals), bits)).reshape(q, -1)
    want = ref_words_dist(jnp.asarray(words),
                          words_query_planes(jnp.asarray(qs), bits=bits,
                                             wp=wp),
                          k=k, wp=wp, bits=bits, interpret=True)
    got = dist_kernel.packed_row_dist_words(
        torch.from_numpy(words), torch.from_numpy(qs), k=k, wp=wp, bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("d,bits", [(128, 8), (100, 8), (17, 4)])
def test_packed_row_dist_words_t_axis_matches_reference(d, bits):
    """Two expansions a query (cur [Q, 2], the legacy beam's n_expand = 2):
    the ids entry point against the Pallas words kernel (interpret mode) run
    on each expansion's gathered rows, side by side. Tolerance RTOL/ATOL."""
    rng = np.random.default_rng(d + bits)
    wp = word_width(d, bits)
    n, q, k, t = 40, 32, max(16, 128 // wp), 2
    vals = rng.integers(0, 1 << bits, size=(n, k, d), dtype=np.uint8)
    words = np.array(ref_pack_words(jnp.asarray(vals), bits)).reshape(n, -1)
    cur = rng.integers(0, n, size=(q, t), dtype=np.int32)
    qs = (rng.normal(size=(q, d)) * 0.01).astype(np.float32)
    planes = words_query_planes(jnp.asarray(qs), bits=bits, wp=wp)
    want = np.concatenate([np.asarray(ref_words_dist(
        jnp.asarray(words[cur[:, i]]), planes, k=k, wp=wp, bits=bits,
        interpret=True)) for i in range(t)], 1)
    got = dist_kernel.packed_row_dist_words_ids(
        torch.from_numpy(words), torch.from_numpy(cur), torch.from_numpy(qs),
        wp=wp, bits=bits)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_packed_row_dist_words_ids_rows_and_t_axis():
    """The ids entry point reads word row cur[q, t] by node: the values of
    gathering those rows first, T columns side by side."""
    rng = np.random.default_rng(12)
    n, k, d, bits, q, t = 150, 6, 24, 8, 10, 2
    wp = word_width(d, bits)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, size=(n, k * wp),
                                          dtype=np.int64).astype(np.int32))
    cur = torch.from_numpy(rng.integers(0, n, size=(q, t), dtype=np.int32))
    qs = torch.from_numpy(rng.normal(size=(q, d)).astype(np.float32))
    got = dist_kernel.packed_row_dist_words_ids(words, cur, qs, wp=wp,
                                                bits=bits)
    want = torch.cat([dist_kernel.packed_row_dist_words(
        words[cur[:, i].long()], qs, k=k, wp=wp, bits=bits)
        for i in range(t)], 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_fused_gather_distances_matches_reference(metric, dtype):
    """K5's plain version against the Pallas kernel (interpret mode), with
    negative and past-the-end ids, which both clamp, on f32 rows and on
    bf16 rows (the reference widens its table to f32, the port each
    gathered row; the same bits either way). Tolerance RTOL/ATOL."""
    rng = np.random.default_rng(0)
    cap, d, q, k = 512, 128, 2 * BLOCK_Q, 16
    vecs = rng.normal(size=(cap, d)).astype(np.float32)
    ids = rng.integers(0, cap, size=(q, k), dtype=np.int32)
    ids[0, :3] = (-1, -7, cap + 5)
    qs = rng.normal(size=(q, d)).astype(np.float32)
    jv, tv = jnp.asarray(vecs), torch.from_numpy(vecs)
    if dtype == "bf16":
        jv, tv = jv.astype(jnp.bfloat16), tv.to(torch.bfloat16)
        np.testing.assert_array_equal(np.asarray(jv.astype(jnp.float32)),
                                      tv.float().numpy())
    want = ref_gather_dist(jv, jnp.asarray(ids), jnp.asarray(qs), metric,
                           interpret=True)
    got = hop_kernel.fused_gather_distances(tv, torch.from_numpy(ids),
                                            torch.from_numpy(qs), metric)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_fused_gather_distances_negative_ids_clamped():
    """The reference's negative-id case: every -1 reads row 0."""
    rng = np.random.default_rng(1)
    cap, d, q, k = 64, 128, BLOCK_Q, 4
    vecs = rng.normal(size=(cap, d)).astype(np.float32)
    ids = np.full((q, k), -1, np.int32)
    qs = rng.normal(size=(q, d)).astype(np.float32)
    want = np.asarray(ref_gather_dist(jnp.asarray(vecs), jnp.asarray(ids),
                                      jnp.asarray(qs), "l2", interpret=True))
    got = hop_kernel.fused_gather_distances(
        torch.from_numpy(vecs), torch.from_numpy(ids), torch.from_numpy(qs))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    v0 = vecs[0]
    np.testing.assert_allclose(got.numpy()[:, 0],
                               (v0 ** 2).sum() - 2.0 * qs @ v0, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_fused_gather_distances_plain_equals_vec_dist_plain(metric, dtype):
    """K5 is K3's function without the affine (on the card both run K3's
    row engines): their plain versions agree bit for bit on f32 and bf16
    rows, with negative and past-the-end ids clamped."""
    rng = np.random.default_rng(3)
    cap, d, q, k = 300, 40, 6, 17
    vecs = torch.from_numpy(rng.normal(size=(cap, d)).astype(np.float32))
    if dtype == "bf16":
        vecs = vecs.to(torch.bfloat16)
    ids = torch.from_numpy(rng.integers(-9, cap + 9, size=(q, k),
                                        dtype=np.int32))
    qs = torch.from_numpy(rng.normal(size=(q, d)).astype(np.float32))
    got = hop_kernel.fused_gather_distances_plain(vecs, ids, qs, metric)
    want = dist_kernel.gathered_vec_dist_plain(vecs, ids, qs, metric=metric)
    assert torch.equal(got, want)
    assert torch.equal(hop_kernel.fused_gather_distances(vecs, ids, qs,
                                                         metric), want)


def _check_beam_against_reference(arrays, ef, ef_live):
    """The port's beam_update (plain version on the CPU) against the Pallas
    kernel in interpret mode: cur and ndis exactly, and each row's (key,
    payload) multiset (the bitonic network may reorder equal keys)."""
    buf_d, buf_p, cand_i, cand_d = arrays
    qn = buf_d.shape[1]
    rd, rp, rcur, rndis = (np.asarray(a) for a in ref_beam_update(
        jnp.asarray(buf_d), jnp.asarray(buf_p), jnp.asarray(cand_i),
        jnp.asarray(cand_d), jnp.int32(ef_live), ef=ef, bq=128,
        interpret=True))
    od, op, cur, ndis = beam_kernel.beam_update(
        *(torch.from_numpy(np.ascontiguousarray(a.T))
          for a in (buf_d, buf_p, cand_i, cand_d)), ef_live)
    assert np.array_equal(cur.numpy(), rcur)
    assert np.array_equal(ndis.numpy(), rndis)
    od, op = od.numpy(), op.numpy()
    for q in range(qn):
        assert sorted(zip(od[q], op[q])) == sorted(zip(rd[:, q], rp[:, q])), q


@pytest.mark.parametrize("ef,k,ef_live", [(64, 64, 64), (32, 64, 32),
                                          (64, 64, 48), (128, 48, 100)])
def test_beam_update_matches_reference(ef, k, ef_live):
    _check_beam_against_reference(beam_case(ef, k, 128, ef * 1000 + k), ef,
                                  ef_live)


@pytest.mark.parametrize("ef,k", [(32, 16), (32, 64), (256, 16), (256, 64)])
@pytest.mark.parametrize("kind", BEAM_EDGES)
def test_beam_update_edges_match_reference(kind, ef, k):
    """The edges the K1 kernel branches on (no valid candidate, no fresh
    one, a converged buffer, keys tied across buffer and candidates,
    ef_live < ef), on both sides of its warp / block switch (ef + K = 256),
    at Q = 128 as the reference requires. The card holds the kernel to the
    plain version on the same edges (test_torch_cuda.py)."""
    arrays, ef_live = beam_edge_case(kind, ef, k, 128, ef * 100 + k)
    _check_beam_against_reference(arrays, ef, ef_live)


def test_cpu_tensors_run_plain_versions_and_count_nothing():
    _cuda.reset_launch_counts()
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    ids = torch.zeros((4, 3), dtype=torch.int32)
    dist_kernel.gathered_vec_dist_ids(t, ids, t[:4], metric="l2")
    beam_kernel.beam_update(torch.zeros((4, 32)),
                            torch.full((4, 32), -1, dtype=torch.int32),
                            ids, torch.zeros((4, 3)), 32)
    dist_kernel.packed_row_dist_ids(
        torch.zeros((9, 24), dtype=torch.uint8), torch.zeros((9, 3)),
        ids[:, 0].contiguous(), t[:4], bits=8, metric="l2")
    dist_kernel.packed_row_dist_words_ids(
        torch.zeros((9, 6), dtype=torch.int32), ids, t[:4], wp=2, bits=8)
    hop_kernel.fused_gather_distances(t, ids, t[:4])
    entry_kernel.entry_scan(t[:4], t[:16], torch.zeros(16),
                            torch.ones(16, dtype=torch.bool), 2)
    assert _cuda.launch_counts() == {
        "gathered_vec_dist": 0, "packed_row_dist": 0,
        "packed_row_dist_words": 0, "beam_update": 0,
        "fused_gather_distances": 0, "entry_scan": 0}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    t = torch.zeros((50, 8))
    ids = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        dist_kernel.gathered_vec_dist_ids(t, ids.long(), t[:4], metric="l2")
    with pytest.raises(ValueError, match="contiguous"):
        dist_kernel.gathered_vec_dist_ids(t, ids, t[:8:2], metric="l2")
    with pytest.raises(ValueError, match="shape"):
        dist_kernel.gathered_vec_dist_ids(t, ids, t[:5], metric="l2")
    with pytest.raises(ValueError, match="row width"):
        dist_kernel.packed_row_dist_ids(
            torch.zeros((9, 30), dtype=torch.uint8), torch.zeros((9, 4)),
            torch.zeros(2, dtype=torch.int32), torch.zeros((2, 8)), bits=8,
            metric="l2")
    with pytest.raises(ValueError, match="shape"):
        beam_kernel.beam_update(torch.zeros((4, 32)),
                                torch.zeros((4, 16), dtype=torch.int32),
                                ids, torch.zeros((4, 3)), 32)
    # a device with no kernel raises instead of running the plain version
    meta = torch.empty((50, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        dist_kernel.gathered_vec_dist_ids(
            meta, ids.to("meta"), meta[:4], metric="l2")


@pytest.mark.parametrize("bits", [8, 4])
def test_dist_wrappers_take_what_the_kernels_take(monkeypatch, bits):
    """The wrappers' limits on the card, with the card faked (``on_cpu``
    answers False; launches are recorded, not run). K3 takes any d: its
    kernel keeps the query in registers, not shared memory. K2 takes a d
    whose staged query values (dims past d as 0) fit in SMEM_LIMIT bytes,
    which its byte path and its word engine's plain-load path stage without
    opting in to more, and refuses the next d."""
    launched = []
    monkeypatch.setattr(dist_kernel, "on_cpu", lambda *tensors: False)
    for kern in (dist_kernel._VEC_DIST, dist_kernel._PACKED_DIST):
        monkeypatch.setattr(kern, "launch",
                            lambda *args, name=kern.name:
                            launched.append((name, args)))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    wide = _cuda.SMEM_LIMIT  # 4x the d a shared-memory query could hold
    dist_kernel.gathered_vec_dist_ids(torch.zeros((5, wide)), ids,
                                      torch.zeros((2, wide)), metric="l2")
    assert launched[-1][0] == "gathered_vec_dist"
    assert launched[-1][1][3] == wide
    d_max = _cuda.SMEM_LIMIT // 4
    for d in (d_max, d_max + 1):
        db = d if bits == 8 else (d + 1) // 2
        args = (torch.zeros((3, 2 * db), dtype=torch.uint8),
                torch.zeros((3, 2)), torch.zeros(2, dtype=torch.int32),
                torch.zeros((2, d)))
        if d == d_max:
            dist_kernel.packed_row_dist_ids(*args, bits=bits, metric="l2")
            assert launched[-1][0] == "packed_row_dist"
            assert launched[-1][1][5] == d
        else:
            with pytest.raises(ValueError, match="too wide"):
                dist_kernel.packed_row_dist_ids(*args, bits=bits,
                                                metric="l2")
    assert len(launched) == 2


def test_gather_wrapper_takes_any_d(monkeypatch):
    """K5's wrapper on the card, with the card faked (``on_cpu`` answers
    False; launches are recorded, not run): it takes a d whose f32 query
    would not fit in SMEM_LIMIT bytes, since the kernel keeps the query in
    registers, on f32 and bf16 rows, and tags each launch by row dtype."""
    launched = []
    monkeypatch.setattr(hop_kernel, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(hop_kernel._GATHER_DIST, "launch",
                        lambda *args: launched.append(args))
    monkeypatch.setattr(hop_kernel._GATHER_DIST, "by_tag", {})
    ids = torch.zeros((2, 3), dtype=torch.int32)
    wide = _cuda.SMEM_LIMIT // 4 + 1
    for dtype in (torch.float32, torch.bfloat16):
        out = hop_kernel.fused_gather_distances(
            torch.zeros((5, wide), dtype=dtype), ids, torch.zeros((2, wide)))
        assert out.shape == (2, 3) and out.dtype == torch.float32
    assert [(a[1], a[2], a[3], a[5], a[6]) for a in launched] == [
        (0, 5, wide, 2, 3), (1, 5, wide, 2, 3)]
    assert hop_kernel._GATHER_DIST.by_tag == {"float32": 1, "bfloat16": 1}


def test_words_and_gather_wrappers_refuse_what_the_kernels_do_not_take():
    t = torch.zeros((50, 8))
    ids = torch.zeros((4, 3), dtype=torch.int32)
    words = torch.zeros((9, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        dist_kernel.packed_row_dist_words_ids(words.to(torch.uint8), ids,
                                              t[:4], wp=2, bits=8)
    with pytest.raises(ValueError, match="not k \\* wp"):
        dist_kernel.packed_row_dist_words_ids(words, ids, t[:4], wp=4,
                                              bits=8)
    with pytest.raises(ValueError, match="fewer than d"):
        dist_kernel.packed_row_dist_words_ids(words, ids, t[:4], wp=1,
                                              bits=8)
    with pytest.raises(ValueError, match="shape"):
        dist_kernel.packed_row_dist_words_ids(words, ids, t[:5], wp=2,
                                              bits=8)
    with pytest.raises(ValueError, match="bits"):
        dist_kernel.packed_row_dist_words_ids(words, ids, t[:4], wp=2,
                                              bits=2)
    with pytest.raises(ValueError, match="float32"):
        hop_kernel.fused_gather_distances(t.double(), ids, t[:4])
    with pytest.raises(ValueError, match="int32"):
        hop_kernel.fused_gather_distances(t, ids.long(), t[:4])
    with pytest.raises(ValueError, match="shape"):
        hop_kernel.fused_gather_distances(t, ids, t[:4, :5])
    with pytest.raises(ValueError, match="metric"):
        hop_kernel.fused_gather_distances(t, ids, t[:4], "cos")
    meta = torch.empty((50, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        hop_kernel.fused_gather_distances(meta, ids.to("meta"), meta[:4])


def test_imports_without_jax():
    """The port never imports jax, hnsw_tpu or the reference's entry
    points (``__graft_entry__``): every module imports in a process where
    they are unavailable."""
    import hnsw_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(hnsw_tpu_torch.__path__,
                                                   "hnsw_tpu_torch.")]
    assert "hnsw_tpu_torch.dryrun" in names
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['hnsw_tpu'] = None\n"
            "sys.modules['__graft_entry__'] = None\n"
            f"for name in {['hnsw_tpu_torch'] + names!r}:\n"
            "    importlib.import_module(name)\n"
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "for m in sys.modules if sys.modules[m] is not None)\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
