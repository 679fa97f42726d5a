"""The port's CUDA kernels against their plain PyTorch versions on the card,
and searches replayed from captured CUDA graphs against the eager loop.

These tests need an NVIDIA GPU and nvcc, and skip without them. The file
imports neither jax nor the reference package, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``chip_smoke.py`` makes the same comparisons at the main path's shapes.)
"""

import contextlib
import itertools

import numpy as np
import pytest
import torch

from hnsw_tpu_torch.ops import _cuda, beam_kernel, dist_kernel, hop_kernel


def beam_case(ef, k, qn, seed):
    """Random hop inputs in the reference's [ef, Q] layout: sorted buffers
    (1..ef-1 filled, random expanded bits), candidates with ~20% ids
    already in the buffer and ~15% invalid. The cases of the reference's
    tests/test_beam_kernel.py."""
    rng = np.random.default_rng(seed)
    n_fill = rng.integers(1, ef, qn)
    buf_d = np.full((ef, qn), np.inf, np.float32)
    buf_p = np.full((ef, qn), -1, np.int32)
    for q in range(qn):
        nf = n_fill[q]
        buf_d[:nf, q] = np.sort(rng.standard_normal(nf).astype(np.float32))
        ids = rng.choice(1 << 20, nf, replace=False).astype(np.int32)
        buf_p[:nf, q] = (ids << 1) | (rng.random(nf) < 0.5)
    cand_i = rng.choice(1 << 20, (k, qn)).astype(np.int32)
    dupmask = rng.random((k, qn)) < 0.2
    for q in range(qn):
        kk = np.where(dupmask[:, q])[0]
        if len(kk) and n_fill[q] > 0:
            cand_i[kk, q] = buf_p[rng.integers(0, n_fill[q], len(kk)),
                                  q] >> 1
    cand_i[rng.random((k, qn)) < 0.15] = -1
    cand_d = rng.standard_normal((k, qn)).astype(np.float32)
    return buf_d, buf_p, cand_i, cand_d


BEAM_EDGES = ("invalid", "in_buffer", "converged", "ties", "narrowed")


def beam_edge_case(kind, ef, k, qn, seed):
    """Hop inputs (the reference's [ef, Q] layout) and ef_live on the edges
    the K1 kernel branches on:

      * invalid: every candidate -1;
      * in_buffer: every candidate already in the buffer (no fresh one);
      * converged: every buffer slot expanded, every candidate -1 (what the
        hop loop sends a finished query);
      * ties: buffer and fresh candidates share keys (small integers), the
        buffer all expanded; half a buffer and at most ef // 2 valid
        candidates, so no tie straddles the ef cut and the winner of the
        selection is the one fresh candidate with the least key;
      * narrowed: a random hop with ef_live = ef // 2 + 1 < ef.
    """
    rng = np.random.default_rng(seed)
    buf_d, buf_p, cand_i, cand_d = beam_case(ef, k, qn, seed)
    ef_live = ef
    if kind == "invalid":
        cand_i[:] = -1
    elif kind == "in_buffer":
        for q in range(qn):
            nf = int((buf_p[:, q] >= 0).sum())
            cand_i[:, q] = buf_p[rng.integers(0, nf, k), q] >> 1
    elif kind == "converged":
        buf_p |= 1
        cand_i[:] = -1
    elif kind == "ties":
        half = ef // 2
        buf_d[:] = np.inf
        buf_p[:] = -1
        cand_i[:] = -1
        cand_d[:] = rng.standard_normal((k, qn)).astype(np.float32)
        n_c = min(k, half)
        for q in range(qn):
            ids = rng.choice(1 << 20, half + n_c, replace=False)
            ids = ids.astype(np.int32)
            keys = np.sort(rng.choice(2 * ef, half, replace=False))
            buf_d[:half, q] = keys
            buf_p[:half, q] = (ids[:half] << 1) | 1
            # distinct among the candidates, each equal to a buffer key
            # where one exists
            ck = rng.permutation(np.concatenate(
                [keys, np.arange(2 * ef, 2 * ef + n_c)]))[:n_c]
            cand_i[:n_c, q] = ids[half:]
            cand_d[:n_c, q] = ck
    elif kind == "narrowed":
        ef_live = ef // 2 + 1
    else:
        raise ValueError(kind)
    return (buf_d, buf_p, cand_i, cand_d), ef_live


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(card):
    """Each kernel against its plain version at small shapes (tolerances as
    in chip_smoke.py: f32 sums in another order), and each launch counted."""
    _cuda.reset_launch_counts()
    g = torch.Generator(device=card).manual_seed(0)
    table = torch.randn((5000, 100), generator=g, device=card)
    ids = torch.randint(0, 5000, (256, 64), generator=g, device=card,
                        dtype=torch.int32)
    qs = torch.randn((256, 100), generator=g, device=card)
    for metric in ("l2", "ip"):
        torch.testing.assert_close(
            dist_kernel.gathered_vec_dist_ids(table, ids, qs, metric=metric),
            dist_kernel.gathered_vec_dist_plain(table, ids, qs,
                                                metric=metric),
            rtol=1e-5, atol=1e-3)
    for bits in (8, 4):
        db = 100 if bits == 8 else 50
        codes = torch.randint(0, 256, (5000, 64 * db), generator=g,
                              device=card, dtype=torch.uint8)
        nbr_sq = torch.rand((5000, 64), generator=g, device=card)
        cur = ids[:, 0].contiguous()
        torch.testing.assert_close(
            dist_kernel.packed_row_dist_ids(codes, nbr_sq, cur, qs,
                                            bits=bits, metric="l2"),
            dist_kernel.packed_row_dist_plain(codes, nbr_sq, cur, qs,
                                              bits=bits, metric="l2"),
            rtol=1e-5, atol=1e-2)
    for ef, k, ef_live in ((64, 64, 64), (128, 48, 100), (512, 64, 512)):
        args = [torch.from_numpy(np.ascontiguousarray(a.T)).to(card)
                for a in beam_case(ef, k, 128, ef + k)]
        for got, want in zip(beam_kernel.beam_update(*args, ef_live),
                             beam_kernel.beam_update_plain(*args, ef_live)):
            assert torch.equal(got, want)
    assert _cuda.launch_counts() == {
        "gathered_vec_dist": 2, "packed_row_dist": 2,
        "packed_row_dist_words": 0, "beam_update": 3,
        "fused_gather_distances": 0, "entry_scan": 0}


# (ef, K) on both sides of the warp / block switch at ef + K = 256, with
# 1, 2, 4 and 8 candidates a lane and rows that are not multiples of 4
BEAM_SHAPES = ((32, 16), (64, 64), (128, 64), (192, 64), (193, 64),
               (256, 16), (256, 64), (16, 240), (37, 17), (8, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", BEAM_EDGES)
def test_beam_update_edges_equal_plain_on_card(card, kind):
    """K1 equals its plain version exactly (all four outputs) on every
    branch: the warp path's fast path, hash dedup, bitonic sort and merge,
    and the block path, at Q = 131 (not a multiple of 8 queries a
    block)."""
    _cuda.reset_launch_counts()
    for ef, k in BEAM_SHAPES:
        arrays, ef_live = beam_edge_case(kind, ef, k, 131, ef * 7 + k)
        args = [torch.from_numpy(np.ascontiguousarray(a.T)).to(card)
                for a in arrays]
        got = beam_kernel.beam_update(*args, ef_live)
        want = beam_kernel.beam_update_plain(*args, ef_live)
        for name, g, w in zip(("buf_d", "buf_p", "cur", "ndis"), got, want):
            assert torch.equal(g, w), (kind, ef, k, name)
    assert _cuda.launch_counts()["beam_update"] == len(BEAM_SHAPES)


@pytest.mark.cuda
def test_words_kernel_persistent_grid_and_far_rows_on_card(card):
    """K4's persistent grid at a row count that no grid divides (10,007
    rows, two expansions: 20,014), its bulk-copy path (d = 128 8-bit and
    4-bit, d = 100) and its plain-load path (d = 17 4-bit, d = 101), and a
    table whose last rows sit past 2^31 bytes (270,000 rows of 8 KB)."""
    _cuda.reset_launch_counts()
    g = torch.Generator(device=card).manual_seed(2)
    n_far = 270_000
    words = torch.randint(-2**31, 2**31 - 1, (n_far, 64 * 32), generator=g,
                          device=card, dtype=torch.int32)
    qs = torch.randn((10_007, 128), generator=g, device=card)
    cur = torch.randint(0, n_far, (10_007,), generator=g, device=card,
                        dtype=torch.int32)
    cur[:100] = torch.arange(n_far - 100, n_far, device=card,
                             dtype=torch.int32)
    for c in (cur, cur[:5003 * 2].view(5003, 2)):
        torch.testing.assert_close(
            dist_kernel.packed_row_dist_words_ids(words, c, qs[:c.shape[0]],
                                                  wp=32, bits=8),
            dist_kernel.packed_row_dist_words_plain(words, c,
                                                    qs[:c.shape[0]], wp=32,
                                                    bits=8),
            rtol=1e-5, atol=1e-2)
    del words
    for d, bits, wp in ((128, 4, 16), (100, 8, 32), (17, 4, 4), (101, 8, 32)):
        words = torch.randint(-2**31, 2**31 - 1, (4000, 64 * wp),
                              generator=g, device=card, dtype=torch.int32)
        q = torch.randn((10_007, d), generator=g, device=card)
        c = torch.randint(0, 4000, (10_007,), generator=g, device=card,
                          dtype=torch.int32)
        torch.testing.assert_close(
            dist_kernel.packed_row_dist_words_ids(words, c, q, wp=wp,
                                                  bits=bits),
            dist_kernel.packed_row_dist_words_plain(words, c, q, wp=wp,
                                                    bits=bits),
            rtol=1e-5, atol=1e-2)
    assert _cuda.launch_counts()["packed_row_dist_words"] == 6


@pytest.mark.cuda
def test_words_and_gather_kernels_match_plain_versions_on_card(card):
    """K4 (8/4-bit, padded segments, two expansions per query) and K5 (L2
    and IP, negative and past-the-end ids, d with and without 16-byte
    rows) against their plain versions; tolerances as in chip_smoke.py."""
    _cuda.reset_launch_counts()
    g = torch.Generator(device=card).manual_seed(1)
    for d, bits, wp in ((128, 8, 32), (128, 4, 16), (100, 8, 32),
                        (17, 4, 4)):
        words = torch.randint(-2**31, 2**31 - 1, (3000, 24 * wp),
                              generator=g, device=card, dtype=torch.int32)
        qs = torch.randn((200, d), generator=g, device=card)
        for shape in ((200,), (200, 2)):
            cur = torch.randint(0, 3000, shape, generator=g, device=card,
                                dtype=torch.int32)
            torch.testing.assert_close(
                dist_kernel.packed_row_dist_words_ids(words, cur, qs, wp=wp,
                                                      bits=bits),
                dist_kernel.packed_row_dist_words_plain(words, cur, qs,
                                                        wp=wp, bits=bits),
                rtol=1e-5, atol=1e-2)
    for d in (128, 100, 33):
        table = torch.randn((5000, d), generator=g, device=card)
        ids = torch.randint(-50, 5050, (300, 64), generator=g, device=card,
                            dtype=torch.int32)
        qs = torch.randn((300, d), generator=g, device=card)
        for metric in ("l2", "ip"):
            torch.testing.assert_close(
                hop_kernel.fused_gather_distances(table, ids, qs, metric),
                hop_kernel.fused_gather_distances_plain(table, ids, qs,
                                                        metric),
                rtol=1e-5, atol=1e-3)
    counts = _cuda.launch_counts()
    assert counts["packed_row_dist_words"] == 8
    assert counts["fused_gather_distances"] == 6


@pytest.mark.cuda
@pytest.mark.parametrize("d", (100, 128, 960))
def test_vec_dist_chunks_match_plain_on_card(card, d):
    """K3 (one warp a chunk of 8 candidates, a flat grid of (query, chunk)
    pairs, 128-dim passes) against its plain version at K in {1, 17, 32,
    128, 256} (chunks that are full, ragged and single) and Q in {3, 86,
    2048}, with ~40% of ids masked to row 0 as the build masks them; f32,
    bf16 and uint8 + dequant rows, L2 and IP. Tolerance as in
    chip_smoke.py: rtol 1e-5 + atol 1e-3, f32 sums in another order."""
    _cuda.reset_launch_counts()
    g = torch.Generator(device=card).manual_seed(d)
    n = 5000
    table = torch.randn((n, d), generator=g, device=card)
    codes = torch.randint(0, 256, (n, d), generator=g, device=card,
                          dtype=torch.uint8)
    deq = (torch.randn(d, generator=g, device=card),
           0.01 + 0.02 * torch.rand(d, generator=g, device=card))
    rows = ((table, None), (table.to(torch.bfloat16), None), (codes, deq))
    calls = 0
    for k in (1, 17, 32, 128, 256):
        for q in (3, 86, 2048):
            ids = torch.randint(0, n, (q, k), generator=g, device=card,
                                dtype=torch.int32)
            ids[torch.rand((q, k), generator=g, device=card) < 0.4] = 0
            qs = torch.randn((q, d), generator=g, device=card)
            for tab, dq in rows:
                for metric in ("l2", "ip"):
                    torch.testing.assert_close(
                        dist_kernel.gathered_vec_dist_ids(tab, ids, qs, dq,
                                                          metric=metric),
                        dist_kernel.gathered_vec_dist_plain(tab, ids, qs, dq,
                                                            metric=metric),
                        rtol=1e-5, atol=1e-3)
                    calls += 1
    assert _cuda.launch_counts()["gathered_vec_dist"] == calls


@pytest.mark.cuda
def test_packed_dist_engine_and_byte_path_match_plain_on_card(card):
    """K2 against its plain version: 8-bit and 4-bit at d = 128 (K4's
    engine, bulk ring), 4-bit at d = 127 (the engine's plain-load path: the
    query's d * 4 bytes are no multiple of 16), d = 101 (db % 4 != 0: the
    byte path), one and two
    expansions a query, Q = 8191 (no multiple of the persistent grid), L2
    and IP, and an 8-bit table whose last rows sit past 2^31 bytes
    (270,000 rows of 8 KB). Tolerance as in chip_smoke.py: rtol 1e-5 +
    atol 1e-2."""
    _cuda.reset_launch_counts()
    g = torch.Generator(device=card).manual_seed(3)
    k, q = 64, 8191
    calls = 0
    for d, bits, n in ((128, 8, 270_000), (128, 4, 4000), (127, 4, 4000),
                       (101, 8, 4000), (101, 4, 4000)):
        db = d if bits == 8 else (d + 1) // 2
        codes = torch.randint(0, 256, (n, k * db), generator=g, device=card,
                              dtype=torch.uint8)
        nbr_sq = 100 * torch.rand((n, k), generator=g, device=card)
        cur = torch.randint(0, n, (q + 1,), generator=g, device=card,
                            dtype=torch.int32)
        cur[:100] = torch.arange(n - 100, n, device=card, dtype=torch.int32)
        qs = torch.randn((q + 1, d), generator=g, device=card)
        for c, qq in ((cur[:q], qs[:q]), (cur.view(-1, 2), qs[:(q + 1) // 2])):
            for metric in ("l2", "ip"):
                torch.testing.assert_close(
                    dist_kernel.packed_row_dist_ids(codes, nbr_sq, c, qq,
                                                    bits=bits, metric=metric),
                    dist_kernel.packed_row_dist_plain(codes, nbr_sq, c, qq,
                                                      bits=bits,
                                                      metric=metric),
                    rtol=1e-5, atol=1e-2)
                calls += 1
        del codes, nbr_sq
    assert _cuda.launch_counts()["packed_row_dist"] == calls


@pytest.mark.cuda
def test_packed_dist_equals_words_dots_on_card(card):
    """K2 on a bytes table and K4 on the ``pack_words`` table of the same
    codes (d = 128, 8-bit) run one engine in one order of summation: K2's
    L2 output is ``nbr_sq[cur] - 2 * dots`` and its IP output ``-dots``,
    exactly, with one and two expansions a query."""
    from hnsw_tpu_torch.ops.packed import pack_words
    g = torch.Generator(device=card).manual_seed(4)
    n, k, d, q = 3000, 64, 128, 1000
    vals = torch.randint(0, 256, (n, k, d), generator=g, device=card,
                         dtype=torch.uint8)
    codes = vals.view(n, k * d)
    words = pack_words(vals, 8).view(n, k * 32)
    assert torch.equal(words, codes.view(torch.int32))
    nbr_sq = 100 * torch.rand((n, k), generator=g, device=card)
    qs = torch.randn((q, d), generator=g, device=card)
    for shape in ((q,), (q // 2, 2)):
        cur = torch.randint(0, n, shape, generator=g, device=card,
                            dtype=torch.int32)
        qq = qs[:shape[0]]
        dots = dist_kernel.packed_row_dist_words_ids(words, cur, qq, wp=32,
                                                     bits=8)
        l2 = dist_kernel.packed_row_dist_ids(codes, nbr_sq, cur, qq, bits=8,
                                             metric="l2")
        ip = dist_kernel.packed_row_dist_ids(codes, nbr_sq, cur, qq, bits=8,
                                             metric="ip")
        want = nbr_sq[cur.long()].reshape(dots.shape) - 2.0 * dots
        assert torch.equal(l2, want)
        assert torch.equal(ip, -dots)


@pytest.mark.cuda
def test_vec_dist_codec_rows_match_plain_on_card(card):
    """K3 at the storage codecs' rows: uint8 + dequant at d = 96 (sq8,
    96-byte rows) and bf16 at d = 128, at the serving shape (Q = 8192, K =
    64) and the build's (Q = 2048, K = 256) with ~40% of ids masked to row
    0, L2 and IP. Tolerance as in chip_smoke.py: rtol 1e-5 + atol 1e-3."""
    _cuda.reset_launch_counts()
    g = torch.Generator(device=card).manual_seed(96)
    n = 200_000
    codes = torch.randint(0, 256, (n, 96), generator=g, device=card,
                          dtype=torch.uint8)
    deq = (torch.randn(96, generator=g, device=card),
           0.01 + 0.02 * torch.rand(96, generator=g, device=card))
    bf = torch.randn((n, 128), generator=g, device=card).to(torch.bfloat16)
    calls = 0
    for tab, dq in ((codes, deq), (bf, None)):
        d = tab.shape[1]
        for q, k in ((8192, 64), (2048, 256)):
            ids = torch.randint(0, n, (q, k), generator=g, device=card,
                                dtype=torch.int32)
            ids[torch.rand((q, k), generator=g, device=card) < 0.4] = 0
            qs = torch.randn((q, d), generator=g, device=card)
            for metric in ("l2", "ip"):
                torch.testing.assert_close(
                    dist_kernel.gathered_vec_dist_ids(tab, ids, qs, dq,
                                                      metric=metric),
                    dist_kernel.gathered_vec_dist_plain(tab, ids, qs, dq,
                                                        metric=metric),
                    rtol=1e-5, atol=1e-3)
                calls += 1
    assert _cuda.launch_counts()["gathered_vec_dist"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["sq8", "bfloat16", "pq"])
def test_codec_index_on_card_matches_cpu(card, dtype):
    """One codec index built on the CPU, saved, loaded on the card and on
    the CPU: the card's search (K1, K3 or ADC, and K2 on sq rows packed
    from sq8 storage) returns the CPU run's ids (>= 99%) and distances
    (rtol 1e-5 on matched ids), and every kernel of the path launched."""
    from hnsw_tpu_torch import HnswIndex, synthetic_workload
    wl = synthetic_workload(3000, 32, n_queries=200, seed=5)
    kw = {"pq_m": 8} if dtype == "pq" else {}
    cpu = HnswIndex(32, 8, capacity=4096, ef_construction=60, dtype=dtype,
                    device="cpu", **kw)
    cpu.train(wl.base)
    cpu.add(wl.base)
    gpu = HnswIndex.from_bytes(cpu.to_bytes(), device=card)
    packs = [None, "sq"] if dtype == "sq8" else [None]
    for packed in packs:
        if packed:
            cpu.enable_packed(bits=8)
            gpu.enable_packed(bits=8)
        _cuda.reset_launch_counts()
        d, i = gpu.search(wl.queries, 10, ef_search=48)
        counts = _cuda.launch_counts()
        cd, ci = cpu.search(wl.queries, 10, ef_search=48)
        same = i == ci
        assert same.mean() >= 0.99, (dtype, packed, same.mean())
        np.testing.assert_allclose(d[same], cd[same], rtol=1e-5, atol=1e-4)
        assert counts["beam_update"] > 0
        if dtype != "pq":
            assert counts["gathered_vec_dist"] > 0
        if packed:
            assert counts["packed_row_dist"] > 0


def codec_rows(n, d, g, card):
    """(uint8 codes, dequant affine) and bf16 rows, n x d, on the card."""
    codes = torch.randint(0, 256, (n, d), generator=g, device=card,
                          dtype=torch.uint8)
    deq = (torch.randn(d, generator=g, device=card),
           0.01 + 0.02 * torch.rand(d, generator=g, device=card))
    bf = torch.randn((n, d), generator=g, device=card).to(torch.bfloat16)
    return (codes, deq), (bf, None)


def misaligned_copy(t):
    """``t`` copied to a buffer at a 1-element offset (1 byte for uint8, 2
    for bf16): a table whose base is not 4-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d", (24, 96, 100, 101, 102, 128, 960))
def test_vec_dist_sub_word_rows_match_plain_on_card(card, d):
    """K3 on uint8 + dequant and bf16 rows against its plain version, L2
    and IP, at Q in {5, 2048} and K in {1, 17, 64, 256} with ~40% of ids
    masked to row 0, on every load path: uint8 rows of whole 4-byte words
    (d % 4 == 0); bf16 rows of whole 16-byte (d % 8 == 0), 8-byte (d =
    100) and 4-byte (d = 102) loads; the one-value-a-lane kernel for the
    rest (d = 101; uint8 d = 102; each table copied to a 1-element offset,
    so its base is not 4-byte aligned). Each table is also read as a view
    offset by one row. Tolerance as in chip_smoke.py: rtol 1e-5 + atol
    1e-3."""
    _cuda.reset_launch_counts()
    g = torch.Generator(device=card).manual_seed(d + 1)
    n = 3000
    calls = 0
    for tab, dq in codec_rows(n, d, g, card):
        for view in (tab, tab[1:], misaligned_copy(tab)):
            for q, k in ((5, 17), (2048, 64), (2048, 256), (2048, 1)):
                ids = torch.randint(0, view.shape[0], (q, k), generator=g,
                                    device=card, dtype=torch.int32)
                ids[torch.rand((q, k), generator=g, device=card) < 0.4] = 0
                qs = torch.randn((q, d), generator=g, device=card)
                for metric in ("l2", "ip"):
                    torch.testing.assert_close(
                        dist_kernel.gathered_vec_dist_ids(view, ids, qs, dq,
                                                          metric=metric),
                        dist_kernel.gathered_vec_dist_plain(view, ids, qs, dq,
                                                            metric=metric),
                        rtol=1e-5, atol=1e-3)
                    calls += 1
    assert _cuda.launch_counts()["gathered_vec_dist"] == calls
    tags = _cuda.tagged_launch_counts()["gathered_vec_dist"]
    assert tags == {"uint8": calls // 2, "bfloat16": calls // 2}


@pytest.mark.cuda
@pytest.mark.parametrize("d", (24, 96, 100, 128, 960))
def test_vec_dist_uint8_kernel_keeps_the_order_on_card(card, d):
    """K3's kernel for uint8 rows of whole 4-byte words sums in the order of
    the one-value-a-lane kernel: the same rows read from an aligned table
    and from a copy at a 1-byte offset (which takes the other kernel) give
    equal outputs bit for bit, with and without the dequant affine, L2 and
    IP, at the serving hop, the build's level-0 hop (~45% of ids masked to
    row 0) and its descent (K = 32: 8 candidates a warp)."""
    g = torch.Generator(device=card).manual_seed(7 * d)
    n = 20_000
    (codes, deq), _ = codec_rows(n, d, g, card)
    other = misaligned_copy(codes)
    for q, k, zero in ((8192, 64, 0.0), (2048, 256, 0.45), (2048, 32, 0.4)):
        ids = torch.randint(0, n, (q, k), generator=g, device=card,
                            dtype=torch.int32)
        ids[torch.rand((q, k), generator=g, device=card) < zero] = 0
        qs = torch.randn((q, d), generator=g, device=card)
        for dq, metric in itertools.product((deq, None), ("l2", "ip")):
            got = dist_kernel.gathered_vec_dist_ids(codes, ids, qs, dq,
                                                    metric=metric)
            want = dist_kernel.gathered_vec_dist_ids(other, ids, qs, dq,
                                                     metric=metric)
            assert torch.equal(got, want), (q, k, dq is None, metric)


@pytest.mark.cuda
def test_vec_dist_uint8_table_past_2_31_bytes_on_card(card):
    """K3 on a uint8 + dequant table of 23M x 96 (2.2 GB: row offsets past
    2^31 bytes), reading its last rows and rows across the table, against
    the plain version (rtol 1e-5 + atol 1e-3)."""
    g = torch.Generator(device=card).manual_seed(23)
    n, d, q, k = 23_000_000, 96, 1024, 64
    codes = torch.randint(0, 256, (n, d), generator=g, device=card,
                          dtype=torch.uint8)
    deq = (torch.randn(d, generator=g, device=card),
           0.01 + 0.02 * torch.rand(d, generator=g, device=card))
    ids = torch.randint(0, n, (q, k), generator=g, device=card,
                        dtype=torch.int32)
    ids[:, :8] = torch.arange(n - 8, n, device=card, dtype=torch.int32)
    qs = torch.randn((q, d), generator=g, device=card)
    for metric in ("l2", "ip"):
        torch.testing.assert_close(
            dist_kernel.gathered_vec_dist_ids(codes, ids, qs, deq,
                                              metric=metric),
            dist_kernel.gathered_vec_dist_plain(codes, ids, qs, deq,
                                                metric=metric),
            rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_gather_kernel_bf16_rows_match_plain_on_card(card):
    """K5 on bf16 rows (K3's bf16 engine: 16-byte loads at d = 128 and 96,
    8-byte at d = 100; one value a lane at d = 33 and on a table at a
    1-element offset) against its plain version, L2 and IP, with negative
    and past-the-end ids (clamped); launches counted as bfloat16.
    Tolerance as in chip_smoke.py: rtol 1e-5 + atol 1e-3."""
    _cuda.reset_launch_counts()
    g = torch.Generator(device=card).manual_seed(5)
    calls = 0
    for d in (128, 96, 100, 33):
        table = torch.randn((5000, d), generator=g,
                            device=card).to(torch.bfloat16)
        ids = torch.randint(-50, 5050, (300, 64), generator=g, device=card,
                            dtype=torch.int32)
        qs = torch.randn((300, d), generator=g, device=card)
        for tab in (table, misaligned_copy(table)):
            for metric in ("l2", "ip"):
                torch.testing.assert_close(
                    hop_kernel.fused_gather_distances(tab, ids, qs, metric),
                    hop_kernel.fused_gather_distances_plain(tab, ids, qs,
                                                            metric),
                    rtol=1e-5, atol=1e-3)
                calls += 1
    assert _cuda.tagged_launch_counts()["fused_gather_distances"] == {
        "bfloat16": calls}


@pytest.mark.cuda
@pytest.mark.parametrize("d", (128, 96, 100, 33, 12800))
def test_gather_kernel_equals_vec_dist_kernel_on_card(card, d):
    """K5 runs K3's row engines: on the same f32 and bf16 rows, ids and
    queries, its output equals K3's (``gathered_vec_dist_ids`` with no
    affine) bit for bit, L2 and IP, on aligned tables and on copies at a
    1-element offset (where bf16 rows take another engine), with negative and
    past-the-end ids (K5 clamps them; K3 is given them clamped), at the
    hop's K = 64, the descent's 32 and the entry's 5. d = 12800 is wider
    than the first port's shared-memory query allowed. Both are also held
    against the plain version (rtol 1e-5 + atol 1e-3)."""
    _cuda.reset_launch_counts()
    g = torch.Generator(device=card).manual_seed(d)
    n = 2000 if d < 1000 else 300
    table = torch.randn((n, d), generator=g, device=card)
    calls = 0
    for rows in (table, table.to(torch.bfloat16)):
        for tab in (rows, misaligned_copy(rows)):
            for q, k in ((300, 64), (300, 32), (77, 5)):
                ids = torch.randint(-40, n + 40, (q, k), generator=g,
                                    device=card, dtype=torch.int32)
                qs = torch.randn((q, d), generator=g, device=card)
                for metric in ("l2", "ip"):
                    got = hop_kernel.fused_gather_distances(tab, ids, qs,
                                                            metric)
                    k3 = dist_kernel.gathered_vec_dist_ids(
                        tab, ids.clamp(0, n - 1), qs, metric=metric)
                    assert torch.equal(got, k3), (rows.dtype, q, k, metric)
                    torch.testing.assert_close(
                        got, hop_kernel.fused_gather_distances_plain(
                            tab, ids, qs, metric), rtol=1e-5, atol=1e-3)
                    calls += 1
    assert _cuda.launch_counts()["fused_gather_distances"] == calls
    assert _cuda.tagged_launch_counts()["fused_gather_distances"] == {
        "float32": calls // 2, "bfloat16": calls // 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "sq8"])
def test_vacuum_on_card_matches_cpu(card, dtype):
    """One graph built on the CPU, loaded on the card and on the CPU, the
    same ids removed: vacuum() on the card (repair distances by K3) patches
    the rows the CPU's (K3's plain version) does, and at most 0.2% of them
    differ (a near tie may flip: the kernel and the plain version sum in
    another order, and so do the two matmuls of the heuristic; an H100
    80GB HBM3 at 700 W showed 0 of 2,003 f32 and 0 of 1,998 sq8 rows); no
    live link to a dead id remains, the entry point is live, and K3
    launched."""
    from hnsw_tpu_torch import HnswIndex, synthetic_workload
    wl = synthetic_workload(3000, 32, n_queries=64, seed=9)
    cpu = HnswIndex(32, 8, capacity=4096, ef_construction=60, dtype=dtype,
                    device="cpu")
    cpu.train(wl.base)
    cpu.add(wl.base)
    gpu = HnswIndex.from_bytes(cpu.to_bytes(), device=card)
    dead = np.random.default_rng(0).choice(3000, 600, replace=False)
    for idx in (cpu, gpu):
        idx.remove_ids(dead)
    _cuda.reset_launch_counts()
    assert gpu.vacuum() == cpu.vacuum() == 600
    assert _cuda.launch_counts()["gathered_vec_dist"] > 0
    rows = cpu._last_vacuum["level0"]
    assert gpu._last_vacuum["level0"] == rows > 600
    differ = int((gpu.graph.neighbors0.cpu() !=
                  cpu.graph.neighbors0).any(1).sum())
    print(f"vacuum {dtype}: {differ} of {rows} patched rows differ")
    assert differ <= 0.002 * rows, differ
    assert gpu.check()["links_to_dead"] == 0
    assert bool(gpu._alive[gpu.graph.entry_point])
    _, i = gpu.search(wl.queries, 10, ef_search=64)
    assert not np.isin(i[i >= 0], dead).any()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_refine_rerank_on_card_matches_cpu(card, metric):
    """The refine's rerank (K3 at K = k * k_factor = 40, then topk) on the
    card against its CPU run (K3's plain version) on the same store,
    queries and candidate ids with -1 holes: distances within K3's
    tolerance (rtol 1e-5 + atol 1e-3), ids equal where no two distances
    tie within it, K3 launched."""
    from hnsw_tpu_torch.models.refine import rerank
    g = torch.Generator().manual_seed(3)
    store = torch.randn((20_000, 96), generator=g)
    qs = torch.randn((512, 96), generator=g)
    ids = torch.randint(0, 20_000, (512, 40), generator=g,
                        dtype=torch.int32)
    ids[torch.rand((512, 40), generator=g) < 0.1] = -1
    ids[7] = -1
    want_d, want_i = rerank(store, qs, ids, k=10, metric=metric)
    _cuda.reset_launch_counts()
    d, i = rerank(store.to(card), qs.to(card), ids.to(card), k=10,
                  metric=metric)
    assert _cuda.launch_counts()["gathered_vec_dist"] == 1
    d, i = d.cpu(), i.cpu()
    fin = torch.isfinite(want_d)
    assert torch.equal(torch.isfinite(d), fin)
    torch.testing.assert_close(d[fin], want_d[fin], rtol=1e-5, atol=1e-3)
    gap = (want_d[:, 1:] - want_d[:, :-1]).abs().nan_to_num(1.0)
    tie = torch.zeros_like(fin)
    tie[:, 1:] |= gap <= 1e-3 + 1e-5 * want_d[:, 1:].abs()
    tie[:, :-1] |= gap <= 1e-3 + 1e-5 * want_d[:, 1:].abs()
    assert torch.equal(i[~tie], want_i[~tie])
    assert (i[7] == -1).all()


@pytest.mark.cuda
def test_transforms_apply_on_card_match_numpy(card):
    """PCA and OPQ trained on the card (covariance, cross term and PQ steps
    there): each ``apply`` on the card, from numpy and from a CUDA tensor,
    equals ``x @ a.T + b`` in float64 numpy within rtol 1e-5 (atol 1e-4);
    the PCA's eigenvalues equal a CPU training's within rtol 1e-5, and the
    OPQ's PQ reconstruction error a CPU training's within 2% (the CPU
    wrapper tests' tolerance against the reference), below that of the
    seeded rotation it starts from."""
    from hnsw_tpu_torch.ops import transforms as tf
    from hnsw_tpu_torch.ops.pq import decode_pq, encode_pq, train_pq
    rng = np.random.default_rng(2)
    w = rng.standard_normal((64, 64)) * np.linspace(2.0, 0.05, 64)[None, :]
    x = (rng.standard_normal((20_000, 64)) @ w.T).astype(np.float32)
    pca = tf.PCAMatrix(64, 32, device=card)
    pca.train(x)
    cpu = tf.PCAMatrix(64, 32, device="cpu")
    cpu.train(x)
    np.testing.assert_allclose(pca.eigenvalues, cpu.eigenvalues, rtol=1e-5)
    opq = tf.OPQMatrix(64, 8, ksub=64, niter=3, device=card)
    opq.train(x)
    np.testing.assert_allclose(opq.a @ opq.a.T, np.eye(64), atol=1e-4)
    opq_cpu = tf.OPQMatrix(64, 8, ksub=64, niter=3, device="cpu")
    opq_cpu.train(x)

    def pq_err(a):
        xr = torch.from_numpy(x @ a.T)
        cb = torch.from_numpy(train_pq(xr.numpy(), 8, ksub=64, iters=10,
                                       seed=0, device="cpu"))
        return float(((xr - decode_pq(encode_pq(xr, cb), cb)) ** 2).sum())

    err, err_cpu = pq_err(opq.a), pq_err(opq_cpu.a)
    assert abs(err - err_cpu) <= 0.02 * err_cpu, (err, err_cpu)
    assert err < pq_err(tf._random_rotation(64, 64, 42)), err
    for t in (pca, opq):
        assert t._a_dev.device.type == card.type
        want = x.astype(np.float64) @ t.a.T.astype(np.float64) + t.b
        np.testing.assert_allclose(t.apply(x), want, rtol=1e-5, atol=1e-4)
        y = t.apply(torch.from_numpy(x).to(card))
        assert y.device.type == card.type
        np.testing.assert_allclose(y.cpu().numpy(), want, rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.cuda
def test_host_built_index_on_card(card):
    """build="host" with device=card: the host builder's graph, copied to
    the card, equals a CPU index's host build array for array; its search
    on the card (K1, K3; packed 8-bit also K2) returns the CPU run's ids
    (>= 99%) and distances (rtol 1e-5 on matched ids)."""
    from hnsw_tpu_torch import HnswIndex, synthetic_workload
    wl = synthetic_workload(1500, 32, n_queries=200, seed=6)
    cpu = HnswIndex(32, 8, capacity=2048, ef_construction=60, build="host",
                    device="cpu")
    gpu = HnswIndex(32, 8, capacity=2048, ef_construction=60, build="host",
                    device=card)
    for idx in (cpu, gpu):
        idx.add(wl.base)
    assert gpu.graph.neighbors0.device.type == card.type
    for k, v in cpu.graph.numpy().items():
        np.testing.assert_array_equal(gpu.graph.numpy()[k], v, err_msg=k)
    assert torch.equal(gpu.vectors.cpu(), cpu.vectors)
    for packed in (False, True):
        if packed:
            cpu.enable_packed(bits=8)
            gpu.enable_packed(bits=8)
        _cuda.reset_launch_counts()
        d, i = gpu.search(wl.queries, 10, ef_search=48)
        counts = _cuda.launch_counts()
        cd, ci = cpu.search(wl.queries, 10, ef_search=48)
        same = i == ci
        assert same.mean() >= 0.99, (packed, same.mean())
        np.testing.assert_allclose(d[same], cd[same], rtol=1e-5, atol=1e-4)
        assert counts["beam_update"] > 0 and counts["gathered_vec_dist"] > 0
        if packed:
            assert counts["packed_row_dist"] > 0


def _sharded(devices, wl, **kw):
    from hnsw_tpu_torch import ShardedHnswIndex, make_mesh
    idx = ShardedHnswIndex(32, 8, "l2", mesh=make_mesh(4, devices=devices),
                           capacity_per_shard=2048, ef_construction=60,
                           seed=13, **kw)
    idx.train(wl.base)
    idx.add(wl.base)
    return idx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "sq8"])
def test_sharded_on_card_matches_cpu(card, dtype):
    """The same sharded build and searches on four shards of the card and
    on four of the CPU (the kernels against their plain versions through
    the whole slice): at most 0.2% of each shard's level-0 rows differ (a
    near tie may flip: K3 and its plain version sum in another order);
    searches unpacked, packed bytes and words rows, filtered and with a
    failed shard return the CPU's ids on >= 99% of slots, distances
    within rtol 1e-5 + atol 1e-4 there; K1, K2, K3 and K4 launched."""
    from hnsw_tpu_torch import synthetic_workload
    wl = synthetic_workload(6000, 32, n_queries=256, seed=5)
    _cuda.reset_launch_counts()
    gpu = _sharded([card] * 4, wl, dtype=dtype)
    assert _cuda.launch_counts()["gathered_vec_dist"] > 0
    cpu = _sharded([torch.device("cpu")] * 4, wl, dtype=dtype)
    assert gpu._counts.tolist() == cpu._counts.tolist() == [1500] * 4
    for s in range(4):
        differ = int((gpu._graphs[s].neighbors0.cpu() !=
                      cpu._graphs[s].neighbors0).any(1).sum())
        print(f"sharded {dtype} shard {s}: {differ} of 1500 rows differ")
        assert differ <= 0.002 * 1500, (s, differ)
    allowed = np.arange(6000) % 3 == 0
    for case in ("unpacked", "bytes", "words", "filtered", "degraded"):
        kw = {"allowed": allowed} if case == "filtered" else {}
        for idx in (gpu, cpu):
            if case in ("bytes", "words"):
                idx.enable_packed(bits=8, layout=case)
            if case == "degraded":
                idx.mark_shard_failed(2)
        _cuda.reset_launch_counts()
        d, i = gpu.search(wl.queries, 10, ef_search=64, **kw)
        counts = _cuda.launch_counts()
        cd, ci = cpu.search(wl.queries, 10, ef_search=64, **kw)
        same = i == ci
        assert same.mean() >= 0.99, (case, same.mean())
        np.testing.assert_allclose(d[same], cd[same], rtol=1e-5, atol=1e-4)
        assert counts["gathered_vec_dist"] > 0
        want = {"bytes": "packed_row_dist", "words": "packed_row_dist_words",
                "unpacked": "beam_update"}.get(case)
        assert want is None or counts[want] > 0, (case, counts)
    assert gpu.check()[0]["errors"] == []


@pytest.mark.cuda
def test_sharded_nan_shard_probe_on_card(card, tmp_path):
    """A shard whose vectors are all NaN fails the health probe on the
    card (K3 returns NaN distances, K1 merges NaN keys: no fault, no
    endless loop, no finite hit), exactly that shard; a restore from the
    checkpoint gives back the healthy results."""
    from hnsw_tpu_torch import synthetic_workload
    wl = synthetic_workload(3000, 32, n_queries=64, seed=8)
    idx = _sharded([card] * 4, wl)
    d0, i0 = idx.search(wl.queries, 10, ef_search=64)
    p = str(tmp_path / "ckpt.npz")
    idx.save(p)
    idx._storage[2].rows.fill_(float("nan"))
    report = idx.health_check()
    assert [r["shard"] for r in report if not r["ok"]] == [2], report
    _, i = idx.search(wl.queries, 10, ef_search=64)
    assert not (i[i >= 0] % 4 == 2).any()
    assert idx.restore_shards(p) == [2]
    assert all(r["ok"] for r in idx.health_check())
    d1, i1 = idx.search(wl.queries, 10, ef_search=64)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(d1, d0)


# ---------------------------------------------------------------- captures
def _replay_index(card, dtype="float32", n=6000, d=32):
    """An index built on the card, and its queries."""
    from hnsw_tpu_torch import HnswIndex, synthetic_workload
    wl = synthetic_workload(n + 1000, d, n_queries=300, seed=9)
    kw = {"pq_m": 8} if dtype == "pq" else {}
    idx = HnswIndex(d, 8, capacity=n + 512, ef_construction=60, dtype=dtype,
                    device=card, **kw)
    idx.train(wl.base)
    idx.add(wl.base[:n])
    return idx, wl


def _eager_and_replay(idx, q, **kw):
    """(eager result, replayed result) of one search form, device tensors
    with stats; the second non-eager call is a replay."""
    from hnsw_tpu_torch import graphs
    kw = dict(k=10, ef_search=48, with_stats=True, device_out=True, **kw)
    with graphs.eager():
        want = idx.search(q, **kw)
    idx.search(q, **kw)               # warm-up, capture, first replay
    return want, idx.search(q, **kw)


def _assert_same(got, want):
    (d, i, st), (wd, wi, wst) = got, want
    assert torch.equal(i, wi)
    assert torch.equal(d, wd)          # bit-equal: same kernels, same order
    assert st.hops == wst.hops
    assert torch.equal(st.ndis, wst.ndis)


REPLAY_FORMS = {
    "bytes": ("float32", dict(packed="bytes")),
    "words": ("float32", dict(packed="words")),
    "unpacked": ("float32", {}),
    "descend": ("float32", dict(entry_mode="descend")),
    "sq8": ("sq8", {}),
    "pq_rows": ("sq8", dict(packed="pq")),
    "pq_storage": ("pq", {}),
    "legacy_filtered": ("float32", dict(allowed="even")),
    "legacy_n_expand": ("float32", dict(n_expand=2)),
    "converge": ("float32", dict(max_hops=-1)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(REPLAY_FORMS))
def test_replay_equals_eager_on_card(card, form):
    """Every search form replayed from its capture returns the eager
    loop's ids, hops and ndis, its distances bit for bit."""
    dtype, kw = REPLAY_FORMS[form]
    idx, wl = _replay_index(card, dtype)
    kw = dict(kw)
    packed = kw.pop("packed", None)
    if packed in ("bytes", "words"):
        idx.enable_packed(bits=8, layout=packed)
    elif packed == "pq":
        idx.enable_packed(mode="pq", pq_m=8)
    if kw.get("allowed") == "even":
        kw["allowed"] = np.arange(0, idx.ntotal, 2)
    idx.n_expand = kw.pop("n_expand", 1)
    want, got = _eager_and_replay(idx, wl.queries, **kw)
    _assert_same(got, want)


@pytest.mark.cuda
def test_replay_follows_the_mutable_index_on_card(card):
    """A capture made before add(), remove_ids() + vacuum() and grow()
    replays the index as it is after each (the graph's scalars are inputs;
    grow drops the capture), equal to an eager search of the mutated
    index."""
    from hnsw_tpu_torch import graphs
    idx, wl = _replay_index(card)
    idx.enable_packed(bits=8, reserve=512)    # room for the add in place
    q = wl.queries
    kw = dict(k=10, ef_search=48, with_stats=True, device_out=True)
    idx.search(q, **kw)
    idx.search(q, **kw)
    keys = len(graphs._CACHE)
    idx.add(wl.base[6000:6400])
    assert idx._last_refresh["branch"] == "incremental"
    _assert_same(idx.search(q, **kw), _eager(idx, q, kw))
    assert len(graphs._CACHE) == keys       # replayed, not captured
    idx.remove_ids(np.arange(0, 6400, 7))
    idx.vacuum()
    idx.enable_packed(bits=8)
    got = idx.search(q, **kw)
    _assert_same(got, _eager(idx, q, kw))
    assert not np.isin(got[1].cpu().numpy(), np.arange(0, 6400, 7)).any()
    idx.grow(8192)
    _assert_same(idx.search(q, **kw), _eager(idx, q, kw))


def _eager(idx, q, kw):
    from hnsw_tpu_torch import graphs
    with graphs.eager():
        return idx.search(q, **kw)


@pytest.mark.cuda
def test_replay_outputs_are_the_callers_on_card(card):
    """device_out results are copies: the next search of the same key (a
    replay writing the same graph buffers) leaves them as they were."""
    idx, wl = _replay_index(card)
    kw = dict(k=10, ef_search=48, device_out=True)
    d1, i1 = idx.search(wl.queries[:100], **kw)
    keep = d1.clone(), i1.clone()
    idx.search(wl.queries[100:200], **kw)
    assert torch.equal(d1, keep[0]) and torch.equal(i1, keep[1])


@pytest.mark.cuda
@pytest.mark.parametrize("max_hops", [0, -1])
def test_replay_counts_its_launches_on_card(card, monkeypatch, max_hops):
    """Each replay adds its graphs' recorded launches: the counts of one
    replayed search equal the eager loop's when both run the same steps
    (a bounded loop in one chunk eagerly; a convergence loop in the same
    chunks), and a capture counts nothing."""
    from hnsw_tpu_torch import graphs
    idx, wl = _replay_index(card)
    idx.enable_packed(bits=8)
    kw = dict(k=10, ef_search=48, device_out=True, max_hops=max_hops)
    idx.search(wl.queries, **kw)
    _cuda.reset_launch_counts()
    idx.search(wl.queries, **kw)
    replayed = _cuda.launch_counts()
    if max_hops == 0:
        monkeypatch.setattr(graphs, "LOOP_CHUNK", 1 << 20)
    _cuda.reset_launch_counts()
    _eager(idx, wl.queries, kw)
    assert _cuda.launch_counts() == replayed
    assert replayed["beam_update"] > 0 and replayed["packed_row_dist"] > 0
    assert replayed["gathered_vec_dist"] == 2       # entry and rerank


@pytest.mark.cuda
def test_failed_capture_raises_on_card(card, monkeypatch):
    """A search whose program reads the card mid-capture raises; nothing
    falls back to the eager loop."""
    import hnsw_tpu_torch.ops.storage as storage
    idx, wl = _replay_index(card)
    orig = storage.gathered_vec_dist_ids

    def reads(*a, **kw):
        out = orig(*a, **kw)
        float(out.sum())             # a host read: illegal in a capture
        return out

    monkeypatch.setattr(storage, "gathered_vec_dist_ids", reads)
    with pytest.raises(RuntimeError, match="capture failed"):
        idx.search(wl.queries, 10, ef_search=40)
    monkeypatch.undo()
    d, i = idx.search(wl.queries, 10, ef_search=40)
    assert (i[:, 0] >= 0).all()


# ----------------------------------------------------------- captured builds
def _build_twins(card, dtype="float32", n=10_000, d=32, seed=21):
    """(eager, captured): one index built with ``graphs.eager()`` and one
    built as the card builds (insert batches replayed from captures), on
    the same data and quantizer; and the workload."""
    from hnsw_tpu_torch import HnswIndex, graphs, synthetic_workload
    wl = synthetic_workload(n + 16_000, d, n_queries=64, seed=seed)
    kw = {"pq_m": 8} if dtype == "pq" else {}
    out = []
    for eager in (True, False):
        idx = HnswIndex(d, 8, capacity=4 * n, ef_construction=60,
                        dtype=dtype, device=card, **kw)
        if out and dtype == "pq":     # the same codebooks
            idx._storage.set_codec(out[0]._storage.codec_arrays())
        else:
            idx.train(wl.base)
        _cuda.reset_launch_counts()
        if eager:
            with graphs.eager():
                idx.add(wl.base[:n])
        else:
            idx.add(wl.base[:n])
        idx._launches = _cuda.launch_counts()
        out.append(idx)
    return out[0], out[1], wl


def _assert_same_graph(a, b, n):
    """Every graph array, scalar and stored row equal; ids 0..n-1 written
    and no other row."""
    from hnsw_tpu_torch.graph import SCALAR_FIELDS, TENSOR_FIELDS
    for f in TENSOR_FIELDS:
        assert torch.equal(getattr(a._graph, f), getattr(b._graph, f)), f
    for f in SCALAR_FIELDS:
        assert getattr(a._graph, f) == getattr(b._graph, f), f
    assert torch.equal(a.vectors, b.vectors)
    lv = b._graph.levels.cpu()
    assert b.ntotal == n and (lv[:n] >= 0).all() and (lv[n:] == -1).all()
    assert (b._graph.neighbors0[:n, 0] >= 0).all()
    assert b.check()["errors"] == []


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "sq8", "bfloat16", "pq"])
def test_captured_build_equals_eager_on_card(card, dtype):
    """A build whose batches replay captured graphs equals the eager build
    of the same padded batches array for array (the same kernels in the
    same order), launches K3 as often, and replayed more batches than it
    captured."""
    eager, captured, _ = _build_twins(card, dtype)
    _assert_same_graph(eager, captured, 10_000)
    st = captured._builder.last_stats
    assert st["replayed"] > st.get("captured", 0) >= 1, st
    assert eager._builder.last_stats["batches"] == st["batches"]
    assert captured._launches == eager._launches
    assert captured._builder.last_backlink_dropped == \
        eager._builder.last_backlink_dropped


@pytest.mark.cuda
def test_captured_build_after_second_add_and_grow_on_card(card):
    """A second add() on a built index, and an add() after grow() (new
    graph tensors: the first add's captures are gone), replayed, equal
    the eager build's; no build capture outlives its add()."""
    from hnsw_tpu_torch import build, graphs
    eager, captured, wl = _build_twins(card)
    for lo, step in ((10_000, "add"), (18_000, "grow")):
        for idx in (eager, captured):
            if step == "grow":
                idx.grow(49_152)
            ctx = graphs.eager() if idx is eager else contextlib.nullcontext()
            with ctx:
                idx.add(wl.base[lo:lo + 8000])
        _assert_same_graph(eager, captured, lo + 8000)
        assert captured._builder.last_stats["replayed"] > 0
    assert not [k for k in graphs._CACHE if isinstance(k[0], build._Profile)]


@pytest.mark.cuda
def test_captured_sharded_build_equals_eager_on_card(card):
    """Four shards on the card: each shard's lockstep batches replayed from
    its own captures equal the eager build's, shard for shard."""
    from hnsw_tpu_torch import graphs, synthetic_workload
    from hnsw_tpu_torch.graph import SCALAR_FIELDS, TENSOR_FIELDS
    wl = synthetic_workload(8000, 32, n_queries=64, seed=5)
    with graphs.eager():
        eager = _sharded([card] * 4, wl)
    captured = _sharded([card] * 4, wl)
    for s in range(4):
        a, b = eager._graphs[s], captured._graphs[s]
        for f in TENSOR_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), (s, f)
        for f in SCALAR_FIELDS:
            assert getattr(a, f) == getattr(b, f), (s, f)
        assert torch.equal(eager._storage[s].rows, captured._storage[s].rows)
        assert torch.equal(eager._global_ids[s], captured._global_ids[s])
    assert sum(st["replayed"] for st in captured.last_build_stats) > 0


@pytest.mark.cuda
def test_failed_build_capture_raises_on_card(card, monkeypatch):
    """An insert batch that reads the card mid-capture raises after its
    eager run; nothing falls back to the eager loop."""
    import hnsw_tpu_torch.build as build
    from hnsw_tpu_torch import HnswIndex, synthetic_workload
    wl = synthetic_workload(3000, 32, n_queries=8, seed=3)
    orig = build.select_neighbors

    def reads(*a, **kw):
        out = orig(*a, **kw)
        float(out[0].sum())          # a host read: illegal in a capture
        return out

    monkeypatch.setattr(build, "select_neighbors", reads)
    idx = HnswIndex(32, 8, capacity=4096, ef_construction=40, device=card)
    with pytest.raises(RuntimeError, match="build capture failed"):
        idx.add(wl.base)


# ------------------------------------------------ spans and phase times
SPIN_CYCLES = 20_000_000     # torch.cuda._sleep before a timed replay


def _record_replays(monkeypatch):
    """Wrap ``graphs._Entry.replay``: each replay is appended as (entry,
    its phases, an event pair around the whole replay), after a spin
    kernel, so that the host has launched the chain before the device
    reaches it."""
    from hnsw_tpu_torch import graphs
    seen = []
    orig = graphs._Entry.replay

    def replay(self, inputs, phases=None):
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig(self, inputs, phases)
        b.record()
        seen.append((self, phases, a, b))
        return out

    monkeypatch.setattr(graphs._Entry, "replay", replay)
    return seen


def _record_captures(monkeypatch):
    """Wrap ``graphs.capture``: every entry it makes is appended."""
    from hnsw_tpu_torch import graphs
    made = []
    orig = graphs.capture

    def capture(*a, **kw):
        made.append(orig(*a, **kw))
        return made[-1]

    monkeypatch.setattr(graphs, "capture", capture)
    return made


def _unsplit(entry) -> bool:
    """One chain as without phase marks: no labels, straight graphs only
    between loop graphs."""
    loops = sum(flag is not None for _, _, flag, _ in entry.parts)
    return all(label is None for *_, label in entry.parts) and \
        len(entry.parts) == 2 * loops + 1


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [None, "bytes"])
def test_split_replay_times_its_phases_on_card(card, monkeypatch, packed):
    """A with_stats search is captured as three graphs, entry, hops and
    rerank: its replay equals the eager search bit for bit, its phase ms
    sum to within 5% of one event pair around the whole replay, and
    tracing adds them to the device times. The same search without stats
    stays one graph."""
    from hnsw_tpu_torch import graphs, trace
    idx, wl = _replay_index(card)
    if packed:
        idx.enable_packed(bits=8, layout=packed)
    graphs.clear()
    made = _record_captures(monkeypatch)
    want, got = _eager_and_replay(idx, wl.queries)
    _assert_same(got, want)
    assert want[2].phase_ms.keys() == {"entry", "hops", "rerank"}
    assert [p[3] for p in made[0].parts] == ["entry", "hops", "rerank"]
    seen = _record_replays(monkeypatch)
    with trace.collect() as t:
        _, _, st = idx.search(wl.queries, k=10, ef_search=48,
                              with_stats=True, device_out=True)
    torch.cuda.synchronize()
    (_, _, a, b), = seen
    whole = a.elapsed_time(b)
    assert sum(st.phase_ms.values()) == pytest.approx(whole, rel=0.05)
    assert all(v > 0 for v in st.phase_ms.values())
    for label, ms in st.phase_ms.items():
        assert t.device_ms(f"hnsw.search.{label}") == (1, ms)
    assert t.calls("hnsw.graph.launch") == 3
    assert t.calls("hnsw.search.wait", parent="hnsw.search") == 1
    idx.search(wl.queries, k=10, ef_search=48, device_out=True)
    assert len(made) == 2 and _unsplit(made[1])


@pytest.mark.cuda
def test_traced_build_times_its_stages_on_card(card, monkeypatch):
    """An add() under trace.collect() captures each profile split at the
    six stages: its graph equals an untraced build's array for array, and
    each replayed batch's stage ms sum to within 5% of one event pair
    around its whole replay. Untraced builds capture one chain a profile,
    as without the marks."""
    from hnsw_tpu_torch import HnswIndex, graphs, synthetic_workload, trace
    wl = synthetic_workload(12_000, 32, n_queries=8, seed=23)
    made = _record_captures(monkeypatch)
    plain = HnswIndex(32, 8, capacity=16_384, ef_construction=60,
                      device=card)
    plain.add(wl.base)
    assert made and all(_unsplit(e) for e in made)
    untraced = len(made)
    made.clear()
    seen = _record_replays(monkeypatch)
    traced = HnswIndex(32, 8, capacity=16_384, ef_construction=60,
                       device=card)
    with trace.collect() as t:
        traced.add(wl.base)
    torch.cuda.synchronize()
    _assert_same_graph(plain, traced, 12_000)
    assert len(made) == untraced
    stages = {"write", "descent", "upper", "beams", "select", "backlinks"}
    for e in made:
        labels = [p[3] for p in e.parts]
        assert labels[0] == "write" and labels[-1] == "backlinks"
        assert set(labels) <= stages
    st = traced._builder.last_stats
    assert len(seen) == st["replayed"] > 0
    for _, ph, a, b in seen:
        ms = ph.ms()
        assert {"write", "descent", "beams", "select", "backlinks"} <= \
            ms.keys() <= stages
        assert sum(ms.values()) == pytest.approx(a.elapsed_time(b),
                                                 rel=0.05)
    assert t.device_ms("hnsw.build.beams")[0] == st["replayed"]
    assert t.device_ms("hnsw.build.backlinks")[0] == st["replayed"]
    assert t.calls("hnsw.build.step") == st["batches"]
    assert t.calls("hnsw.build.capture", parent="hnsw.build.step") == \
        st["captured"]
    assert t.counters["captures.build"] == st["captured"]
    assert t.counters["capture_ms.build"] == pytest.approx(
        sum(st["capture_ms"]))
    assert st["capture_ms"] == [e.capture_ms for e in made]


# ------------------------------------------------ K1's hop entry
# (ef, K): the warp path at 1-2 candidates a lane and rows not a multiple
# of 4, and the block path (ef + K > 256)
HOP_SHAPES = ((32, 64), (64, 64), (128, 64), (37, 17), (193, 64), (512, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "ef_live", "seeds",
                                  "at_hop_limit", "past_condition"])
def test_beam_hop_equals_plain_on_card(card, case):
    """K1's hop entry, in place, equals its plain version exactly (buffers,
    cur, ndis, steps) on mid-search states with converged and padded rows,
    seeds waiting, ef_live < ef, at the hop limit and past the condition;
    each hop one launch, counted as K1's."""
    from test_torch_beam_hop import HOP_CASES, hop_case
    counts, ef0, ef_live0, hops, limit = HOP_CASES[case]
    _cuda.reset_launch_counts()
    for ef, k in HOP_SHAPES:
        ef_live = None if ef_live0 is None else ef * 3 // 4 + 1
        s, steps, nbrs0, cd = hop_case(counts, ef, ef_live, hops, ef + k, k)
        s = {n: t.to(card) for n, t in dict(s, steps=steps).items()}
        nbrs0, cd = nbrs0.to(card), cd.to(card)
        lim = torch.tensor(limit, device=card)
        live = None if ef_live is None else torch.tensor(ef_live,
                                                         device=card)
        names = ("buf_d", "buf_p", "cur", "ndis", "steps")
        args = [s[n].clone() for n in names]
        got = beam_kernel.beam_hop(*args, nbrs0, cd, live, lim)
        assert all(g is a for g, a in zip(got, args))
        want = beam_kernel.beam_hop_plain(*(s[n] for n in names), nbrs0, cd,
                                          live, lim)
        for name, g, w in zip(names, got, want):
            assert torch.equal(g, w), (case, ef, k, name)
    assert _cuda.launch_counts()["beam_update"] == len(HOP_SHAPES)
    assert _cuda.tagged_launch_counts()["beam_update"] == {
        "hop": len(HOP_SHAPES)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_vec_dist_by_node_equals_ids_form_on_card(card, dtype):
    """K3 by node (ids from the adjacency row nbrs[cur]) equals K3 on the
    same ids bit for bit where cur and the id are not -1, and is +inf
    elsewhere, at d 96 / 100 / 128 and K 64 / 17; its launches count as
    K3's under the row dtype."""
    g = torch.Generator(device=card).manual_seed(5)
    _cuda.reset_launch_counts()
    for d, k in ((96, 64), (100, 17), (128, 64)):
        if dtype == "uint8":
            table = torch.randint(0, 256, (3000, d), generator=g,
                                  device=card, dtype=torch.uint8)
            dequant = (torch.rand(d, generator=g, device=card),
                       torch.rand(d, generator=g, device=card) / 50)
        else:
            table = torch.randn((3000, d), generator=g,
                                device=card).to(getattr(torch, dtype))
            dequant = None
        nbrs0 = torch.randint(0, 3000, (3000, k), generator=g, device=card,
                              dtype=torch.int32)
        nbrs0[:, -k // 4:] = -1
        cur = torch.randint(-1, 3000, (1031,), generator=g, device=card,
                            dtype=torch.int32)
        qs = torch.randn((1031, d), generator=g, device=card)
        for metric in ("l2", "ip"):
            got = dist_kernel.gathered_vec_dist_cur(table, nbrs0, cur, qs,
                                                    dequant, metric=metric)
            ids = nbrs0[cur.clamp(min=0).long()]
            ok = (cur[:, None] >= 0) & (ids >= 0)
            want = dist_kernel.gathered_vec_dist_ids(
                table, torch.where(ok, ids, 0), qs, dequant, metric=metric)
            assert torch.equal(got[ok], want[ok]), (d, k, metric)
            assert bool((got[~ok] == float("inf")).all()), (d, k, metric)
            torch.testing.assert_close(
                got, dist_kernel.gathered_vec_dist_cur_plain(
                    table, nbrs0, cur, qs, dequant, metric=metric),
                rtol=1e-5, atol=1e-3)
    assert _cuda.tagged_launch_counts()["gathered_vec_dist"] == {dtype: 12}


@pytest.mark.cuda
def test_packed_kernels_skip_rows_without_a_node_on_card(card):
    """K2 (its word engine's bulk and plain-load paths and its byte path)
    and K4 read no row for a cur of -1 and give +inf there; the other rows
    are bit for bit what the same kernel gives with every row read."""
    g = torch.Generator(device=card).manual_seed(6)
    cur = torch.randint(0, 4000, (2051,), generator=g, device=card,
                        dtype=torch.int32)
    dead = torch.rand(2051, generator=g, device=card) < 0.4
    holed = torch.where(dead, -1, cur)
    qs = torch.randn((2051, 128), generator=g, device=card)
    nbr_sq = torch.rand((4000, 64), generator=g, device=card)
    for d, bits, off in ((128, 8, 0), (128, 4, 0), (101, 8, 0),
                         (128, 8, 1)):
        db = d if bits == 8 else (d + 1) // 2
        store = torch.randint(0, 256, (4000 * 64 * db + 4,), generator=g,
                              device=card, dtype=torch.uint8)
        codes = store[off:off + 4000 * 64 * db].view(4000, 64 * db)
        q = qs[:, :d].contiguous()
        for metric in ("l2", "ip"):
            full = dist_kernel.packed_row_dist_ids(codes, nbr_sq, cur, q,
                                                   bits=bits, metric=metric)
            got = dist_kernel.packed_row_dist_ids(codes, nbr_sq, holed, q,
                                                  bits=bits, metric=metric)
            assert torch.equal(got[~dead], full[~dead]), (d, bits, off)
            assert bool((got[dead] == float("inf")).all()), (d, bits, off)
    words = torch.randint(-2**31, 2**31 - 1, (4000, 64 * 32), generator=g,
                          device=card, dtype=torch.int32)
    full = dist_kernel.packed_row_dist_words_ids(words, cur, qs, wp=32,
                                                 bits=8)
    got = dist_kernel.packed_row_dist_words_ids(words, holed, qs, wp=32,
                                                bits=8)
    assert torch.equal(got[~dead], full[~dead])
    assert bool((got[dead] == float("inf")).all())


def composed_fused(entry_ids, entry_dists, neighbors0, dist, *, ef,
                   max_hops, ef_live=None, hop_limit=None, bound=None,
                   loop=None):
    """The fused beam as it ran before its hop moved into K1: each hop the
    expand (the adjacency row gathered, the distance kernel on the made-safe
    cur), its masks, ``beam_update`` at the full width, ef_live applied
    around it, and every output kept where the batch-wide condition is
    false (``torch.where``), with one hop count for the batch."""
    from hnsw_tpu_torch.graphs import EagerLoop
    from hnsw_tpu_torch.ops.beam import INF, BeamState, _limit
    if entry_ids.dim() == 1:
        entry_ids, entry_dists = entry_ids[:, None], entry_dists[:, None]
    q, e = entry_ids.shape
    dev = entry_ids.device
    col = torch.arange(e, device=dev)[None, :]
    active = entry_ids >= 0
    if ef_live is not None:
        active = active & (col < ef_live)
    buf_d = torch.full((q, ef), INF, dtype=torch.float32, device=dev)
    buf_d[:, :e] = torch.where(active, entry_dists.float(), INF)
    buf_p = torch.full((q, ef), -1, dtype=torch.int32, device=dev)
    buf_p[:, :e] = torch.where(active, (entry_ids << 1) | (col == 0).int(), -1)
    s = {"buf_d": buf_d, "buf_p": buf_p,
         "cur": torch.where(active[:, 0], entry_ids[:, 0], -1).to(
             torch.int32),
         "ndis": torch.zeros(q, dtype=torch.int32, device=dev),
         "hops": torch.zeros((), dtype=torch.int32, device=dev)}
    limit = _limit(max_hops, hop_limit)
    slot = torch.arange(ef, device=dev)[None, :]

    def cond(s):
        return (s["cur"] >= 0).any() & (s["hops"] < limit)

    def step(s):
        live = cond(s)
        cur = s["cur"]
        step_ok = cur >= 0
        safe = torch.where(step_ok, cur, 0)
        nbrs, cand_d = neighbors0[safe], dist(safe)
        nbrs = torch.where((nbrs >= 0) & step_ok[:, None], nbrs, -1)
        d, p, c, nd = beam_kernel.beam_update(s["buf_d"], s["buf_p"], nbrs,
                                              cand_d.contiguous(), ef)
        if ef_live is not None:
            dead = slot >= ef_live
            d = torch.where(dead, INF, d)
            p = torch.where(dead, -1, p)
            c = torch.where(((p >> 1) == c[:, None]).any(1), c, -1)
        return {"buf_d": torch.where(live, d, s["buf_d"]),
                "buf_p": torch.where(live, p, s["buf_p"]),
                "cur": torch.where(live, c, cur),
                "ndis": s["ndis"] + torch.where(live, nd, 0),
                "hops": s["hops"] + live.to(torch.int32)}

    s = (loop or EagerLoop()).run(cond, step, s, bound)
    buf_p = s["buf_p"]
    return BeamState(buf_p >> 1, s["buf_d"], (buf_p & 1) == 1, s["hops"],
                     s["ndis"])


# (index dtype, packed rows, search keywords)
HOP_FORMS = {
    "bytes": ("float32", "bytes", {}),
    "bytes_full_bucket": ("float32", "bytes", dict(ef_search=64)),
    "bytes_converge": ("float32", "bytes", dict(max_hops=-1)),
    "words": ("float32", "words", {}),
    "pq_rows": ("sq8", "pq", {}),
    "unpacked": ("float32", None, {}),
    "unpacked_converge": ("float32", None, dict(max_hops=-1)),
    "bf16": ("bfloat16", None, {}),
    "sq8": ("sq8", None, {}),
    "sq8_full_bucket": ("sq8", None, dict(ef_search=64)),
    "pq_storage": ("pq", None, {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(HOP_FORMS))
def test_kernel_hop_equals_composed_hop_on_card(card, monkeypatch, form):
    """A replayed search whose hops run K1's hop entry returns what the
    same replayed search returns with each hop composed around
    ``beam_update`` (``composed_fused``): ids, distances bit for bit,
    hops and ndis; ef < its bucket by default, ef at its bucket, and
    unbounded searches (max_hops=-1) replayed in chunks."""
    from hnsw_tpu_torch import graphs
    from hnsw_tpu_torch.ops import beam as beam_ops
    dtype, packed, extra = HOP_FORMS[form]
    idx, wl = _replay_index(card, dtype)
    if packed in ("bytes", "words"):
        idx.enable_packed(bits=8, layout=packed)
    elif packed == "pq":
        idx.enable_packed(mode="pq", pq_m=8)
    kw = dict(k=10, ef_search=48, with_stats=True, device_out=True)
    kw.update(extra)
    graphs.clear()
    idx.search(wl.queries, **kw)             # warm-up, capture, replay
    got = idx.search(wl.queries, **kw)
    graphs.clear()
    monkeypatch.setattr(beam_ops, "beam_search_fused", composed_fused)
    idx.search(wl.queries, **kw)
    want = idx.search(wl.queries, **kw)
    graphs.clear()
    _assert_same(got, want)
    assert got[2].hops > 0


def _hops_phase_kernels(idx, queries, ef_search):
    """One eager search under torch.profiler: (the device kernels launched
    in its hops phase, by name, the hand kernels' launches of that phase by
    the launch counters). A kernel counts where the operator that launched
    it (the profiler's link between a device event and the operator,
    record_function ranges included) started inside the hops span, so the
    attribution rests on the host's clock alone; the launch counters are
    read on the host at the phase marks. (The caller runs the bounded loop
    in one chunk, so it reads its condition nowhere.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hnsw_tpu_torch import graphs, trace
    orig = trace.Phases.mark
    at_mark = {}

    def mark(self, label):
        at_mark[label] = _cuda.launch_counts()
        orig(self, label)

    kw = dict(k=10, ef_search=ef_search, device_out=True)
    with graphs.eager():
        idx.search(queries, **kw)
        trace.Phases.mark = mark
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                idx.search(queries, **kw)
                torch.cuda.synchronize()
        finally:
            trace.Phases.mark = orig
    events = prof.events()
    (span,) = [e for e in events if e.name == "hnsw.search.hops"
               and e.device_type == DeviceType.CPU]
    t0, t1 = span.time_range.start, span.time_range.end
    inside = [kern.name for e in events if e.device_type == DeviceType.CPU
              and t0 <= e.time_range.start <= t1 for kern in e.kernels]
    launched = {n: at_mark["rerank"][n] - at_mark["hops"][n]
                for n in at_mark["hops"]}
    return inside, launched


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["bytes", "sq8"])
def test_eager_hop_is_two_launches_on_card(card, monkeypatch, form):
    """An eager search launches two kernels a hop in its hops phase, the
    distance kernel (K2 on bytes rows, K3 on sq8 rows) and K1, and counts
    one ``searches.kernel_hop``: at ef 32 and 64 (40 and 72 hops, every
    step of the bounded loop run in one chunk, as a replay runs it) the
    phase launches the hand kernels once each a hop, and the profiler sees
    the same few other kernels in it at both (the state's set-up before
    the loop, the hop count and the outputs after it), so none a hop."""
    from hnsw_tpu_torch import graphs, trace
    monkeypatch.setattr(graphs, "LOOP_CHUNK", 1 << 20)
    idx, wl = _replay_index(card, "float32" if form == "bytes" else "sq8")
    if form == "bytes":
        idx.enable_packed(bits=8)
    dist = "packed_row_dist" if form == "bytes" else "gathered_vec_dist"
    dist_name = "words_dist_kernel" if form == "bytes" else \
        "vec_dist_bytes_kernel"
    others = []
    for ef in (32, 64):
        before = trace.totals().counters.get("searches.kernel_hop", 0)
        inside, launched = _hops_phase_kernels(idx, wl.queries, ef)
        assert trace.totals().counters["searches.kernel_hop"] == before + 2
        steps = ef + 8              # the bounded loop runs every step
        assert launched == dict.fromkeys(launched, 0) | {
            "beam_update": steps, dist: steps}, launched
        others.append(sorted(n.split("(")[0][:120] for n in inside
                             if "beam_warp_kernel" not in n
                             and dist_name not in n))
    # a plain kernel a hop would add 32 between the two
    assert others[0] and len(others[1]) == len(others[0]), others
    assert len(others[1]) <= 48, others[1]


# K6 ``entry_scan``: (Q, S, d, n_seeds, metric, rows). The batch cells'
# shapes (sift, deep, the fan-out's 2.5M shard), the requests cell's padded
# flush, the seed mode's strata of 8 and 256 rows, d off the vector loads,
# Q off the tiles, and one stratum of all the sample
ENTRY_CASES = {
    "sift": (8192, 16384, 128, 4, "l2", "f32"),
    "deep": (8192, 16384, 96, 4, "l2", "sq8"),
    "fanout": (8192, 32768, 96, 8, "l2", "sq8"),
    "flush": (512, 16384, 128, 4, "l2", "f32"),
    "flush_small_ip": (512, 4096, 100, 1, "ip", "f32"),
    "seed_strata_of_8": (512, 128, 128, 16, "l2", "f32"),
    "seed_sq8_ip": (8192, 4096, 128, 16, "ip", "sq8"),
    "wide_ip": (8192, 32768, 128, 16, "ip", "f32"),
    "odd_d": (1000, 2048, 37, 8, "l2", "f32"),
    "d100_sq8": (1000, 4096, 100, 4, "ip", "sq8"),
}


def _entry_inputs(card, q, s, d, n_seeds, rows, seed):
    """Queries (the last eighth all-zero, as padded rows are) and a decoded
    sample: f32 rows, or uint8 codes through an affine; a tenth of the rows
    copy another row of their stratum (exact ties), a tenth masked, and
    stratum 1 masked whole."""
    g = torch.Generator(device=card).manual_seed(seed)
    if rows == "sq8":
        codes = torch.randint(0, 256, (s, d), generator=g, device=card,
                              dtype=torch.uint8)
        sv = torch.randn(d, generator=g, device=card) + (
            torch.rand(d, generator=g, device=card) * 0.05 + 0.01) \
            * codes.float()
    else:
        sv = torch.randn((s, d), generator=g, device=card)
    ss = s // n_seeds
    dst = torch.randperm(s, generator=g, device=card)[:s // 10]
    src = dst // ss * ss + torch.randint(0, ss, dst.shape, generator=g,
                                         device=card)
    sv[dst] = sv[src]
    ok = torch.rand(s, generator=g, device=card) >= 0.1
    if n_seeds > 1:
        ok[ss:2 * ss] = False
    queries = torch.randn((q, d), generator=g, device=card)
    queries[-(q // 8):] = 0
    sv = sv.contiguous()
    return queries, sv, (sv * sv).sum(1), ok


def _assert_seeds_agree(got, want, queries, sv, ok, n_seeds, metric):
    """K6's seeds against the plain version's: -1 exactly where it gives
    -1, equal on >= 99.9% of (query, stratum) pairs, every other pair a
    near-tie (the two rows' float64 distances within 1e-5 relative), and
    among identical rows of a stratum always the first."""
    got, want = got.cpu().long(), want.cpu().long()
    assert torch.equal(got < 0, want < 0)
    same = got == want
    assert same.float().mean() >= 0.999, same.float().mean()
    s = sv.shape[0]
    ss = s // n_seeds
    strat = torch.arange(n_seeds)[None, :].expand_as(got)
    q64, v64 = queries.double().cpu(), sv.double().cpu()

    def dist(qi, r):
        dot = (q64[qi] * v64[r]).sum(1)
        return -dot if metric == "ip" else (v64[r] ** 2).sum(1) - 2 * dot

    qi, j = torch.nonzero(~same, as_tuple=True)
    if len(qi):
        dg = dist(qi, j * ss + got[qi, j])
        dw = dist(qi, j * ss + want[qi, j])
        rel = (dg - dw).abs() / torch.maximum(dg.abs(), dw.abs())
        assert float(rel.max()) <= 1e-5, float(rel.max())
    inv = torch.unique(sv.cpu(), dim=0, return_inverse=True)[1]
    group = torch.arange(s) // ss * (int(inv.max()) + 1) + inv
    okc = ok.cpu()
    first = torch.full((int(group.max()) + 1,), s).scatter_reduce(
        0, group[okc], torch.arange(s)[okc], "amin")
    r = (strat * ss + got)[got >= 0]
    assert torch.equal(first[group[r]], r)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ENTRY_CASES))
def test_entry_scan_matches_plain_on_card(card, case):
    """K6 against the plain composition at the search's shapes, f32 and
    sq8-decoded rows, L2 and IP, masked rows and a masked stratum,
    duplicate rows and padded zero queries; one launch counted."""
    from hnsw_tpu_torch.ops import entry_kernel as ek
    q, s, d, n_seeds, metric, rows = ENTRY_CASES[case]
    queries, sv, svsq, ok = _entry_inputs(card, q, s, d, n_seeds, rows, 7)
    before = _cuda.launch_counts().get("entry_scan", 0)
    got = ek.entry_scan(queries, sv, svsq, ok, n_seeds, metric)
    want = ek.entry_scan_plain(queries, sv, svsq, ok, n_seeds, metric)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["entry_scan"] == before + 1
    assert got.shape == (q, n_seeds) and got.dtype == torch.int32
    _assert_seeds_agree(got, want, queries, sv, ok, n_seeds, metric)
    if n_seeds > 1:
        assert bool((got[:, 1] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n_seeds", [1, 16])
@pytest.mark.parametrize("rows", ["f32", "sq8"])
def test_sample_seeds_below_the_sample_on_card(card, monkeypatch, n_seeds,
                                               rows):
    """``ntotal`` below ``n_sample``: the sample repeats ids (identical
    rows side by side), and the kernel's seeds equal the plain scan's
    exactly, the first of each run of repeats."""
    from types import SimpleNamespace

    from hnsw_tpu_torch import search
    from hnsw_tpu_torch.ops import entry_kernel as ek
    from hnsw_tpu_torch.ops.storage import Storage
    g = torch.Generator(device=card).manual_seed(3)
    n, d = 100, 96
    levels = torch.zeros(n, dtype=torch.int32, device=card)
    levels[::7] = -1
    nbr0 = torch.zeros((n, 4), dtype=torch.int32, device=card)
    graph = SimpleNamespace(levels=levels, neighbors0=nbr0)
    dequant = None
    if rows == "sq8":
        vectors = torch.randint(0, 256, (n, d), generator=g, device=card,
                                dtype=torch.uint8)
        dequant = (torch.randn(d, generator=g, device=card),
                   torch.rand(d, generator=g, device=card) * 0.05 + 0.01)
    else:
        vectors = torch.randn((n, d), generator=g, device=card)
    queries = torch.randn((512, d), generator=g, device=card)
    queries[-64:] = 0
    kw = dict(n_sample=128, n_seeds=n_seeds,
              ntotal=torch.tensor(n, device=card))
    storage = Storage(vectors, sq=dequant)
    got = search._sample_seeds(graph, storage, queries, "l2", **kw)
    monkeypatch.setattr(search, "entry_scan", ek.entry_scan_plain)
    want = search._sample_seeds(graph, storage, queries, "l2", **kw)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("entry_mode", ["sample", "seed"])
def test_searches_scan_on_k6_on_card(card, monkeypatch, entry_mode):
    """A replayed sampled-entry search counts ``searches.kernel_entry`` and
    no ``searches.composed_entry``, K6 launches once a search, and its
    results agree with the same search on the plain scan (ids >= 99%)."""
    from hnsw_tpu_torch import graphs, search, trace
    from hnsw_tpu_torch.ops import entry_kernel as ek
    idx, wl = _replay_index(card, "float32")
    kw = dict(k=10, ef_search=48, device_out=True, entry_mode=entry_mode)
    graphs.clear()
    idx.search(wl.queries, **kw)                 # capture
    before = _cuda.launch_counts()["entry_scan"]
    with trace.collect() as t:
        got = idx.search(wl.queries, **kw)
        torch.cuda.synchronize()
    assert t.counters.get("searches.kernel_entry") == 1
    assert "searches.composed_entry" not in t.counters
    assert _cuda.launch_counts()["entry_scan"] == before + 1
    graphs.clear()
    monkeypatch.setattr(search, "entry_scan", ek.entry_scan_plain)
    want = idx.search(wl.queries, **kw)
    graphs.clear()
    assert float((got[1] == want[1]).float().mean()) >= 0.99
