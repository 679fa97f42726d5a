"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and nvcc, and skip without them. The file
imports neither jax nor the reference package, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``chip_smoke.py`` makes the same comparisons at the main path's shapes.)
"""

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
        "fused_gather_distances": 0}


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
