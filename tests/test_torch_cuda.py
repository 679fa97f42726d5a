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
