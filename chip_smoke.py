"""Drive the PyTorch/CUDA port (``hnsw_tpu_torch``) once on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is not 0):

  1. require CUDA; print the card's name and power limit;
  2. build the hand-written kernels (nvcc, sm_90a; one process per source)
     and print the seconds;
  3. hold each of the five kernels against its plain PyTorch version on
     the card, at the main path's shapes (Q=8192, K=64, d=128, ef in {32,
     64, 128, 256, 512}; K1 also with no fresh candidate and converged;
     K3 also at the build's upper-level beam, Q=86 and K=128) and at
     4-bit, bf16, uint8-dequant, odd-d, IP, padded word-segment,
     clamped-id and two-expansion variants, K2 also at the sq8 phase's
     d=96 rows, and Q=8191 for K2's and K4's persistent grid; K2 must equal ``nbr_sq[cur] - 2 * K4 dots`` on the
     same bits exactly (one engine); time both with CUDA events and
     compute each kernel's bound from its inputs;
  4. the main path, ``synthetic_workload(n, 128, n_queries=8192,
     seed=1234)`` (SIFT1M-shaped, n = 1,000,000 by default), in phases on
     ONE index, each with the launch counts set to 0 just before it and
     read just after (every kernel a phase needs must have launched):
       a. build with M=32 / efConstruction=100 and ``check()`` (K3); K3's
          launches counted by K, and on the last insert batch's own ids at
          each K (the build's shapes) K3 held against its plain version
          and timed against its bound;
       b. ``enable_packed(bits=8)`` (bytes rows), exact ground truth from
          ``brute_force_topk`` on the card, k=10 searches at ef in {32, 64,
          128} packed and ef=64 unpacked (K1, K2, K3). Requires packed
          recall@10 >= 0.95 at the best ef and packed and unpacked within
          0.01 at ef=64;
       c. ``enable_packed(bits=8, layout="words")`` after
          ``disable_packed()``; its table must equal the bytes table bit
          for bit; the same packed searches (K1, K4, K3). Requires recall
          >= 0.95 at the best ef and within 0.005 of bytes at each ef;
       d. ``HNSW_TPU_PALLAS_HOP=1`` for this phase only: unpacked ef=64
          (K5). Requires recall within 0.01 of the fused unpacked search;
       e. the legacy beam at ef=64: n_expand=2 on the words rows (K4 with
          two expansions), ``visited_mode="bitmap"`` unpacked, and a
          filtered search with the even ids allowed. Prints recall, qps,
          hops and ndis; requires the filtered result to hold only
          allowed ids, no id twice in a row, and exact squared L2.

  5. K3 at the storage codecs' rows, held against its plain version, timed
     and bounded at Q=8192, K=64: uint8 + dequant at d=96 and bf16 at
     d=128; and the ADC forms (decode + contract; LUT + gather; gather
     from a table made before, the hops' form) timed and compared at the
     same shape. The f32 index is freed first;
  6. the storage codecs, each phase again with the launch counts set to 0
     just before it and read just after, K3's launches also by row dtype:
       f. sq8 storage, Deep10M-shaped (``synthetic_workload(1_000_000, 96,
          n_queries=8192, seed=1234)``, M=32, efConstruction=100):
          ``train(base[:262144])``, ``add``, ``check()`` (K3 on uint8 rows,
          timed at the build's shapes as in 4a); the x̂ oracle
          ``brute_force_topk(dequant=)`` and the true f32 ground truth;
          unpacked search at ef 64 / 128 / 256 (K1, K3; recall@10 against
          x̂ >= 0.95 at the best ef); ``enable_packed(bits=8)`` (K2) at
          ef=64, within 0.01 of unpacked; then PQ-coded routing rows
          (``enable_packed(mode="pq", pq_m=12, train_x=base[:65536])``) at
          ef 64 / 128, recall printed only (the synthetic data is
          PQ-hostile). Returned distances must be exact over x̂;
       g. bf16 storage, SIFT-shaped (300,000 x 128): build (K3 on bf16
          rows, timed at the build's shapes as in 4a) and unpacked ef=64
          search, recall against the bf16 x̂ oracle >= 0.95;
       h. PQ storage, Deep-shaped (300,000 x 96, pq_m=12): ``train``,
          ``add``, search at ef 64 / 128 / 256 (K1, ADC), recall against
          the ADC oracle ``brute_force_topk(pq=)`` >= 0.95 at the best ef,
          counted as ann-benchmarks counts it (a returned distance within
          the oracle's 10th: the reconstructions hold many duplicate
          points, and the oracle's pick among tied ids is arbitrary), with
          the by-id recall over the queries that have no tie at the 10th
          printed beside it;
          ``enable_packed()`` on the stored codes; a ``to_bytes()`` ->
          ``from_bytes()`` round trip whose search returns identical ids
          and distances.

``--n N`` (N >= 300,000) cuts the f32 main path's base to N vectors (the
cut is printed); with no arguments it runs the full 1,000,000. The codec
phases always run at the sizes above. ``--profile`` adds one
``torch.profiler`` window of ef=64 search on bytes and on words rows, and
on sq8 storage unpacked and with PQ-coded rows (2 warm-ups, 10 unprofiled
walls, one profiled call: device busy, busy share, the top ops by device
time); its searches count as main-path launches.

The next-to-last lines are one JSON object with each kernel's launches
(summed over every phase of 4 and 6; K3 by row dtype, one row each),
error, times and bound, and the ``nvidia-smi`` name and power limit; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import time

import numpy as np
import torch

NORTH_STAR_N = 1_000_000
N_QUERIES, HOP_K = 8192, 64      # the main path's query batch and m0
PACKED_ROWS = 300_000            # 8 KB rows: offsets cross 2^31 bytes
SQ8_N = 1_000_000                # phase f: Deep10M cut to 1M (build time)
SMALL_CODEC_N = 300_000          # phases g and h
DEEP_D, DEEP_PQ_M = 96, 12       # Deep's width; pq_m = d // 8 (bench.py)
# NVIDIA's H100 SXM data sheet: HBM bytes/s, and float32 operations/s
# outside the tensor cores (none of these kernels uses them)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SPIN_CYCLES = 400_000_000        # ~0.2 s of torch.cuda._sleep (time_ms)
# (source, replaced TPU kernel) of each kernel, by its launch-count name
KERNELS = {
    "gathered_vec_dist": ("hnsw_tpu_torch/csrc/dist_kernel.cu",
                          "hnsw_tpu/ops/dist_kernel.py:308"),
    "packed_row_dist": ("hnsw_tpu_torch/csrc/dist_kernel.cu",
                        "hnsw_tpu/ops/dist_kernel.py:129"),
    "packed_row_dist_words": ("hnsw_tpu_torch/csrc/dist_kernel.cu",
                              "hnsw_tpu/ops/dist_kernel.py:227"),
    "fused_gather_distances": ("hnsw_tpu_torch/csrc/hop_kernel.cu",
                               "hnsw_tpu/ops/hop_kernel.py:118"),
    "beam_update": ("hnsw_tpu_torch/csrc/beam_kernel.cu",
                    "hnsw_tpu/ops/beam_kernel.py:204"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls.
    A wrapper's host work (checks, output allocation, the ctypes call)
    takes 30-70 us, longer than K1's kernel, so the stream first runs a
    spin kernel (~0.2 s) while the host queues every call: the events then
    time the kernels back to back, not the host's launch rate. Raises if
    the host was still queueing when the spin ended."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pre, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    pre.record()
    torch.cuda._sleep(SPIN_CYCLES)
    t = time.time()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.time() - t) * 1e3
    torch.cuda.synchronize()
    if host_ms >= pre.elapsed_time(start):
        raise AssertionError(f"time_ms: the host took {host_ms:.1f} ms to "
                             f"queue {iters} calls, longer than the spin")
    return start.elapsed_time(end) / iters


def compare(name: str, got: torch.Tensor, want: torch.Tensor, *, rtol: float,
            atol: float) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite output")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: max abs err {err} beyond rtol={rtol}, "
                             f"atol={atol}")
    log(f"  {name}: max abs err {err:.3g} (rtol {rtol}, atol {atol})")
    return err


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the HBM rate and its operations over the f32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes}


def gather_bound(ids: torch.Tensor, d: int, ip: bool, row_elem: int = 4,
                 dequant: bool = False) -> dict:
    """K3 / K5: each distinct row once (d elements of ``row_elem`` bytes),
    ids, queries, the output (and the dequant affine); 2 operations a dim
    for the dot, 2 more for the norm (L2), 2 more for the dequant."""
    q, k = ids.shape
    rows = torch.unique(ids.clamp(min=0)).numel()
    return bound(rows * d * row_elem + q * k * 4 + q * d * 4 + q * k * 4
                 + (2 * d * 4 if dequant else 0),
                 q * k * d * ((2 if ip else 4) + (2 if dequant else 0)))


def check_vec_dist(dev, gen) -> dict:
    """K3. Tolerance: rtol 1e-5 + atol 1e-3 — f32 sums of d terms taken in
    another order than the plain version's. No single PyTorch call gathers
    rows by id and contracts them with a per-query vector: library_ms is
    null."""
    from hnsw_tpu_torch.ops import dist_kernel as dk
    q, k, n = N_QUERIES, HOP_K, NORTH_STAR_N
    out = {}
    for d in (128, 100):
        table = torch.randn((n, d), generator=gen, device=dev)
        qs = torch.randn((q, d), generator=gen, device=dev)
        for kk in (k, 128, 17):          # hop / rerank at ef=128 / entry
            ids = torch.randint(0, n, (q, kk), generator=gen, device=dev,
                                dtype=torch.int32)
            for metric in ("l2", "ip"):
                tag = f"gathered_vec_dist f32 d={d} K={kk} {metric}"
                got = dk.gathered_vec_dist_ids(table, ids, qs, metric=metric)
                want = dk.gathered_vec_dist_plain(table, ids, qs,
                                                  metric=metric)
                err = compare(tag, got, want, rtol=1e-5, atol=1e-3)
                if d == 128 and kk == k and metric == "l2":
                    out["max_abs_err"] = err
                    out.update(gather_bound(ids, d, ip=False))
                    out["ms"] = time_ms(lambda: dk.gathered_vec_dist_ids(
                        table, ids, qs, metric="l2"))
                    out["plain_ms"] = time_ms(
                        lambda: dk.gathered_vec_dist_plain(
                            table, ids, qs, metric="l2"))
        # the build's upper-level beam: 86 queries (a grid that one block
        # per query would leave on 86 SMs), most ids masked to row 0
        ids = torch.randint(0, n, (86, 128), generator=gen, device=dev,
                            dtype=torch.int32)
        ids[torch.rand((86, 128), generator=gen, device=dev) < 0.84] = 0
        for metric in ("l2", "ip"):
            compare(f"gathered_vec_dist f32 d={d} Q=86 K=128 {metric}",
                    dk.gathered_vec_dist_ids(table, ids, qs[:86],
                                             metric=metric),
                    dk.gathered_vec_dist_plain(table, ids, qs[:86],
                                               metric=metric),
                    rtol=1e-5, atol=1e-3)
        ids = torch.randint(0, n, (q, k), generator=gen, device=dev,
                            dtype=torch.int32)
        bf = table.to(torch.bfloat16)
        compare(f"gathered_vec_dist bf16 d={d}",
                dk.gathered_vec_dist_ids(bf, ids, qs, metric="l2"),
                dk.gathered_vec_dist_plain(bf, ids, qs, metric="l2"),
                rtol=1e-5, atol=1e-3)
        codes = torch.randint(0, 256, (n, d), generator=gen, device=dev,
                              dtype=torch.uint8)
        deq = (torch.randn(d, generator=gen, device=dev),
               0.01 + 0.02 * torch.rand(d, generator=gen, device=dev))
        for metric in ("l2", "ip"):
            compare(f"gathered_vec_dist u8+dequant d={d} {metric}",
                    dk.gathered_vec_dist_ids(codes, ids, qs, deq,
                                             metric=metric),
                    dk.gathered_vec_dist_plain(codes, ids, qs, deq,
                                               metric=metric),
                    rtol=1e-5, atol=1e-3)
        vecs = table[ids[:256].long()]
        compare(f"gathered_vec_dist pre-gathered d={d}",
                dk.gathered_vec_dist(vecs, qs[:256], metric="l2"),
                dk.gathered_vec_dist_plain(table, ids[:256], qs[:256],
                                           metric="l2"),
                rtol=1e-5, atol=1e-3)
        del table, codes, bf
    return out


def check_vec_dist_codecs(dev, gen) -> dict:
    """K3 at the storage codecs' serving shape (Q=8192, K=64) over 1M rows:
    uint8 + dequant at d=96 (sq8, 96-byte rows) and bf16 at d=128, L2 and
    IP, against the plain version (check_vec_dist's tolerance), timed and
    bounded (each distinct row once, at its row bytes). Returns one entry
    per row dtype. Then the ADC forms of PQ storage, which are PyTorch ops
    and no kernel (the reference runs them through XLA): decode + contract
    (``adc_decode_distance``), LUT + gather (``pq_lut`` + ``adc_distance``)
    and the gather alone from a table made before (what each hop runs),
    compared and timed at the same shape."""
    from hnsw_tpu_torch.ops import dist_kernel as dk
    from hnsw_tpu_torch.ops import pq
    q, k, n = N_QUERIES, HOP_K, NORTH_STAR_N
    out = {}
    ids = torch.randint(0, n, (q, k), generator=gen, device=dev,
                        dtype=torch.int32)
    for tag, d in (("uint8", DEEP_D), ("bfloat16", 128)):
        qs = torch.randn((q, d), generator=gen, device=dev)
        if tag == "uint8":
            table = torch.randint(0, 256, (n, d), generator=gen, device=dev,
                                  dtype=torch.uint8)
            deq = (torch.randn(d, generator=gen, device=dev),
                   0.01 + 0.02 * torch.rand(d, generator=gen, device=dev))
        else:
            table = torch.randn((n, d), generator=gen,
                                device=dev).to(torch.bfloat16)
            deq = None
        for metric in ("l2", "ip"):
            err = compare(f"gathered_vec_dist {tag} d={d} K={k} {metric}",
                          dk.gathered_vec_dist_ids(table, ids, qs, deq,
                                                   metric=metric),
                          dk.gathered_vec_dist_plain(table, ids, qs, deq,
                                                     metric=metric),
                          rtol=1e-5, atol=1e-3)
            if metric == "l2":
                m = {"max_abs_err": err, "d": d}
                m.update(gather_bound(ids, d, ip=False,
                                      row_elem=table.element_size(),
                                      dequant=deq is not None))
                m["ms"] = time_ms(lambda: dk.gathered_vec_dist_ids(
                    table, ids, qs, deq, metric="l2"))
                m["plain_ms"] = time_ms(lambda: dk.gathered_vec_dist_plain(
                    table, ids, qs, deq, metric="l2"))
                out[tag] = m
        del table
    codes = torch.randint(0, 256, (n, DEEP_PQ_M), generator=gen, device=dev,
                          dtype=torch.uint8)
    cb = torch.randn((DEEP_PQ_M, 256, DEEP_D // DEEP_PQ_M), generator=gen,
                     device=dev)
    qs = torch.randn((q, DEEP_D), generator=gen, device=dev)

    def decode_form():
        return pq.adc_decode_distance(cb, qs, codes[ids.long()], "l2")

    def lut_form():
        return pq.adc_distance(pq.pq_lut(qs, cb, "l2"), codes[ids.long()])

    lut = pq.pq_lut(qs, cb, "l2")

    def hop_form():       # the table made once a search, as the hops use it
        return pq.adc_distance(lut, codes[ids.long()])

    compare(f"ADC decode form vs LUT form, Q={q} K={k} m={DEEP_PQ_M}",
            decode_form(), lut_form(), rtol=1e-5, atol=1e-3)
    log(f"  ADC at Q={q} K={k} m={DEEP_PQ_M} (PyTorch ops, the code gather "
        f"included): decode + contract {time_ms(decode_form):.4f} ms, "
        f"LUT + gather {time_ms(lut_form):.4f} ms, gather from a table made "
        f"before {time_ms(hop_form):.4f} ms")
    return out


def check_packed_dist(dev, gen) -> dict:
    """K2 at the main path's row (64 neighbors x 128 dims x 8 bits = 8 KB)
    over a 300k-row table (2.46 GB, so row offsets cross 2^31), at the sq8
    phase's row (d = 96: 96-byte segments, 24 words a neighbor on K4's
    engine), plus 4-bit, odd d, and, for L2 and IP, one and two expansions
    a query (cur [Q/2, 2]). Tolerance: rtol
    1e-5 + atol 1e-2 (f32 sums of up to 128 code * query terms, each up to
    ~500, in another order). No single PyTorch call reads code rows by id
    and contracts them: library_ms is null."""
    from hnsw_tpu_torch.ops import dist_kernel as dk
    q, k, big = N_QUERIES, HOP_K, PACKED_ROWS
    out = {}
    for d, bits, rows in ((128, 8, big), (128, 4, big), (DEEP_D, 8, big),
                          (101, 8, 20_000), (101, 4, 20_000)):
        db = d if bits == 8 else (d + 1) // 2
        codes = torch.randint(0, 256, (rows, k * db), generator=gen,
                              device=dev, dtype=torch.uint8)
        nbr_sq = 100 * torch.rand((rows, k), generator=gen, device=dev)
        cur = torch.randint(0, rows, (q,), generator=gen, device=dev,
                            dtype=torch.int32)
        cur[:64] = torch.arange(rows - 64, rows, device=dev,
                                dtype=torch.int32)   # the table's last rows
        qs = torch.randn((q, d), generator=gen, device=dev)
        for metric in ("l2", "ip"):
            tag = f"packed_row_dist {bits}-bit d={d} rows={rows} {metric}"
            got = dk.packed_row_dist_ids(codes, nbr_sq, cur, qs, bits=bits,
                                         metric=metric)
            want = dk.packed_row_dist_plain(codes, nbr_sq, cur, qs,
                                            bits=bits, metric=metric)
            err = compare(tag, got, want, rtol=1e-5, atol=1e-2)
            if (d, bits, metric) == (128, 8, "l2"):
                out["max_abs_err"] = err
                rows_read = torch.unique(cur).numel()
                out.update(bound(rows_read * (k * db + k * 4) + q * 4
                                 + q * d * 4 + q * k * 4, q * k * d * 2))
                out["ms"] = time_ms(lambda: dk.packed_row_dist_ids(
                    codes, nbr_sq, cur, qs, bits=8, metric="l2"))
                out["plain_ms"] = time_ms(lambda: dk.packed_row_dist_plain(
                    codes, nbr_sq, cur, qs, bits=8, metric="l2"))
        rows_g = codes[cur[:256].long()]
        compare(f"packed_row_dist pre-gathered {bits}-bit d={d}",
                dk.packed_row_dist(rows_g, qs[:256], nbr_sq[cur[:256].long()],
                                   k=k, bits=bits, metric="l2"),
                dk.packed_row_dist_plain(codes, nbr_sq, cur[:256], qs[:256],
                                         bits=bits, metric="l2"),
                rtol=1e-5, atol=1e-2)
        for (cc, qq, tag), metric in itertools.product(
                ((cur.view(q // 2, 2), qs[:q // 2], "two expansions"),
                 (cur[:q - 1], qs[:q - 1],
                  f"Q={q - 1} (no multiple of the grid)")), ("l2", "ip")):
            compare(f"packed_row_dist {bits}-bit d={d} {tag} {metric}",
                    dk.packed_row_dist_ids(codes, nbr_sq, cc, qq, bits=bits,
                                           metric=metric),
                    dk.packed_row_dist_plain(codes, nbr_sq, cc, qq,
                                             bits=bits, metric=metric),
                    rtol=1e-5, atol=1e-2)
        if (d, bits) == (128, 8):
            k2_equals_k4(codes, nbr_sq, cur, qs)
        del codes, nbr_sq
    return out


def k2_equals_k4(codes, nbr_sq, cur, qs) -> None:
    """K2 on bytes rows and K4 on the ``pack_words`` table of the same codes
    (d = 128, 8-bit) share one engine and one order of summation: K2's L2
    output must equal ``nbr_sq[cur] - 2 * dots`` and its IP output
    ``-dots`` bit for bit. The words table is packed 16,384 rows at a time
    and must hold the bytes table's bits."""
    from hnsw_tpu_torch.ops import dist_kernel as dk
    from hnsw_tpu_torch.ops.packed import pack_words
    rows, k, d = codes.shape[0], nbr_sq.shape[1], qs.shape[1]
    words = torch.cat([pack_words(codes[r:r + 16384].view(-1, k, d), 8)
                       .view(-1, k * (d // 4))
                       for r in range(0, rows, 16384)])
    if not torch.equal(words, codes.view(torch.int32)):
        raise AssertionError("pack_words table differs from the bytes table")
    dots = dk.packed_row_dist_words_ids(words, cur, qs, wp=d // 4, bits=8)
    l2 = dk.packed_row_dist_ids(codes, nbr_sq, cur, qs, bits=8, metric="l2")
    ip = dk.packed_row_dist_ids(codes, nbr_sq, cur, qs, bits=8, metric="ip")
    torch.cuda.synchronize()
    if not torch.equal(l2, nbr_sq[cur.long()] - 2.0 * dots):
        raise AssertionError("packed_row_dist l2 != nbr_sq - 2 * K4 dots")
    if not torch.equal(ip, -dots):
        raise AssertionError("packed_row_dist ip != -K4 dots")
    log(f"  packed_row_dist 8-bit d={d} rows={rows}: l2 equals nbr_sq - 2 * "
        f"K4 dots and ip equals -dots bit for bit (torch.equal)")


def check_words_dist(dev, gen) -> dict:
    """K4 at the main path's rows (64 neighbors x 32 words at d = 128
    8-bit: 8 KB) over a 300k-row table (2.46 GB, so row offsets cross 2^31
    bytes), at (d, bits) in {(128, 8), (128, 4), (100, 8)} (d = 100: 25 of
    32 words carry values), with the table's last rows, two expansions a
    query and Q = 8191, which no persistent grid divides. Words are random
    int32 (every bit pattern). Tolerance: rtol 1e-5 + atol 1e-2, K2's: the
    same sums in another order. No single PyTorch call reads word rows by
    id and contracts them: library_ms is null."""
    from hnsw_tpu_torch.ops import dist_kernel as dk
    from hnsw_tpu_torch.ops.packed import word_width
    q, k, rows = N_QUERIES, HOP_K, PACKED_ROWS
    out = {}
    for d, bits in ((128, 8), (128, 4), (100, 8)):
        wp = word_width(d, bits)
        words = torch.randint(-2**31, 2**31 - 1, (rows, k * wp),
                              generator=gen, device=dev, dtype=torch.int32)
        cur = torch.randint(0, rows, (q,), generator=gen, device=dev,
                            dtype=torch.int32)
        cur[:64] = torch.arange(rows - 64, rows, device=dev,
                                dtype=torch.int32)
        qs = torch.randn((q, d), generator=gen, device=dev)
        for cc, qq, tag in ((cur, qs, "one expansion"),
                            (cur.view(q // 2, 2), qs[:q // 2],
                             "two expansions"),
                            (cur[:q - 1], qs[:q - 1],
                             f"Q={q - 1} (no multiple of the grid)")):
            got = dk.packed_row_dist_words_ids(words, cc, qq, wp=wp,
                                               bits=bits)
            want = dk.packed_row_dist_words_plain(words, cc, qq, wp=wp,
                                                  bits=bits)
            err = compare(f"packed_row_dist_words {bits}-bit d={d} "
                          f"rows={rows} {tag}", got, want, rtol=1e-5,
                          atol=1e-2)
            if (d, bits) == (128, 8) and cc is cur:
                out["max_abs_err"] = err
                nw = -(-d * bits // 32)
                out.update(bound(torch.unique(cur).numel() * k * nw * 4
                                 + q * 4 + q * d * 4 + q * k * 4,
                                 q * k * d * 2))
                out["ms"] = time_ms(lambda: dk.packed_row_dist_words_ids(
                    words, cur, qs, wp=wp, bits=bits))
                out["plain_ms"] = time_ms(
                    lambda: dk.packed_row_dist_words_plain(
                        words, cur, qs, wp=wp, bits=bits))
        del words
    return out


def check_gather_dist(dev, gen) -> dict:
    """K5 at the hop's shape (Q=8192, K=64) over 1M rows, d in {128, 100},
    L2 and IP, with ~1% negative and ~1% past-the-end ids (the kernel's
    clamp). Tolerance: rtol 1e-5 + atol 1e-3, K3's: f32 sums of d terms in
    another order. No single PyTorch call gathers rows by id and contracts
    them: library_ms is null."""
    from hnsw_tpu_torch.ops import hop_kernel as hk
    q, k, n = N_QUERIES, HOP_K, NORTH_STAR_N
    out = {}
    for d in (128, 100):
        table = torch.randn((n, d), generator=gen, device=dev)
        qs = torch.randn((q, d), generator=gen, device=dev)
        ids = torch.randint(0, n, (q, k), generator=gen, device=dev,
                            dtype=torch.int32)
        r = torch.rand((q, k), generator=gen, device=dev)
        ids = torch.where(r < 0.01, -1 - ids % 7, ids)
        ids = torch.where(r > 0.99, n + ids % 7, ids)
        for metric in ("l2", "ip"):
            got = hk.fused_gather_distances(table, ids, qs, metric)
            want = hk.fused_gather_distances_plain(table, ids, qs, metric)
            err = compare(f"fused_gather_distances d={d} {metric}", got,
                          want, rtol=1e-5, atol=1e-3)
            if d == 128 and metric == "l2":
                out["max_abs_err"] = err
                out.update(gather_bound(ids.clamp(0, n - 1), d, ip=False))
                out["ms"] = time_ms(lambda: hk.fused_gather_distances(
                    table, ids, qs, "l2"))
                out["plain_ms"] = time_ms(
                    lambda: hk.fused_gather_distances_plain(table, ids, qs,
                                                            "l2"))
        del table
    return out


def beam_inputs(q: int, ef: int, k: int, dev, gen):
    """Sorted random buffers (1..ef-1 filled, random expanded bits) and
    candidates with ~20% ids already in the buffer and ~15% invalid."""
    fill = torch.randint(1, ef, (q, 1), generator=gen, device=dev)
    slot = torch.arange(ef, device=dev)[None, :]
    live = slot < fill
    buf_d = torch.where(live, torch.randn((q, ef), generator=gen, device=dev),
                        float("inf"))
    buf_d, _ = torch.sort(buf_d, dim=1)
    ids = torch.randint(0, 1 << 20, (q, ef), generator=gen, device=dev,
                        dtype=torch.int32)
    bit = torch.randint(0, 2, (q, ef), generator=gen, device=dev,
                        dtype=torch.int32)
    buf_p = torch.where(live, (ids << 1) | bit, -1)
    cand_i = torch.randint(0, 1 << 20, (q, k), generator=gen, device=dev,
                           dtype=torch.int32)
    pick = torch.randint(0, ef, (q, k), generator=gen, device=dev) % fill
    dup = torch.rand((q, k), generator=gen, device=dev) < 0.2
    cand_i = torch.where(dup, torch.gather(buf_p, 1, pick) >> 1, cand_i)
    cand_i = torch.where(torch.rand((q, k), generator=gen, device=dev) < 0.15,
                         -1, cand_i)
    cand_d = torch.randn((q, k), generator=gen, device=dev)
    return buf_d, buf_p, cand_i, cand_d


def beam_edge(kind: str, args):
    """The K1 branches a random hop does not reach: "no fresh" (every
    candidate already in the buffer or invalid) and "converged" (every slot
    expanded, every candidate -1: what the hop loop sends a finished
    query)."""
    buf_d, buf_p, cand_i, cand_d = args
    if kind == "no fresh":
        fill = (buf_p >= 0).sum(1, keepdim=True)
        pick = torch.arange(cand_i.shape[1], device=buf_p.device)[None] % fill
        cand_i = torch.where(cand_i >= 0, torch.gather(buf_p, 1, pick) >> 1,
                             -1)
    elif kind == "converged":
        buf_p = buf_p | 1
        cand_i = torch.full_like(cand_i, -1)
    return buf_d, buf_p, cand_i, cand_d


def check_beam_update(dev, gen) -> dict:
    """K1: must equal the plain version exactly (both are a stable merge of
    buffer ++ fresh candidates), at Q=8192, K=64, at ef in {32, 64, 128}
    (the warp path: ef + K <= 256) and {256, 512} (the block path), and on
    the no-fresh-candidate and converged fast paths. Its bound counts the
    buffers in and out, the candidates in and cur / ndis out, and as
    operations the K x ef membership compares plus a (ef + K) log2 (ef + K)
    merge a query, at the f32 rate. No single PyTorch call does the hop's
    dedup + merge + selection: library_ms is null."""
    from hnsw_tpu_torch.ops import beam_kernel as bk
    q, k = N_QUERIES, HOP_K
    out = {}
    for ef in (32, 64, 128, 256, 512):
        cases = [(kind, ef_live) for ef_live in sorted({ef, ef * 3 // 4})
                 for kind in ("random", "no fresh", "converged")]
        for kind, ef_live in cases:
            args = beam_edge(kind, beam_inputs(q, ef, k, dev, gen))
            got = bk.beam_update(*args, ef_live)
            want = bk.beam_update_plain(*args, ef_live)
            torch.cuda.synchronize()
            names = ("buf_d", "buf_p", "cur", "ndis")
            for name, g, w in zip(names, got, want):
                if not torch.equal(g, w):
                    bad = int((g != w).sum())
                    raise AssertionError(f"beam_update {kind} ef={ef} "
                                         f"ef_live={ef_live}: {name} "
                                         f"differs in {bad} places")
            err = float((got[0] - want[0]).nan_to_num(0.0).abs().max())
            log(f"  beam_update {kind} ef={ef} ef_live={ef_live}: exact "
                f"(ndis mean {want[3].float().mean():.1f})")
            if ef == 64 and ef_live == ef and kind == "converged":
                log(f"  beam_update converged ef=64: kernel "
                    f"{time_ms(lambda: bk.beam_update(*args, ef_live)):.4f}"
                    f" ms (the fast path)")
            if ef == 64 and ef_live == ef and kind == "random":
                out["max_abs_err"] = err
                m = ef + k
                out.update(bound(q * ef * 8 * 2 + q * k * 8 + q * 8,
                                 q * (k * ef + m * m.bit_length())))
                out["ms"] = time_ms(lambda: bk.beam_update(*args, ef_live))
                out["plain_ms"] = time_ms(
                    lambda: bk.beam_update_plain(*args, ef_live))
    return out


def profile_window(tag: str, fn, top: int = 8) -> None:
    """Where the time of ``fn`` (one search) goes: 2 warm-ups, 10 synced
    walls without the profiler, then one call under ``torch.profiler``.
    Device busy = the union of that window's CUDA events; busy share = busy
    / median unprofiled wall. Prints the ``top`` ops by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.time()
        fn()
        torch.cuda.synchronize()
        walls.append((time.time() - t) * 1e3)
    torch.cuda.synchronize()
    t = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof_wall = (time.time() - t) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    busy = max(busy / 1e3, 1e-9)
    wall = float(np.median(walls))
    log(f"profile {tag}: unprofiled wall median {wall:.1f} ms (range "
        f"{min(walls):.1f}-{max(walls):.1f}), profiled wall {prof_wall:.1f} "
        f"ms, device busy {busy:.2f} ms, busy share {busy / wall:.3f} / "
        f"{busy / prof_wall:.3f} (of the profiled wall)")

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0

    ops = sorted(prof.key_averages(), key=dev_us, reverse=True)[:top]
    for e in ops:
        us = dev_us(e)
        log(f"  {e.key[:60]}: {us / 1e3:.3f} ms device ({us / 1e3 / busy:.1%}"
            f" of busy), {e.count} calls")


def phase(name: str, need: tuple, totals: dict, fn, need_tags: tuple = ()):
    """Run one main-path phase with the launch counts set to 0 just before
    it and read just after; every kernel in ``need`` must have launched,
    and every (kernel, tag) in ``need_tags`` (K3's row dtype) too. Adds the
    phase's counts to ``totals``, and the tagged ones to
    ``totals["by_tag"]``."""
    from hnsw_tpu_torch.ops import _cuda
    _cuda.reset_launch_counts()
    result = fn()
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    tagged = _cuda.tagged_launch_counts()
    log(f"phase {name}: kernel launches {counts}, by tag {tagged}")
    missing = [k for k in need if counts[k] == 0]
    missing += [f"{k} on {t} rows" for k, t in need_tags
                if tagged.get(k, {}).get(t, 0) == 0]
    if missing:
        raise AssertionError(f"phase {name}: kernels never launched: "
                             f"{missing}")
    for k, c in counts.items():
        totals[k] = totals.get(k, 0) + c
    by_tag = totals.setdefault("by_tag", {})
    for k, tags in tagged.items():
        for t, c in tags.items():
            by_tag[(k, t)] = by_tag.get((k, t), 0) + c
    return result


def capture_build_k3(build, k3_build: dict):
    """Run ``build`` with K3's entry point wrapped: count its launches by
    K (candidates a query) and keep each K's last call at its widest Q
    (a late insert batch, at ~n points), which ``measure_build_k3``
    times."""
    import hnsw_tpu_torch.search as search
    orig = search.gathered_vec_dist_ids

    def recording(table, ids, qs, dequant=None, *, metric):
        k = ids.shape[1]
        rec = k3_build.setdefault(k, {"launches": 0, "args": None})
        rec["launches"] += 1
        if rec["args"] is None or ids.shape[0] >= rec["args"][1].shape[0]:
            # the last widest call
            rec["args"] = (table, ids, qs, dequant, metric)
        return orig(table, ids, qs, dequant, metric=metric)

    search.gathered_vec_dist_ids = recording
    try:
        return build()
    finally:
        search.gathered_vec_dist_ids = orig


def measure_build_k3(k3_build: dict) -> None:
    """K3 at the build's shapes (PERF.md's build row): per K, its launches
    in the build, and on the last call's own ids the kernel held against
    its plain version (check_vec_dist's tolerance), the kernel and plain
    times and the bound (each distinct row once). Ids the caller masked
    read row 0; their share is printed."""
    from hnsw_tpu_torch.ops import dist_kernel as dk
    for k in sorted(k3_build):
        rec = k3_build[k]
        table, ids, qs, deq, metric = rec["args"]
        rows_of = str(table.dtype).removeprefix("torch.")
        compare(f"gathered_vec_dist ({rows_of} rows) at the build's "
                f"Q={ids.shape[0]} K={k}",
                dk.gathered_vec_dist_ids(table, ids, qs, deq, metric=metric),
                dk.gathered_vec_dist_plain(table, ids, qs, deq,
                                           metric=metric),
                rtol=1e-5, atol=1e-3)
        b = gather_bound(ids, table.shape[1], ip=metric == "ip",
                         row_elem=table.element_size(),
                         dequant=deq is not None)
        ms = time_ms(lambda: dk.gathered_vec_dist_ids(table, ids, qs, deq,
                                                      metric=metric))
        plain = time_ms(lambda: dk.gathered_vec_dist_plain(
            table, ids, qs, deq, metric=metric))
        rows = torch.unique(ids).numel()
        log(f"K3 ({rows_of} rows) at the build's shape Q={ids.shape[0]} "
            f"K={k}: "
            f"{rec['launches']} launches in the build; kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, bound {b['bound_ms']:.4f} ms by "
            f"{b['bound_by']} ({b['bytes'] / 1e6:.2f} MB, {rows} distinct "
            f"rows, row-0 share {float((ids == 0).float().mean()):.3f}), "
            f"share of bound {b['bound_ms'] / ms:.2f}")


def timed(fn, runs=2):
    """(result, best synced wall seconds of ``runs`` runs)."""
    best = None
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.time()
        res = fn()
        torch.cuda.synchronize()
        dt = time.time() - t
        best = dt if best is None else min(best, dt)
    return res, best


def report(tag, res, secs, gt_ids, runs=2, truth=None):
    """Print one search's recall@10 against ``gt_ids`` (and against
    ``truth``, the f32 ground truth, where a codec's oracle is x̂), qps,
    hops and ndis; raise on a malformed result. Returns the recall."""
    from hnsw_tpu_torch.utils.recall import recall_at_k
    d, i, st = res
    if tuple(i.shape) != (N_QUERIES, 10) or not torch.isfinite(
            d[i >= 0]).all():
        raise AssertionError(f"{tag}: search output malformed")
    ids = i.cpu().numpy()
    r = recall_at_k(ids, gt_ids, 10)
    vs_truth = "" if truth is None else \
        f" (against the f32 truth {recall_at_k(ids, truth, 10):.4f})"
    log(f"search {tag}: recall@10 {r:.4f}{vs_truth}, {N_QUERIES / secs:.0f} "
        f"qps (best of {runs}, {secs * 1e3:.1f} ms), hops {st.hops}, ndis "
        f"mean {st.ndis.float().mean():.1f}")
    return r


def exact_l2(tag, queries, d, i, rows):
    """Returned distances are exact squared L2 to the stored vectors of
    the returned ids (``rows(ids)``: f32, or x̂ of a codec)."""
    ok = i >= 0
    x = rows(i.long().clamp(min=0))
    exact = ((queries[:, None, :] - x) ** 2).sum(-1)
    if not torch.allclose(d[ok], exact[ok], rtol=1e-4, atol=1e-3):
        raise AssertionError(f"{tag}: returned distances are not exact "
                             f"squared L2")


def main_path(n: int, dev, totals: dict, profile: bool = False) -> dict:
    from hnsw_tpu_torch import HnswIndex, synthetic_workload
    from hnsw_tpu_torch.ops.distances import brute_force_topk
    from hnsw_tpu_torch.search import hnsw_search

    t0 = time.time()
    wl = synthetic_workload(n, 128, n_queries=N_QUERIES, seed=1234)
    log(f"workload: {n} x 128 base, {N_QUERIES} queries "
        f"({time.time() - t0:.1f} s)")
    torch.cuda.reset_peak_memory_stats()
    idx = HnswIndex(128, 32, "l2", capacity=n, ef_construction=100,
                    device=dev)
    k3_build: dict = {}

    def build():
        t0 = time.time()
        idx.add(wl.base)
        torch.cuda.synchronize()
        build_s = time.time() - t0
        log(f"build: {build_s:.1f} s ({n / build_s:.0f} inserts/s), "
            f"back-link window drops {idx._builder.last_backlink_dropped}")
        t0 = time.time()
        stats = idx.check()
        log(f"check: {time.time() - t0:.1f} s, errors {stats['errors']}, "
            f"deg0_mean {stats['deg0_mean']:.2f}, reciprocity0 "
            f"{stats['reciprocity0']:.4f}, max_level {stats['max_level']}")
        if stats["errors"]:
            raise AssertionError(f"graph invariants: {stats['errors']}")
        return build_s

    build_s = phase("build", ("gathered_vec_dist",), totals,
                    lambda: capture_build_k3(build, k3_build))
    queries = torch.from_numpy(wl.queries).to(dev)
    measure_build_k3(k3_build)
    del k3_build

    def run(ef, packed, tag):
        res, secs = timed(lambda: idx.search(
            queries, 10, ef_search=ef, with_stats=True, use_packed=packed,
            device_out=True))
        return report(f"{tag} ef={ef}", res, secs, gt), res

    def profiled(ef, tag):
        if profile:
            profile_window(f"{tag} ef={ef}", lambda: idx.search(
                queries, 10, ef_search=ef, use_packed=True, device_out=True))

    def check_exact(tag, d, i):
        exact_l2(tag, queries, d, i, lambda ids: idx.vectors[ids])

    gt = None

    def bytes_phase():
        nonlocal gt
        t0 = time.time()
        nbytes = idx.enable_packed(bits=8)
        torch.cuda.synchronize()
        log(f"enable_packed(bits=8): {nbytes} bytes ({nbytes / 1e9:.2f} GB) "
            f"in {time.time() - t0:.1f} s")
        t0 = time.time()
        _, gt_t = brute_force_topk(queries, idx.vectors, 10, "l2", n_valid=n)
        gt = gt_t.cpu().numpy()
        log(f"ground truth (brute_force_topk on the card): "
            f"{time.time() - t0:.1f} s")
        recalls = {ef: run(ef, True, "packed bytes")[0] for ef in (32, 64, 128)}
        profiled(64, "packed bytes")
        unpacked, (d, i, _) = run(64, False, "unpacked")
        check_exact("unpacked ef=64", d[:, :1], i[:, :1])
        best = max(recalls.values())
        if best < 0.95:
            raise AssertionError(f"packed recall@10 {best:.4f} < 0.95")
        if abs(recalls[64] - unpacked) > 0.01:
            raise AssertionError(f"packed {recalls[64]:.4f} vs unpacked "
                                 f"{unpacked:.4f} recall at ef=64 differ > "
                                 f"0.01")
        return recalls, unpacked

    recalls, unpacked = phase(
        "bytes search", ("beam_update", "packed_row_dist",
                         "gathered_vec_dist"), totals, bytes_phase)

    def words_phase():
        # the bytes table waits on the host, so two 8.45 GB tables never
        # sit on the card at once
        t0 = time.time()
        host_bytes = idx._packed.nbr_codes.cpu()
        idx.disable_packed()
        nbytes = idx.enable_packed(bits=8, layout="words")
        torch.cuda.synchronize()
        words = idx._packed.nbr_codes.view(torch.uint8)
        same = words.shape == host_bytes.shape and all(
            torch.equal(words[r:r + 65536], host_bytes[r:r + 65536].to(dev))
            for r in range(0, words.shape[0], 65536))
        log(f"enable_packed(bits=8, layout='words'): {nbytes} bytes, equal "
            f"to the bytes table bit for bit: {same} "
            f"({time.time() - t0:.1f} s with the host copy and compare)")
        if not same:
            raise AssertionError("words table differs from the bytes table")
        del host_bytes
        out = {}
        for ef in (32, 64, 128):
            out[ef], (d, i, _) = run(ef, True, "packed words")
            if abs(out[ef] - recalls[ef]) > 0.005:
                raise AssertionError(f"words {out[ef]:.4f} vs bytes "
                                     f"{recalls[ef]:.4f} at ef={ef} differ "
                                     f"> 0.005")
        if max(out.values()) < 0.95:
            raise AssertionError(f"words recall@10 {max(out.values()):.4f} "
                                 f"< 0.95")
        profiled(64, "packed words")
        return out

    words = phase("words search", ("beam_update", "packed_row_dist_words",
                                   "gathered_vec_dist"), totals, words_phase)

    def pallas_phase():
        os.environ["HNSW_TPU_PALLAS_HOP"] = "1"
        try:
            r, (d, i, _) = run(64, False, "unpacked HNSW_TPU_PALLAS_HOP=1")
        finally:
            del os.environ["HNSW_TPU_PALLAS_HOP"]
        check_exact("pallas hop", d[:, :1], i[:, :1])
        if abs(r - unpacked) > 0.01:
            raise AssertionError(f"HNSW_TPU_PALLAS_HOP=1 recall {r:.4f} vs "
                                 f"fused unpacked {unpacked:.4f} differ > "
                                 f"0.01")
        return r

    pallas = phase("pallas hop", ("fused_gather_distances",), totals,
                   pallas_phase)

    def legacy_phase():
        out = {}
        idx.n_expand = 2
        try:
            out["n_expand=2 words"], _ = run(64, True, "words n_expand=2")
        finally:
            idx.n_expand = 1
        res, secs = timed(lambda: hnsw_search(
            idx.graph, idx.vectors, queries, k=10, ef_search=64,
            with_stats=True, visited_mode="bitmap"), runs=1)
        out["bitmap"] = report("unpacked visited_mode=bitmap ef=64", res,
                               secs, gt, runs=1)
        even = torch.arange(n, device=dev) % 2 == 0
        _, gt_even = brute_force_topk(queries, idx.vectors[0::2].contiguous(),
                                      10, "l2")
        gt_even = (gt_even * 2).cpu().numpy()
        res, secs = timed(lambda: idx.search(
            queries, 10, ef_search=64, with_stats=True, allowed=even,
            device_out=True), runs=1)
        out["filtered"] = report("words filtered (even ids) ef=64", res,
                                 secs, gt_even, runs=1)
        d, i, _ = res
        ok = i >= 0
        if not bool(even[i[ok].long()].all()):
            raise AssertionError("filtered search returned a disallowed id")
        srt = torch.sort(torch.where(ok, i, -1 - torch.arange(
            10, device=dev)[None, :]), dim=1).values
        if bool((srt[:, 1:] == srt[:, :-1]).any()):
            raise AssertionError("filtered search repeated an id in a row")
        check_exact("filtered", d, i)
        return out

    legacy = phase("legacy beam", ("packed_row_dist_words",
                                   "gathered_vec_dist"), totals, legacy_phase)
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return {"build_s": build_s, "recall": recalls, "unpacked": unpacked,
            "words": words, "pallas": pallas, "legacy": legacy}


def stored_rows(idx):
    """ids -> the stored vectors of ``idx`` as f32 on the card: x̂ for sq8
    (the affine) and PQ (the codebooks), the bf16 values for bf16."""
    from hnsw_tpu_torch.ops.distances import decode_rows
    return lambda ids: decode_rows(idx.vectors[ids], idx._sq, idx._pq)


def oracles(idx, queries, base: np.ndarray, n: int, dev):
    """The x̂ oracle (brute_force_topk over the stored codes, ``dequant=`` /
    ``pq=``, tiles decoded on the fly) and the f32 truth (over the raw
    base): (x̂ ids [Q, 10] numpy, x̂ squared L2 [Q, 11] on the card, truth
    ids [Q, 10] numpy). Prints the share of queries whose 10th and 11th x̂
    neighbours tie: there, which of the tied ids the oracle lists is
    arbitrary."""
    from hnsw_tpu_torch.ops.distances import brute_force_topk
    t0 = time.time()
    hat_d, hat = brute_force_topk(queries, idx.vectors, 11, n_valid=n,
                                  dequant=idx._sq, pq=idx._pq)
    raw = torch.from_numpy(base).to(dev)
    _, truth = brute_force_topk(queries, raw, 10)
    del raw
    tie = float((hat_d[:, 10] <= hat_d[:, 9] * (1 + 1e-5)).float().mean())
    log(f"oracles (x̂ and f32 truth, brute_force_topk on the card): "
        f"{time.time() - t0:.1f} s; 10th and 11th x̂ neighbours tie for "
        f"{tie:.4f} of the queries")
    return hat[:, :10].cpu().numpy(), hat_d, truth.cpu().numpy()


def recall_ties(d, i, hat_d, k: int = 10) -> float:
    """Recall@k as ann-benchmarks counts it: a returned id is a hit when its
    distance is within the oracle's k-th distance (here rtol 1e-5 for f32
    rounding). Where the data holds duplicate points (PQ reconstructions),
    many ids share the k-th distance and which of them the oracle lists is
    arbitrary, so the id-based recall undercounts a search that is exact.
    The returned distances must be exact over x̂ (``exact_l2``)."""
    kth = hat_d[:, k - 1:k]
    hit = (i[:, :k] >= 0) & (d[:, :k] <= kth + kth.abs() * 1e-5)
    return float(hit.float().mean())


def recall_untied(i, hat: np.ndarray, hat_d, k: int = 10):
    """(by-id recall@k, queries counted) over the queries whose k-th and
    (k+1)-th oracle distances do not tie (``oracles``' test): there the
    oracle's top-k set is unique, so ids alone count, with no distance
    tolerance. The second witness beside ``recall_ties``."""
    from hnsw_tpu_torch.utils.recall import recall_at_k
    untied = (hat_d[:, k] > hat_d[:, k - 1] * (1 + 1e-5)).cpu().numpy()
    return (recall_at_k(i[:, :k].cpu().numpy()[untied], hat[untied], k),
            int(untied.sum()))


def build_codec(idx, base: np.ndarray, train_x: np.ndarray, tag: str):
    """train + add + check() of a codec index; prints seconds and stats."""
    t0 = time.time()
    idx.train(train_x)
    torch.cuda.synchronize()
    t1 = time.time()
    idx.add(base)
    torch.cuda.synchronize()
    build_s = time.time() - t1
    stats = idx.check()
    log(f"{tag} build: train {t1 - t0:.1f} s, add {build_s:.1f} s "
        f"({len(base) / build_s:.0f} inserts/s), errors {stats['errors']}, "
        f"deg0_mean {stats['deg0_mean']:.2f}, reciprocity0 "
        f"{stats['reciprocity0']:.4f}")
    if stats["errors"]:
        raise AssertionError(f"{tag} graph invariants: {stats['errors']}")
    return build_s


def codec_path(dev, totals: dict, profile: bool = False) -> dict:
    """Phases f, g and h (module docstring): sq8, bf16 and PQ storage."""
    from hnsw_tpu_torch import HnswIndex, synthetic_workload
    out = {}

    def search(idx, queries, ef, packed=None):
        return timed(lambda: idx.search(queries, 10, ef_search=ef,
                                        with_stats=True, use_packed=packed,
                                        device_out=True))

    def profiled(idx, queries, tag):
        if profile:
            profile_window(f"{tag} ef=64", lambda: idx.search(
                queries, 10, ef_search=64, device_out=True))

    # ---- f. sq8 storage, Deep10M-shaped at 1M
    n, d = SQ8_N, DEEP_D
    wl = synthetic_workload(n, d, n_queries=N_QUERIES, seed=1234)
    queries = torch.from_numpy(wl.queries).to(dev)
    torch.cuda.reset_peak_memory_stats()
    idx = HnswIndex(d, 32, "l2", capacity=n, ef_construction=100,
                    dtype="sq8", device=dev)
    k3_build: dict = {}
    out["sq8_build_s"] = phase(
        "sq8 build", ("gathered_vec_dist",), totals,
        lambda: capture_build_k3(lambda: build_codec(
            idx, wl.base, wl.base[:262144], "sq8"), k3_build),
        need_tags=(("gathered_vec_dist", "uint8"),))
    measure_build_k3(k3_build)
    del k3_build
    gt_hat, _, gt_true = oracles(idx, queries, wl.base, n, dev)

    def sq8_search():
        rec = {}
        for ef in (64, 128, 256):
            res, secs = search(idx, queries, ef)
            rec[ef] = report(f"sq8 unpacked ef={ef}", res, secs, gt_hat,
                             truth=gt_true)
            if ef == 64:
                exact_l2("sq8 unpacked", queries, res[0], res[1],
                         stored_rows(idx))
        profiled(idx, queries, "sq8 unpacked")
        if max(rec.values()) < 0.95:
            raise AssertionError(f"sq8 recall@10 against x̂ "
                                 f"{max(rec.values()):.4f} < 0.95")
        return rec

    out["sq8"] = phase("sq8 search", ("beam_update", "gathered_vec_dist"),
                       totals, sq8_search,
                       need_tags=(("gathered_vec_dist", "uint8"),))

    def sq8_packed():
        t0 = time.time()
        nbytes = idx.enable_packed(bits=8)
        torch.cuda.synchronize()
        log(f"sq8 enable_packed(bits=8): {nbytes} bytes "
            f"({nbytes / 1e9:.2f} GB) in {time.time() - t0:.1f} s")
        res, secs = search(idx, queries, 64, True)
        r = report("sq8 packed sq rows ef=64", res, secs, gt_hat,
                   truth=gt_true)
        exact_l2("sq8 packed", queries, res[0], res[1], stored_rows(idx))
        if abs(r - out["sq8"][64]) > 0.01:
            raise AssertionError(f"sq8 packed {r:.4f} vs unpacked "
                                 f"{out['sq8'][64]:.4f} at ef=64 differ "
                                 f"> 0.01")
        return r

    out["sq8_packed"] = phase(
        "sq8 packed", ("beam_update", "packed_row_dist", "gathered_vec_dist"),
        totals, sq8_packed)

    def sq8_pq_rows():
        idx.disable_packed()
        t0 = time.time()
        nbytes = idx.enable_packed(mode="pq", pq_m=DEEP_PQ_M, pq_bits=8,
                                   train_x=wl.base[:65536])
        torch.cuda.synchronize()
        log(f"sq8 enable_packed(mode='pq', pq_m={DEEP_PQ_M}): {nbytes} "
            f"bytes ({nbytes / 1e9:.2f} GB) in {time.time() - t0:.1f} s "
            f"(routing codebooks trained, {n} rows encoded and packed)")
        rec = {}
        for ef in (64, 128):
            res, secs = search(idx, queries, ef, True)
            rec[ef] = report(f"sq8 packed PQ rows ef={ef}", res, secs,
                             gt_hat, truth=gt_true)
            exact_l2("sq8 packed PQ rows", queries, res[0], res[1],
                     stored_rows(idx))
        profiled(idx, queries, "sq8 packed PQ rows")
        return rec

    out["sq8_pq_rows"] = phase("sq8 PQ rows", ("beam_update",
                                               "gathered_vec_dist"),
                               totals, sq8_pq_rows,
                               need_tags=(("gathered_vec_dist", "uint8"),))
    log(f"sq8 tables: vectors {idx.vectors.numel()} bytes, adjacency "
        f"{idx.graph.neighbors0.numel() * 4} bytes, PQ routing rows "
        f"{idx._packed.nbytes} bytes; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del idx, wl, queries
    torch.cuda.empty_cache()

    # ---- g. bf16 storage, SIFT-shaped at 300k
    n = SMALL_CODEC_N
    wl = synthetic_workload(n, 128, n_queries=N_QUERIES, seed=1234)
    queries = torch.from_numpy(wl.queries).to(dev)
    torch.cuda.reset_peak_memory_stats()
    idx = HnswIndex(128, 32, "l2", capacity=n, ef_construction=100,
                    dtype="bfloat16", device=dev)
    k3_build = {}
    out["bf16_build_s"] = phase(
        "bf16 build", ("gathered_vec_dist",), totals,
        lambda: capture_build_k3(lambda: build_codec(
            idx, wl.base, wl.base, "bf16"), k3_build),
        need_tags=(("gathered_vec_dist", "bfloat16"),))
    measure_build_k3(k3_build)
    del k3_build

    def bf16_phase():
        hat, _, truth = oracles(idx, queries, wl.base, n, dev)
        res, secs = search(idx, queries, 64)
        r = report("bf16 unpacked ef=64", res, secs, hat, truth=truth)
        exact_l2("bf16 unpacked", queries, res[0], res[1], stored_rows(idx))
        if r < 0.95:
            raise AssertionError(f"bf16 recall@10 against its oracle "
                                 f"{r:.4f} < 0.95")
        return r

    out["bf16"] = phase("bf16 search", ("beam_update", "gathered_vec_dist"),
                        totals, bf16_phase,
                        need_tags=(("gathered_vec_dist", "bfloat16"),))
    log(f"bf16 peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del idx, wl, queries
    torch.cuda.empty_cache()

    # ---- h. PQ storage, Deep-shaped at 300k
    wl = synthetic_workload(n, DEEP_D, n_queries=N_QUERIES, seed=1234)
    queries = torch.from_numpy(wl.queries).to(dev)
    torch.cuda.reset_peak_memory_stats()
    idx = HnswIndex(DEEP_D, 32, "l2", capacity=n, ef_construction=100,
                    dtype="pq", pq_m=DEEP_PQ_M, device=dev)

    def pq_phase():
        build_codec(idx, wl.base, wl.base, "pq")
        distinct = torch.unique(idx.vectors[:n], dim=0).shape[0]
        log(f"pq codes: {distinct} distinct of {n} (duplicate x̂ points)")
        hat, hat_d, truth = oracles(idx, queries, wl.base, n, dev)
        rec = {}
        for ef in (64, 128, 256):
            res, secs = search(idx, queries, ef)
            report(f"pq unpacked ef={ef}", res, secs, hat, truth=truth)
            exact_l2(f"pq unpacked ef={ef}", queries, res[0], res[1],
                     stored_rows(idx))
            rec[ef] = recall_ties(res[0], res[1], hat_d)
            by_id, untied = recall_untied(res[1], hat, hat_d)
            log(f"  recall@10 against the ADC oracle, distances within its "
                f"10th (ann-benchmarks' count): {rec[ef]:.4f}; by id over "
                f"the {untied} queries with no tie at the 10th: {by_id:.4f}")
            if ef == 64:
                first = res
        if max(rec.values()) < 0.95:
            raise AssertionError(f"pq recall@10 against the ADC oracle "
                                 f"{max(rec.values()):.4f} < 0.95")
        nbytes = idx.enable_packed()
        res, secs = search(idx, queries, 64, True)
        report(f"pq packed (stored codes, {nbytes} bytes) ef=64", res, secs,
               hat, truth=truth)
        rec["packed64"] = recall_ties(res[0], res[1], hat_d)
        log(f"  recall@10 against the ADC oracle, distances within its 10th: "
            f"{rec['packed64']:.4f}")
        t0 = time.time()
        blob = idx.to_bytes()
        back = HnswIndex.from_bytes(blob, device=dev)
        d2, i2, _ = back.search(queries, 10, ef_search=64, with_stats=True,
                                device_out=True)
        same = torch.equal(i2, first[1]) and torch.equal(d2, first[0])
        log(f"pq to_bytes -> from_bytes: {len(blob)} bytes in "
            f"{time.time() - t0:.1f} s, search ids and distances identical: "
            f"{same}")
        if not same:
            raise AssertionError("pq search differs after to_bytes / "
                                 "from_bytes")
        return rec

    out["pq"] = phase("pq", ("beam_update",), totals, pq_phase)
    log(f"pq peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=NORTH_STAR_N,
                    help="base vectors of the main-path run")
    ap.add_argument("--profile", action="store_true",
                    help="also profile packed ef=64 search, bytes and words "
                         "rows (adds their runs to the launch counts)")
    args = ap.parse_args()
    if args.n < PACKED_ROWS:  # smaller tables keep row offsets below 2^31
        raise SystemExit(f"chip_smoke: --n {args.n} is below {PACKED_ROWS}")

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    import hnsw_tpu_torch  # noqa: F401  (sets exact-f32 matmul precision)
    import hnsw_tpu_torch.search  # noqa: F401  (registers every kernel)
    from hnsw_tpu_torch.ops import _cuda

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda:0")

    t0 = time.time()
    lib = _cuda.build_library()
    _cuda.library()
    log(f"kernels built: {lib.name} in {time.time() - t0:.1f} s")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    log("kernel vs plain PyTorch, on the card:")
    measured = {"gathered_vec_dist": check_vec_dist(dev, gen),
                "packed_row_dist": check_packed_dist(dev, gen),
                "packed_row_dist_words": check_words_dist(dev, gen),
                "fused_gather_distances": check_gather_dist(dev, gen),
                "beam_update": check_beam_update(dev, gen)}
    for name, m in measured.items():
        log(f"  {name}: kernel {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} "
            f"ms, bound {m['bound_ms']:.4f} ms by {m['bound_by']} "
            f"({m['bytes'] / 1e6:.1f} MB)")
    torch.cuda.empty_cache()

    if args.n < NORTH_STAR_N:
        log(f"main path cut: n={args.n} of {NORTH_STAR_N}")
    totals: dict = {}
    main_path(args.n, dev, totals, args.profile)
    torch.cuda.empty_cache()       # the f32 index and its tables are gone
    log("K3 at the storage codecs' rows, and ADC, on the card:")
    codec_k3 = check_vec_dist_codecs(dev, gen)
    for tag, m in codec_k3.items():
        log(f"  gathered_vec_dist {tag} d={m['d']}: kernel {m['ms']:.4f} ms, "
            f"plain {m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms by "
            f"{m['bound_by']} ({m['bytes'] / 1e6:.1f} MB)")
    torch.cuda.empty_cache()
    codec_path(dev, totals, args.profile)
    by_tag = totals.pop("by_tag")
    log(f"kernel launches over the main path's phases: {totals}; K3 by row "
        f"dtype {by_tag}")
    missing = [k for k in KERNELS if totals.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    def row(name, m, launches, label=None):
        return {"name": label or name, "route": "cuda",
                "source": KERNELS[name][0], "replaces": KERNELS[name][1],
                "launches": launches, "max_abs_err": m["max_abs_err"],
                "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                "library_ms": None}

    k3 = "gathered_vec_dist"
    rows = [row(name, m, by_tag.get((k3, "float32"), 0) if name == k3
                else totals[name]) for name, m in measured.items()]
    rows += [row(k3, m, by_tag.get((k3, tag), 0),
                 f"{k3} ({tag} rows{' + dequant' if tag == 'uint8' else ''}"
                 f", d={m['d']})") for tag, m in codec_k3.items()]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
