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
     d=96 rows (timed there too), K5 also on bf16 rows (timed at 2-byte
     rows) and at the descent's K=32 and the entry rescore's K=5 (timed
     too), and Q=8191 for K2's and K4's persistent grid; K2 must equal
     ``nbr_sq[cur] - 2 * K4 dots`` on the same bits exactly (one engine);
     time both with CUDA events and compute each kernel's bound from its
     inputs;
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
       b2. the same index and table under ``HNSW_TPU_BEAM_KERNEL=0``
          (restored after): packed ef=64 takes the legacy beam, so K1
          must launch 0 times and K2 and K3 more than 0; its recall is
          printed beside b's;
       c. ``enable_packed(bits=8, layout="words")`` after
          ``disable_packed()``; its table must equal the bytes table bit
          for bit; the same packed searches (K1, K4, K3). Requires recall
          >= 0.95 at the best ef and within 0.005 of bytes at each ef;
       d. ``HNSW_TPU_PALLAS_HOP=1`` for this phase only: unpacked ef=64
          (K5; its calls printed by K). Requires recall within 0.01 of the
          fused unpacked search;
       e. the legacy beam at ef=64: n_expand=2 on the words rows (K4 with
          two expansions), ``visited_mode="bitmap"`` unpacked, and a
          filtered search with the even ids allowed. Prints recall, qps,
          hops and ndis; requires the filtered result to hold only
          allowed ids, no id twice in a row, and exact squared L2;
       i. the mutable index, on the same index after e (K1, K2, K3):
          ``enable_packed(bits=8)`` anew, whose table must hold the
          chunk-aligned 1,048,576 rows, and a packed ef=64 search;
          ``grow(n + 4096)``, after which the same search returns identical
          ids and distances; ``add`` of 2,048 points drawn (seed 4321)
          around the workload's own 250 centres, whose table refresh must
          take the incremental branch (rows and seconds printed) and keep
          the quantization, rows [0, n + 2048) equal to a re-pack of the
          adjacency, packed ef=64 recall against a new oracle within 0.01
          of b's, self-queries of the new points first >= 99%, and
          ``tune_operating_point`` on 1,024 queries (target 0.95; ef, hops
          and recall printed); ``remove_ids`` of 2,048 ids (seed 7): the
          filtered packed ef=64 search returns none of them, and its recall
          against the survivors' oracle is within 0.01 of the same filtered
          engine's before the removal with every id allowed (that engine
          re-ranks only its k-slot result buffer, as the reference's does)
          and no more than 0.05 below the fused search's after the add;
          ``vacuum()`` (seconds and rows patched printed): ``check()``
          clean with no link to a dead id, dead rows cleared, a live entry
          point, the tables dropped; then
          packed and unpacked ef=64 with no dead id and recall no more
          than 0.02 below the filtered search's; ``range_search`` of 256
          queries at the median 10th distance, every pair within the radius
          in exact squared L2, the share of ``FlatIndex.range_search``'s
          live pairs (on the host) printed; ``Searcher`` (k=10, ef=64,
          max_bucket 8,192): requests of 1, 77, 1,000 and 10,000 rows equal
          to ``HnswIndex.search`` row for row, then 64 ``submit`` calls of
          1-128 rows and one ``flush``, equal to direct search, with its
          launches, padded rows and qps against 64 direct searches;
       j. cut to 100,000 f32 points (the first of the base; M=32,
          efConstruction=100), the main index freed first: ``remove_ids``
          of 1,000 and ``compacted()`` (the ``old_ids`` mapping,
          ``check()``, recall@10 ef=64 >= 0.95 against the survivors);
          ``merge_from`` a 20,000-point index carrying 100 tombstones; a
          ``to_bytes`` -> ``from_bytes`` round trip with tombstones whose
          search is identical. Both rebuilds are plain ``add()``, which a
          measures at full scale.

  5. K3 at the storage codecs' rows, held against its plain version, timed
     and bounded at Q=8192, K=64: uint8 + dequant at d=96 and bf16 at
     d=128; and the ADC forms (decode + contract; LUT + gather; gather
     from a table made before, the hops' form) timed and compared at the
     same shape. The f32 index is freed first;
  6. the storage codecs, each phase again with the launch counts set to 0
     just before it and read just after, K3's and K5's launches also by
     row dtype:
       f. sq8 storage, Deep10M-shaped (``synthetic_workload(1_000_000, 96,
          n_queries=8192, seed=1234)``, M=32, efConstruction=100), built
          through ``RefineFlatIndex(k_factor=4)``, whose ``add`` also fills
          the f32 store phase k reranks on:
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
          search, recall against the bf16 x̂ oracle >= 0.95; then the same
          search under ``HNSW_TPU_PALLAS_HOP=1`` (K5 on bf16 rows), recall
          within 0.003 of K3's, and a 1,024-query search that must not grow
          the device memory by an f32 copy of the table;
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

  7. phase k, the host builder and the faiss wrappers: one phase with the
     launch counts set to 0 before it and read after (K1, K2 and K3 must
     launch):
       k1. ``build="host"`` on the first 3,000 points of the north-star
           workload (cut: the host builder is serial numpy), ``check()``,
           the device arrays equal to the host builder's; packed 8-bit
           ef=64 recall@10 against ``brute_force_topk`` >= 0.95, and a
           device build of the same points no more than 0.03 below it;
       k2. phase f's sq8 index and its refine: unpacked k=10 at ef 64 and
           128, inner and refined (k_factor 4, K3 at K=40), recall against
           the f32 truth and synced walls; refined >= inner at each ef and
           >= 0.95 at ef=128, its distances exact f32 squared L2;
       k3. ``index_factory(128, "IDMap,PCA64,HNSW32,Flat")`` on the first
           300,000 points (cut as phase g): PCA trained on 65,536,
           ``add_with_ids`` of distinct seeded int64 ids, packed 8-bit
           ef=64; every result id a user id, equal to ``ids[inner row]``;
           recall >= 0.95 against the oracle in the PCA space (against the
           128-d truth printed); ``save`` / ``load`` through a temporary
           directory, the search identical;
       k4. ``index_factory(96, "OPQ12,HNSW32,PQ12,RFlat")`` on phase h's
           data: OPQ and PQ trained on 65,536 (seconds printed), inner and
           refined at ef 64 and 128 against the f32 truth, beside phase
           h's; refined >= inner at each ef.
     Then K3 at the refine's own ids, held against its plain version and
     timed against its bound at k2's shape (Q=8192, K=40, d=96).

  8. phase l, sharded mode, every earlier index freed: the north-star
     workload (1,000,000 x 128, 8,192 queries) as ``ShardedHnswIndex(128,
     32, "l2", mesh=make_mesh(4, devices=[card] * 4),
     capacity_per_shard=250_000, ef_construction=100)``, four shards on
     the one card, driven one after another; each sub-phase with the
     launch counts set to 0 before it and read after:
       l1. the build (K3), timed, ``check()`` clean on every shard; then
           K3 at each K the shards' insert batches gave it (Q=1,024 a
           batch), on the last widest call's own ids, held against its
           plain version and timed against its bound;
       l2. fan-out searches, k=10, recall@10 against ``brute_force_topk``
           on the card beside phase b's and c's unsharded recall at the
           same ef, synced walls (best of 2) and qps: unpacked ef=64,
           packed bytes ef 32 / 64 / 128, packed words ef=64 (ids and
           distances equal to bytes'); the merge of the per-shard results
           timed alone on the card (K1, K2, K3, K4). Requires recall
           >= 0.95 at the best packed ef;
       l3. ``health_check`` all ok; ``mark_shard_failed(1)``: no id = 1
           (mod 4) returned; after ``mark_shard_ok(1)`` the results equal
           the healthy ones;
       l4. ``remove_ids`` of 2,048 ids (seed 7): the filtered search
           returns none of them; ``vacuum()``, timed, ``check()`` clean
           with no link to a dead id, the tables dropped; the unpacked
           search returns no dead id (recall against the survivors);
       l5. cut to 100,000 points (4 x 25,000; a save of the 1M shards is
           ~0.8 GB of compressed npz, which the time limit does not
           hold): an add of two halves against a save after the first,
           a load and the second add, equal array for array; ``save``,
           shard 2's vectors set to NaN, ``health_check`` failing exactly
           shard 2, ``restore_shards``, the search identical to before.

  9. phase m, sharded mode across processes on the one card (NCCL puts no
     two ranks on one device, so the ranks use gloo): l5's uninterrupted
     100,000-point index searched first in one process (m1: unpacked
     ef=64, packed bytes ef 32 / 64, shard 1 failed at ef=64); then two
     ranks of this script (``--rank R --world 2 --port P``; 127.0.0.1),
     each owning 2 of the 4 shards on the card, make the same calls (two
     adds of half the cut, the same searches). Each rank's shards must
     equal the one-process index's array for array, its ids at every
     search equal and its distances within K3's tolerance (rtol 1e-5 +
     atol 1e-3); with shard 1 failed no id = 1 (mod 4); each rank must
     launch K1, K2 and K3, and its counts join the ``kernels`` line.
     Prints each rank's build seconds, walls per search, and the
     all_gather plus merge ms. A rank that fails or outlasts 300 s fails
     the script.
 10. phase n, ``native.cpu_baseline.CpuHnsw`` (the serial C++ baseline, on
     one host core) beside the device build on ``synthetic_workload(
     20_000, 128, n_queries=1000, seed=1234)`` (M=32, efC=100): recall@10
     of each at ef 16 / 32 / 64 against ``brute_force_topk``; the device
     build within 0.03 of ``CpuHnsw`` at each ef (tests/test_parity.py's
     bar); ``CpuHnsw``'s build seconds and single-core qps printed with
     the host CPU's model and the card's name and power limit.

``--n N`` (N >= 300,000) cuts the f32 main path's base to N vectors (the
cut is printed); with no arguments it runs the full 1,000,000. The codec
phases always run at the sizes above. ``--profile`` adds one
``torch.profiler`` window of ef=64 search on bytes and on words rows,
unpacked under ``HNSW_TPU_PALLAS_HOP=1`` (with K5's device time, read
from profiler ranges around its calls), and on sq8 storage unpacked and
with PQ-coded rows (2 warm-ups, 10 unprofiled walls, one profiled call:
device busy, busy share, the top ops by device time); its searches count
as main-path launches.

The next-to-last lines are one JSON object with each kernel's launches
(summed over every phase of 4 and 6-10, phase m's ranks' included; K3 and
K5 by row dtype, one row each, K3 at the refine's shape with the refine's
own launches, and K3 at the shape that took the sharded build's most
kernel time, with all of the build's K3 launches), error, times and
bound, and the ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

NORTH_STAR_N = 1_000_000
N_QUERIES, HOP_K = 8192, 64      # the main path's query batch and m0
PACKED_ROWS = 300_000            # 8 KB rows: offsets cross 2^31 bytes
SQ8_N = 1_000_000                # phase f: Deep10M cut to 1M (build time)
SMALL_CODEC_N = 300_000          # phases g and h
COMPACT_N = 100_000              # phase j: compacted() and merge_from rebuild
HOST_N = 3000                    # phase k1: the serial numpy host builder
WRAP_N = 300_000                 # phase k3: IDMap over PCA
MERGE_N = 20_000                 # phase j: the index merged in
ADD_N = DEAD_N = 2048            # phase i: one insert batch; ids removed
SHARDS, SHARD_CAP = 4, 250_000  # phase l: the 1M as 4 shards of 250k
SHARD_CUT_N = 100_000           # phase l5: checkpoint, restore, resume
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
    a query (cur [Q/2, 2]); timed and bounded at d = 128 and, under
    ``"d96"``, at the sq8 rows. Tolerance: rtol 1e-5 + atol 1e-2 (f32 sums
    of up to 128 code * query terms, each up to ~500, in another order). No
    single PyTorch call reads code rows by id and contracts them: library_ms
    is null."""
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
            if bits == 8 and d in (128, DEEP_D) and metric == "l2":
                m = out if d == 128 else out.setdefault("d96", {})
                m["max_abs_err"] = err
                rows_read = torch.unique(cur).numel()
                m.update(bound(rows_read * (k * db + k * 4) + q * 4
                               + q * d * 4 + q * k * 4, q * k * d * 2))
                m["ms"] = time_ms(lambda: dk.packed_row_dist_ids(
                    codes, nbr_sq, cur, qs, bits=8, metric="l2"))
                m["plain_ms"] = time_ms(lambda: dk.packed_row_dist_plain(
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


def gather_ids(q: int, k: int, n: int, gen, dev) -> torch.Tensor:
    """K5's ids: uniform over n rows, ~1% negative and ~1% past the end
    (the kernel clamps both)."""
    ids = torch.randint(0, n, (q, k), generator=gen, device=dev,
                        dtype=torch.int32)
    r = torch.rand((q, k), generator=gen, device=dev)
    ids = torch.where(r < 0.01, -1 - ids % 7, ids)
    return torch.where(r > 0.99, n + ids % 7, ids)


def check_gather_dist(dev, gen) -> dict:
    """K5 at the hop's shape (Q=8192, K=64) over 1M rows, d in {128, 100},
    on f32 rows and on the same values as bf16 rows, L2 and IP, with
    ``gather_ids``' ids. Tolerance: rtol 1e-5 + atol 1e-3, K3's: f32 sums
    of d terms in another order. Timed and bounded at d=128 on f32 rows
    and, under ``"bfloat16"``, on bf16 rows (2-byte rows); also, under
    ``"shapes"``, at the greedy descent's K=32 and the entry rescore's K=5
    (4 seeds + the entry point at 1M) on both row types, held against the
    plain version there too. No single PyTorch call gathers rows by id and
    contracts them: library_ms is null."""
    from hnsw_tpu_torch.ops import hop_kernel as hk
    q, k, n = N_QUERIES, HOP_K, NORTH_STAR_N
    out = {}

    def measure(m, rows, ids, qs):
        m.update(gather_bound(ids.clamp(0, n - 1), rows.shape[1], ip=False,
                              row_elem=rows.element_size()))
        m["ms"] = time_ms(lambda: hk.fused_gather_distances(
            rows, ids, qs, "l2"))
        m["plain_ms"] = time_ms(lambda: hk.fused_gather_distances_plain(
            rows, ids, qs, "l2"))

    for d in (128, 100):
        table = torch.randn((n, d), generator=gen, device=dev)
        qs = torch.randn((q, d), generator=gen, device=dev)
        ids = gather_ids(q, k, n, gen, dev)
        for rows in (table, table.to(torch.bfloat16)):
            tag = str(rows.dtype).removeprefix("torch.")
            for metric in ("l2", "ip"):
                got = hk.fused_gather_distances(rows, ids, qs, metric)
                want = hk.fused_gather_distances_plain(rows, ids, qs, metric)
                err = compare(f"fused_gather_distances {tag} d={d} {metric}",
                              got, want, rtol=1e-5, atol=1e-3)
                if d == 128 and metric == "l2":
                    m = out if tag == "float32" else out.setdefault(tag, {})
                    m["max_abs_err"] = err
                    measure(m, rows, ids, qs)
            if d == 128:
                for kk, shape in ((32, "descent"), (5, "entry")):
                    ids_k = gather_ids(q, kk, n, gen, dev)
                    m = out.setdefault("shapes", {})[
                        f"{tag} rows, {shape} Q={q} K={kk}"] = {}
                    m["max_abs_err"] = compare(
                        f"fused_gather_distances {tag} d={d} K={kk} l2",
                        hk.fused_gather_distances(rows, ids_k, qs, "l2"),
                        hk.fused_gather_distances_plain(rows, ids_k, qs,
                                                        "l2"),
                        rtol=1e-5, atol=1e-3)
                    measure(m, rows, ids_k, qs)
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


def profile_window(tag: str, fn, top: int = 8, span: str | None = None
                   ) -> None:
    """Where the time of ``fn`` (one search) goes: 2 warm-ups, 10 synced
    walls without the profiler, then one call under ``torch.profiler``.
    Device busy = the union of that window's CUDA events; busy share = busy
    / median unprofiled wall. Prints the ``top`` ops by device time and,
    with ``span``, the device time of the profiler ranges of that name
    (``k5_calls``: one kernel each)."""
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
    if span is not None:
        # the range appears twice: on the host (no device time) and as its
        # annotation on the device's timeline, which spans its kernels
        hits = [e for e in prof.key_averages() if e.key == span]
        us = sum(dev_us(e) for e in hits)
        log(f"  {span} (its ranges on the device): {us / 1e3:.3f} ms device "
            f"({us / 1e3 / busy:.1%} of busy), "
            f"{max((e.count for e in hits), default=0)} calls")


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


@contextlib.contextmanager
def k3_calls(module, rec: dict, key):
    """``module``'s K3 entry point (``gathered_vec_dist_ids``) wrapped for
    the block: each call's launches read from K3's own counter, just before
    and just after it (where CUDA is available, a call with work that did
    not launch K3 exactly once raises; a rehearsal on the CPU expects none),
    added to ``rec[key(ids)]["launches"]``, and each key's last
    call at its widest Q kept as ``"args"`` (table, ids, qs, dequant,
    metric), which ``measure_build_k3`` / ``measure_refine_k3`` hold and
    time. As a decorator it wraps one function's run."""
    from hnsw_tpu_torch.ops import _cuda
    orig = module.gathered_vec_dist_ids
    on_card = torch.cuda.is_available()

    def recording(table, ids, qs, dequant=None, *, metric):
        before = _cuda.launch_counts()["gathered_vec_dist"]
        out = orig(table, ids, qs, dequant, metric=metric)
        launched = _cuda.launch_counts()["gathered_vec_dist"] - before
        if launched != int(on_card and ids.numel() > 0):
            raise AssertionError(f"{module.__name__}: a K3 call at ids "
                                 f"{tuple(ids.shape)} on {ids.device} "
                                 f"launched K3 {launched} times")
        r = rec.setdefault(key(ids), {"launches": 0, "args": None})
        r["launches"] += launched
        if r["args"] is None or ids.shape[0] >= r["args"][1].shape[0]:
            r["args"] = (table, ids, qs, dequant, metric)
        return out

    module.gathered_vec_dist_ids = recording
    try:
        yield
    finally:
        module.gathered_vec_dist_ids = orig


def build_k3_calls(k3_build: dict):
    """K3's calls from the search module (the build's), keyed by K
    (candidates a query); the widest call of each K is a late insert
    batch, at ~n points."""
    import hnsw_tpu_torch.search as search
    return k3_calls(search, k3_build, lambda ids: ids.shape[1])


K5_SPAN = "K5 fused_gather_distances"


@contextlib.contextmanager
def k5_calls(by_k: dict, span: bool = False):
    """K5's entry point in search.py wrapped for the block: its calls
    counted by K (candidates a query) into ``by_k``, and with ``span`` each
    call run inside a profiler range named ``K5_SPAN`` (which
    ``profile_window`` reads: the profiler names K3's and K5's kernels
    alike, since both run the row engines of csrc/vec_dist.cuh)."""
    import hnsw_tpu_torch.search as search
    orig = search.fused_gather_distances

    def wrapped(vectors, ids, queries, metric="l2"):
        by_k[ids.shape[1]] = by_k.get(ids.shape[1], 0) + 1
        if not span:
            return orig(vectors, ids, queries, metric=metric)
        with torch.profiler.record_function(K5_SPAN):
            return orig(vectors, ids, queries, metric=metric)

    search.fused_gather_distances = wrapped
    try:
        yield
    finally:
        search.fused_gather_distances = orig


def measure_build_k3(k3_build: dict) -> dict:
    """K3 at the build's shapes (PERF.md's build row): per K, its launches
    in the build, and on the last call's own ids the kernel held against
    its plain version (check_vec_dist's tolerance), the kernel and plain
    times and the bound (each distinct row once). Ids the caller masked
    read row 0; their share is printed. Returns each K's numbers (the
    bound's keys, max_abs_err, ms, plain_ms, launches, shape)."""
    from hnsw_tpu_torch.ops import dist_kernel as dk
    out = {}
    for k in sorted(k3_build):
        rec = k3_build[k]
        table, ids, qs, deq, metric = rec["args"]
        rows_of = str(table.dtype).removeprefix("torch.")
        err = compare(f"gathered_vec_dist ({rows_of} rows) at the build's "
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
        out[k] = dict(b, max_abs_err=err, ms=ms, plain_ms=plain,
                      launches=rec["launches"],
                      shape=f"Q={ids.shape[0]} K={k} d={table.shape[1]}")
    return out


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
                    build_k3_calls(k3_build)(build))
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

    def kill_switch_phase():
        from hnsw_tpu_torch.ops import _cuda
        before = os.environ.get("HNSW_TPU_BEAM_KERNEL")
        os.environ["HNSW_TPU_BEAM_KERNEL"] = "0"
        try:
            r, (d, i, _) = run(64, True, "packed bytes HNSW_TPU_BEAM_KERNEL=0")
        finally:
            if before is None:
                del os.environ["HNSW_TPU_BEAM_KERNEL"]
            else:
                os.environ["HNSW_TPU_BEAM_KERNEL"] = before
        torch.cuda.synchronize()
        k1 = _cuda.launch_counts()["beam_update"]
        if k1:
            raise AssertionError(f"HNSW_TPU_BEAM_KERNEL=0 launched K1 {k1} "
                                 f"times: the fused beam ran")
        check_exact("HNSW_TPU_BEAM_KERNEL=0", d[:, :1], i[:, :1])
        log(f"  the legacy beam (bf16 keys) beside the fused beam at ef=64: "
            f"{r:.4f} vs {recalls[64]:.4f}")
        return r

    phase("kill switch HNSW_TPU_BEAM_KERNEL=0", ("packed_row_dist",
                                                  "gathered_vec_dist"),
          totals, kill_switch_phase)

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
        by_k: dict = {}
        try:
            with k5_calls(by_k):
                r, (d, i, _) = run(64, False,
                                   "unpacked HNSW_TPU_PALLAS_HOP=1")
            log(f"  K5 calls by K (candidates a query): {by_k}")
            if profile:
                with k5_calls({}, span=True):
                    profile_window(
                        "unpacked HNSW_TPU_PALLAS_HOP=1 ef=64",
                        lambda: idx.search(queries, 10, ef_search=64,
                                           use_packed=False,
                                           device_out=True), span=K5_SPAN)
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
    mutable = phase("mutable index", ("beam_update", "packed_row_dist",
                                      "gathered_vec_dist"), totals,
                    lambda: mutable_phase(idx, wl, queries, gt, recalls[64],
                                          dev))
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del idx
    torch.cuda.empty_cache()
    compact = phase("compact and merge", ("beam_update",
                                          "gathered_vec_dist"), totals,
                    lambda: compact_phase(wl, queries, dev))
    return {"build_s": build_s, "recall": recalls, "unpacked": unpacked,
            "words": words, "pallas": pallas, "legacy": legacy,
            "mutable": mutable, "compact": compact}


def live_oracle(queries, vectors, alive, n: int, k: int = 10):
    """Exact top-k over the live rows < n (brute_force_topk on the card):
    (squared L2 [Q, k], ids [Q, k] in the index's numbering)."""
    from hnsw_tpu_torch.ops.distances import brute_force_topk
    live = torch.nonzero(alive[:n]).flatten()
    d, i = brute_force_topk(queries, vectors[live], k)
    return d, live[i]


def no_dead(tag, ids, alive) -> None:
    ok = ids >= 0
    if not bool(alive[ids[ok].long()].all()):
        raise AssertionError(f"{tag}: a removed id came back")


def mutable_phase(idx, wl, queries, gt, recall64: float, dev) -> dict:
    """Phase i (module docstring) on the main index after phase e; ``gt``
    and ``recall64``: phase b's oracle ids and packed ef=64 recall."""
    from hnsw_tpu_torch import FlatIndex, Searcher
    from hnsw_tpu_torch.ops.packed import padded_rows, quantize_codes
    from hnsw_tpu_torch.search import compute_sqnorms, entry_sample_size
    from hnsw_tpu_torch.utils.recall import recall_at_k
    out = {}
    n = idx.ntotal

    def packed64(tag, gt, q=queries, **kw):
        res, secs = timed(lambda: idx.search(q, 10, ef_search=64,
                                             with_stats=True,
                                             device_out=True, **kw))
        return report(tag, res, secs, gt), res

    # 1. the bytes table, its chunk-aligned rows
    idx.disable_packed()
    idx.enable_packed(bits=8)
    rows = idx._packed.nbr_sq.shape[0]
    log(f"bytes table rows: {rows} for {n} ids")
    if rows != padded_rows(n, 1 << 16):
        raise AssertionError(f"table rows {rows} != "
                             f"{padded_rows(n, 1 << 16)}")
    _, (d0, i0, _) = packed64("packed ef=64 before grow", gt)

    # 2. grow: the same search, bit for bit
    sample = entry_sample_size(idx.config.capacity)
    idx.grow(n + 4096)
    if entry_sample_size(idx.config.capacity) != sample:
        raise AssertionError("grow changed the entry sample size")
    _, (d1, i1, _) = packed64("packed ef=64 after grow", gt)
    if not (torch.equal(i0, i1) and torch.equal(d0, d1)):
        raise AssertionError("grow changed the search")
    log(f"grow({n + 4096}): capacity {idx.config.capacity}, upper "
        f"{idx.config.upper_capacity}; search identical")

    # 3. one insert batch of 2,048 around the workload's own centres
    nc = wl.meta["n_clusters"]
    centres = np.random.default_rng(1234).normal(
        0.0, 1.0, size=(nc, 128)).astype(np.float32)
    rng = np.random.default_rng(4321)
    pts = centres[rng.integers(0, nc, size=ADD_N)] + rng.normal(
        0.0, 0.35, size=(ADD_N, 128)).astype(np.float32)
    off, sc = idx._packed.offset.clone(), idx._packed.scale.clone()
    refresh_s = []
    orig = idx._refresh_packed

    def timed_refresh(*a):
        t0 = time.time()
        orig(*a)
        torch.cuda.synchronize()
        refresh_s.append(time.time() - t0)

    idx._refresh_packed = timed_refresh
    t0 = time.time()
    idx.add(pts)
    torch.cuda.synchronize()
    add_s = time.time() - t0
    del idx._refresh_packed
    n2 = idx.ntotal
    rf = idx._last_refresh
    log(f"add of {ADD_N} at {n}: {add_s:.3f} s, of which the table refresh "
        f"{refresh_s[0]:.3f} s: branch {rf['branch']}, {rf['rows']} rows "
        f"re-packed")
    pk = idx._packed
    if rf["branch"] != "incremental" or not idx.packed_enabled:
        raise AssertionError(f"refresh took the {rf['branch']} branch")
    if not (torch.equal(pk.offset, off) and torch.equal(pk.scale, sc)):
        raise AssertionError("the refresh retrained the quantization")
    codes_all = quantize_codes(idx.vectors[:n2], off, sc, 8)
    xhat_sq = compute_sqnorms(codes_all, (off, sc))
    for r in range(0, n2, 1 << 16):
        safe = idx.graph.neighbors0[r:min(r + (1 << 16), n2)].clamp(
            min=0).long()
        if not torch.equal(pk.nbr_codes[r:r + len(safe)],
                           codes_all[safe].view(len(safe), -1)):
            raise AssertionError(f"packed rows from {r} differ from a "
                                 f"re-pack of the adjacency")
        if not torch.allclose(pk.nbr_sq[r:r + len(safe)], xhat_sq[safe],
                              rtol=1e-5, atol=1e-5):
            raise AssertionError(f"packed norms from {r} differ")
    del codes_all, xhat_sq
    log(f"rows [0, {n2}) equal a re-pack under the retained quantization")
    _, gt2 = live_oracle(queries, idx.vectors, torch.ones(
        n2, dtype=torch.bool, device=dev), n2)
    r_add, _ = packed64(f"packed ef=64 after the add (oracle over {n2})",
                        gt2.cpu().numpy())
    if abs(r_add - recall64) > 0.01:
        raise AssertionError(f"recall after the add {r_add:.4f} vs phase "
                             f"b's {recall64:.4f} differ > 0.01")
    # the filtered engine (legacy beam, a k-slot result buffer re-ranked
    # alone, as the reference's) with every id allowed: what step 4's
    # tombstoned search is held against
    everyone = torch.ones(idx.config.capacity, dtype=torch.bool, device=dev)
    r_add_f, _ = packed64("packed ef=64 after the add, filtered engine "
                          "with every id allowed", gt2.cpu().numpy(),
                          allowed=everyone)
    _, own = idx.search(pts, 10, ef_search=64)
    self_hit = float((own[:, 0] == np.arange(n, n2)).mean())
    log(f"self-queries of the {ADD_N} new points: first {self_hit:.4f}")
    if self_hit < 0.99:
        raise AssertionError(f"self-query hit {self_hit:.4f} < 0.99")
    t0 = time.time()
    q1k = wl.queries[:1024]
    ef, hops = idx.tune_operating_point(q1k, 0.95, set_default=False)
    _, i_op = idx.search(q1k, 10, ef_search=ef, max_hops=hops)
    r_op = recall_at_k(i_op, gt2[:1024].cpu().numpy(), 10)
    log(f"tune_operating_point(1024 queries, 0.95): ef {ef}, hops {hops}, "
        f"recall {r_op:.4f} ({time.time() - t0:.1f} s)")
    out.update(add_s=add_s, refresh_s=refresh_s[0], refresh=rf,
               recall_add=(r_add, r_add_f), self_hit=self_hit,
               op=(ef, hops, r_op))

    # 4. tombstones: a filtered packed search
    dead = np.random.default_rng(7).choice(n, DEAD_N, replace=False)
    idx.remove_ids(dead)
    alive = idx._alive
    d_live, gt_live = live_oracle(queries, idx.vectors, alive, n2)
    gt_live_np = gt_live.cpu().numpy()
    r_filt, (_, i_f, _) = packed64(f"packed ef=64 with {DEAD_N} "
                                   f"tombstones (filtered)", gt_live_np)
    no_dead("filtered search", i_f, alive)
    log(f"  tombstones cost {r_add_f - r_filt:+.4f} recall on the filtered "
        f"engine; the filtered engine {r_add - r_add_f:+.4f} against the "
        f"fused search")
    if abs(r_filt - r_add_f) > 0.01:
        raise AssertionError(f"filtered recall {r_filt:.4f} vs {r_add_f:.4f} "
                             f"with every id allowed differ > 0.01")
    # and tombstoned serving stays near normal (fused) serving: an H100
    # 80GB HBM3 at 700 W measured a gap of 0.038 (filtered engine alone)
    if r_filt < r_add - 0.05:
        raise AssertionError(f"filtered recall {r_filt:.4f} < the fused "
                             f"search's {r_add:.4f} - 0.05")

    # 5. vacuum
    t0 = time.time()
    idx.vacuum()
    torch.cuda.synchronize()
    vac_s = time.time() - t0
    log(f"vacuum of {DEAD_N} ids: {vac_s:.2f} s, rows patched "
        f"{idx._last_vacuum}")
    t0 = time.time()
    stats = idx.check()
    log(f"check after vacuum: {time.time() - t0:.1f} s, errors "
        f"{stats['errors']}, links_to_dead {stats['links_to_dead']}")
    dead_t = torch.from_numpy(dead).to(dev)
    if stats["errors"] or stats["links_to_dead"]:
        raise AssertionError("vacuumed graph fails check()")
    if not bool((idx.graph.neighbors0[dead_t] == -1).all()):
        raise AssertionError("dead rows not cleared")
    if not bool(alive[idx.graph.entry_point]) or idx.packed_enabled:
        raise AssertionError("dead entry point, or tables not dropped")
    idx.enable_packed(bits=8)
    r_vac, (_, i_v, _) = packed64("packed ef=64 after vacuum", gt_live_np)
    r_vac_u, (_, i_u, _) = packed64("unpacked ef=64 after vacuum",
                                    gt_live_np, use_packed=False)
    for tag, i in (("packed", i_v), ("unpacked", i_u)):
        no_dead(f"{tag} search after vacuum", i, alive)
    if min(r_vac, r_vac_u) < r_filt - 0.02:
        raise AssertionError(f"vacuumed recall {r_vac:.4f} / {r_vac_u:.4f} "
                             f"< filtered {r_filt:.4f} - 0.02")
    out.update(recall_filtered=r_filt, vacuum_s=vac_s,
               vacuum_rows=idx._last_vacuum, recall_vacuum=(r_vac, r_vac_u))

    # 6. range search at the median 10th distance of 256 queries
    q256 = wl.queries[:256]
    radius = float(d_live[:256, 9].median())
    lims, dr, ir = idx.range_search(q256, radius, ef_search=64)
    qi = torch.from_numpy(np.repeat(np.arange(256), np.diff(lims))).to(dev)
    x = idx.vectors[torch.from_numpy(ir).to(dev)]
    exact = ((queries[qi] - x) ** 2).sum(1)
    # the search's distance is ||x||² − 2 q·x + ||q||², (q − x)² here: the
    # two may part in the last bits, so the bound takes rtol 1e-5
    if not bool((exact < radius * (1 + 1e-5)).all()) or not torch.allclose(
            torch.from_numpy(dr).to(dev), exact, rtol=1e-4, atol=1e-3):
        raise AssertionError("range_search returned a pair out of range "
                             "or a distance that is not exact")
    t0 = time.time()
    flat = FlatIndex(128, "l2", device="cpu")
    flat.add(idx.reconstruct_n(0, n2))
    fl, _, fi = flat.range_search(q256, radius)
    del flat
    alive_np = alive[:n2].cpu().numpy()
    want = {(q, int(j)) for q in range(256)
            for j in fi[fl[q]:fl[q + 1]] if alive_np[j]}
    got = {(q, int(j)) for q in range(256) for j in ir[lims[q]:lims[q + 1]]}
    share = len(want & got) / max(len(want), 1)
    log(f"range_search(256 queries, radius {radius:.4f}): {len(ir)} pairs, "
        f"{share:.4f} of the exact {len(want)} (FlatIndex.range_search on "
        f"the host, {time.time() - t0:.1f} s)")
    out["range_share"] = share

    # 7. the Searcher front end over the packed index
    s = Searcher(idx, k=10, ef_search=64, max_bucket=8192)
    # the queries, then the new points: 10,240 rows at the full size
    pool = np.resize(np.concatenate([wl.queries, pts]), (10_240, 128))
    for size in (1, 77, 1000, 10000):
        _, i_s = s.search(pool[:size])
        _, i_d = idx.search(pool[:size], 10, ef_search=64)
        bad = int((i_s != i_d).any(1).sum())
        if bad:
            raise AssertionError(f"Searcher request of {size} rows: {bad} "
                                 f"rows differ from HnswIndex.search")
    sizes = np.random.default_rng(5).integers(1, 129, size=64)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    before = dict(s.stats)
    torch.cuda.synchronize()
    t0 = time.time()
    hs = [s.submit(pool[a:a + m]) for a, m in zip(starts, sizes)]
    s.flush()
    flush_s = time.time() - t0
    got = np.concatenate([s.result(h)[1] for h in hs])
    t0 = time.time()
    direct = [idx.search(pool[a:a + m], 10, ef_search=64)[1]
              for a, m in zip(starts, sizes)]
    direct_s = time.time() - t0
    if not np.array_equal(got, np.concatenate(direct)):
        raise AssertionError("coalesced results differ from direct search")
    rows_q = int(sizes.sum())
    log(f"Searcher: {rows_q} rows in 64 requests, one flush "
        f"{rows_q / flush_s:.0f} qps ({flush_s * 1e3:.1f} ms, launches "
        f"{s.stats['launches'] - before['launches']}, rows padded "
        f"{s.stats['rows_padded'] - before['rows_padded']}) against 64 "
        f"direct searches {rows_q / direct_s:.0f} qps ({direct_s * 1e3:.1f} "
        f"ms); totals {s.stats}")
    out.update(flush_qps=rows_q / flush_s, direct_qps=rows_q / direct_s)
    return out


def compact_phase(wl, queries, dev) -> dict:
    """Phase j (module docstring): compacted(), merge_from and a to_bytes
    round trip with tombstones, at the cut of 100,000 f32 points."""
    from hnsw_tpu_torch import HnswIndex
    from hnsw_tpu_torch.utils.recall import recall_at_k
    n = COMPACT_N
    log(f"phase j cut: {n} of the main path's base vectors")
    idx = HnswIndex(128, 32, "l2", capacity=n + MERGE_N, ef_construction=100,
                    device=dev)
    t0 = time.time()
    idx.add(wl.base[:n])
    torch.cuda.synchronize()
    log(f"build of {n}: {time.time() - t0:.1f} s")
    dead = np.random.default_rng(11).choice(n, 1000, replace=False)
    idx.remove_ids(dead)
    t0 = time.time()
    new, old_ids = idx.compacted(wl.base[:n])
    torch.cuda.synchronize()
    keep = np.setdiff1d(np.arange(n), dead)
    if new.ntotal != n - 1000 or not np.array_equal(old_ids, keep):
        raise AssertionError("compacted(): wrong old_ids mapping")
    stats = new.check()
    if stats["errors"]:
        raise AssertionError(f"compacted graph: {stats['errors']}")
    _, gt = live_oracle(queries, idx.vectors, idx._alive, n)
    _, i = new.search(queries, 10, ef_search=64)
    r_c = recall_at_k(np.where(i >= 0, old_ids[np.maximum(i, 0)], -1),
                      gt.cpu().numpy(), 10)
    log(f"compacted(): {new.ntotal} ids in {time.time() - t0:.1f} s, "
        f"recall@10 ef=64 {r_c:.4f} against the survivors")
    if r_c < 0.95:
        raise AssertionError(f"compacted recall {r_c:.4f} < 0.95")
    del idx
    other = HnswIndex(128, 32, "l2", capacity=MERGE_N, ef_construction=100,
                      device=dev)
    other.add(wl.base[n:n + MERGE_N])
    other.remove_ids(np.arange(0, MERGE_N, MERGE_N // 100))
    t0 = time.time()
    merged = new.merge_from(other)
    log(f"merge_from({MERGE_N} with 100 tombstones): {merged} in "
        f"{time.time() - t0:.1f} s, ntotal {new.ntotal}")
    if merged != MERGE_N - 100 or new.ntotal != n - 1000 + MERGE_N - 100:
        raise AssertionError("merge_from merged the wrong rows")
    new.remove_ids(np.arange(0, new.ntotal, 97))
    d1, i1 = new.search(queries, 10, ef_search=64)
    t0 = time.time()
    blob = new.to_bytes()
    back = HnswIndex.from_bytes(blob, device=dev)
    d2, i2 = back.search(queries, 10, ef_search=64)
    log(f"to_bytes / from_bytes with {back.n_deleted} tombstones: "
        f"{len(blob)} bytes, {time.time() - t0:.1f} s")
    if not (np.array_equal(i1, i2) and np.array_equal(d1, d2)):
        raise AssertionError("search differs after the round trip")
    if np.isin(i2[i2 >= 0], np.arange(0, new.ntotal, 97)).any():
        raise AssertionError("round trip lost the tombstones")
    return {"recall_compacted": r_c, "merged": merged}


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
    """Phases f, g and h (module docstring): sq8, bf16 and PQ storage.
    Phase f's index is built through ``RefineFlatIndex``, which phase k
    searches: it is returned (``out["sq8_refine"]``) with its queries and
    f32 truth."""
    from hnsw_tpu_torch import HnswIndex, RefineFlatIndex, synthetic_workload
    from hnsw_tpu_torch.utils.recall import recall_at_k
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
    # its add() also fills the refine's f32 store, which phase k reranks on
    refined = RefineFlatIndex(idx, k_factor=4.0)
    k3_build: dict = {}
    out["sq8_build_s"] = phase(
        "sq8 build", ("gathered_vec_dist",), totals,
        build_k3_calls(k3_build)(lambda: build_codec(
            refined, wl.base, wl.base[:262144], "sq8")),
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
    out["sq8_refine"] = (refined, queries, gt_true)
    del idx, refined, wl, queries
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
        build_k3_calls(k3_build)(lambda: build_codec(
            idx, wl.base, wl.base, "bf16")),
        need_tags=(("gathered_vec_dist", "bfloat16"),))
    measure_build_k3(k3_build)
    del k3_build

    hat, _, truth = oracles(idx, queries, wl.base, n, dev)

    def bf16_phase():
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

    def grown() -> int:
        """Device memory a 1,024-query ef=64 search grows by, at its peak."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        idx.search(queries[:1024], 10, ef_search=64, device_out=True)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - before

    def bf16_pallas():
        # K5 reads the bf16 rows: the search must not grow the device
        # memory by an f32 copy of the table (K3's search beside it)
        k3_grew = grown()
        os.environ["HNSW_TPU_PALLAS_HOP"] = "1"
        by_k: dict = {}
        try:
            with k5_calls(by_k):
                res, secs = search(idx, queries, 64)
            grew = grown()
        finally:
            del os.environ["HNSW_TPU_PALLAS_HOP"]
        log(f"  K5 calls by K (candidates a query), 2 searches: {by_k}")
        r = report("bf16 unpacked HNSW_TPU_PALLAS_HOP=1 ef=64", res, secs,
                   hat, truth=truth)
        exact_l2("bf16 pallas hop", queries, res[0], res[1],
                 stored_rows(idx))
        f32_copy = idx.vectors.numel() * 4
        log(f"  bf16 HNSW_TPU_PALLAS_HOP=1: device memory grew {grew} bytes "
            f"during a 1,024-query search ({k3_grew} without the flag; an "
            f"f32 copy of the table: {f32_copy} bytes)")
        if grew >= f32_copy:
            raise AssertionError("bf16 HNSW_TPU_PALLAS_HOP=1 search grew the "
                                 "device memory by an f32 table's bytes")
        if abs(r - out["bf16"]) > 0.003:
            raise AssertionError(f"bf16 HNSW_TPU_PALLAS_HOP=1 recall "
                                 f"{r:.4f} vs K3's {out['bf16']:.4f} differ "
                                 f"> 0.003")
        return r

    out["bf16_pallas"] = phase(
        "bf16 pallas hop", ("fused_gather_distances",), totals, bf16_pallas,
        need_tags=(("fused_gather_distances", "bfloat16"),))
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
            out["pq_truth"][ef] = recall_at_k(res[1].cpu().numpy(), truth,
                                              10)
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

    out["pq_truth"] = {}     # recall@10 against the f32 truth, for phase k
    out["pq"] = phase("pq", ("beam_update",), totals, pq_phase)
    log(f"pq peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return out


def refine_k3_calls(rec: dict, tag: str):
    """The refine's K3 calls (``models/refine.py``), kept under ``tag``."""
    import hnsw_tpu_torch.models.refine as refine
    return k3_calls(refine, rec, lambda ids: tag)


def measure_refine_k3(rec: dict) -> dict:
    """K3 at each refine's own shape (its last call's store, ids and
    queries): held against its plain version (check_vec_dist's tolerance);
    the first tag's call also timed against its bound (each distinct row
    once). Returns that tag's numbers for the ``kernels`` line, launches
    summed over every tag."""
    from hnsw_tpu_torch.ops import dist_kernel as dk
    out = None
    for tag, r in rec.items():
        table, ids, qs, _, metric = r["args"]
        shape = (f"Q={ids.shape[0]} K={ids.shape[1]} d={table.shape[1]} "
                 f"{metric}")
        err = compare(f"gathered_vec_dist at the refine's ids ({tag}, "
                      f"{shape})",
                      dk.gathered_vec_dist_ids(table, ids, qs, metric=metric),
                      dk.gathered_vec_dist_plain(table, ids, qs,
                                                 metric=metric),
                      rtol=1e-5, atol=1e-3)
        if out is not None:
            continue
        b = gather_bound(ids, table.shape[1], ip=metric == "ip")
        ms = time_ms(lambda: dk.gathered_vec_dist_ids(table, ids, qs,
                                                      metric=metric))
        plain = time_ms(lambda: dk.gathered_vec_dist_plain(table, ids, qs,
                                                           metric=metric))
        rows = torch.unique(ids).numel()
        log(f"K3 at the refine's shape ({tag}, {shape}, {table.shape[0]} "
            f"f32 rows): kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']} "
            f"({b['bytes'] / 1e6:.2f} MB, {rows} distinct rows), share of "
            f"bound {b['bound_ms'] / ms:.2f}")
        out = dict(b, max_abs_err=err, ms=ms, plain_ms=plain,
                   shape=shape)
    out["launches"] = sum(r["launches"] for r in rec.values())
    log(f"K3 launches by the refine's rerank in phase k: "
        f"{ {t: r['launches'] for t, r in rec.items()} }")
    return out


def check_pca_training(pca, x: np.ndarray) -> None:
    """k3's PCA trained on the card held to a float64 PCA of the same
    points in numpy: orthonormal rows, the variance they capture within
    1e-5 of the top ``d_out`` eigenvalues' sum (a swap of two close
    eigenvectors, or a flipped sign, costs nothing here; a wrong covariance
    does), and the bias ``-A·mean``."""
    x64 = x.astype(np.float64)
    mean = x64.mean(0)
    cov = (x64 - mean).T @ (x64 - mean) / len(x64)
    best = np.linalg.eigvalsh(cov)[::-1][: pca.d_out].sum()
    a = pca.a.astype(np.float64)
    captured = float(np.trace(a @ cov @ a.T))
    ortho = float(np.abs(a @ a.T - np.eye(pca.d_out)).max())
    bias = float(np.abs(pca.b - (-(a @ mean))).max())
    log(f"k3 PCA{pca.d_out} trained on the card against float64 numpy: "
        f"captured variance {captured:.6f} of the best {best:.6f} "
        f"({1 - captured / best:.2e} short), |A Aᵀ - I| {ortho:.2e}, "
        f"|b + A mean| {bias:.2e}")
    if abs(captured - best) > 1e-5 * best or ortho > 1e-4 or bias > 1e-3:
        raise AssertionError("k3: the PCA trained on the card is not the "
                             "float64 PCA of its data")


def check_opq_training(opq, x: np.ndarray, dev) -> None:
    """k4's OPQ trained on the card held to the same training on the CPU
    (the port's plain path, which tests/test_torch_wrappers.py holds to the
    reference) by the PQ reconstruction error of the rotated points:
    within 2% of it (the two alternate 16 times, with sums in another
    order), and below the error of the seeded rotation both start from
    (OPQ12 keeps d=96, so that rotation, not a PCA, is the start)."""
    from hnsw_tpu_torch.ops import transforms as T
    from hnsw_tpu_torch.ops.pq import decode_pq, encode_pq, train_pq
    t0 = time.time()
    cpu = T.OPQMatrix(opq.d_in, opq.m, opq.d_out, ksub=opq.ksub,
                      niter=opq.niter, pq_iters=opq.pq_iters,
                      max_points=opq.max_points, seed=opq.seed, device="cpu")
    cpu.train(x)
    cpu_s = time.time() - t0
    xt = torch.from_numpy(x).to(dev)

    def pq_err(a: np.ndarray) -> float:
        xr = torch.matmul(xt, torch.from_numpy(a).to(dev).T)
        cb = torch.from_numpy(train_pq(xr.cpu().numpy(), opq.m, iters=10,
                                       seed=0, device=dev)).to(dev)
        return float(((xr - decode_pq(encode_pq(xr, cb), cb)) ** 2).sum())

    start = T._random_rotation(opq.d_in, opq.d_out, opq.seed)
    e_card, e_cpu, e_start = pq_err(opq.a), pq_err(cpu.a), pq_err(start)
    ortho = float(np.abs(opq.a.astype(np.float64) @ opq.a.T
                         - np.eye(opq.d_out)).max())
    log(f"k4 OPQ{opq.m} trained on the card against the CPU ({cpu_s:.1f} "
        f"s): PQ{opq.m} reconstruction error {e_card:.1f} against the "
        f"CPU's {e_cpu:.1f} ({e_card / e_cpu - 1:+.4f}) and the starting "
        f"rotation's {e_start:.1f}; |A Aᵀ - I| {ortho:.2e}")
    if abs(e_card - e_cpu) > 0.02 * e_cpu or not e_card < e_start \
            or ortho > 1e-4:
        raise AssertionError("k4: the OPQ trained on the card is not the "
                             "CPU's, or does not beat its start")


def recall_of(ids, truth) -> float:
    from hnsw_tpu_torch.utils.recall import recall_at_k
    ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else ids
    return recall_at_k(ids, truth, 10)


def host_build_phase(wl, queries, dev) -> dict:
    """k1: ``build="host"`` on the first HOST_N points of the north-star
    workload against a device build of the same points."""
    from hnsw_tpu_torch import HnswIndex
    from hnsw_tpu_torch.ops.distances import brute_force_topk
    base = wl.base[:HOST_N]
    log(f"phase k1 cut: {HOST_N} of the north-star workload's "
        f"{len(wl.base)} points (the host builder is serial numpy)")
    _, gt = brute_force_topk(queries, torch.from_numpy(base).to(dev), 10)
    gt = gt.cpu().numpy()
    out = {}
    for mode in ("host", "device"):
        idx = HnswIndex(128, 32, "l2", capacity=HOST_N, ef_construction=100,
                        build=mode, device=dev)
        t0 = time.time()
        idx.add(base)
        torch.cuda.synchronize()
        secs = time.time() - t0
        stats = idx.check()
        log(f"k1 {mode} build of {HOST_N} x 128: {secs:.1f} s, errors "
            f"{stats['errors']}, deg0_mean {stats['deg0_mean']:.2f}")
        if stats["errors"]:
            raise AssertionError(f"k1 {mode} graph: {stats['errors']}")
        if mode == "host":
            hg = idx._host.to_graph_arrays()
            same = all(np.array_equal(v, hg[k])
                       for k, v in idx.graph.numpy().items())
            same &= torch.equal(idx.vectors.cpu(), torch.from_numpy(
                idx._host.vectors))
            log(f"k1 host: device arrays equal the host builder's: {same}")
            if not same:
                raise AssertionError("k1: the device graph is not the host "
                                     "builder's")
        idx.enable_packed(bits=8)
        res, s = timed(lambda: idx.search(queries, 10, ef_search=64,
                                          with_stats=True, device_out=True))
        out[mode] = report(f"k1 {mode}-built, packed ef=64", res, s, gt)
        out[f"{mode}_s"] = secs
    if out["host"] < 0.95 or out["device"] < out["host"] - 0.03:
        raise AssertionError(f"k1 recall: host {out['host']:.4f} (>= 0.95), "
                             f"device {out['device']:.4f} (>= host - 0.03)")
    return out


def refine_sq8_phase(sq8, k3_rec: dict) -> dict:
    """k2: phase f's sq8 index, inner and refined (k_factor 4), at ef 64
    and 128, recall against the f32 truth."""
    refined, queries, truth = sq8
    inner = refined.index
    out = {}
    for ef in (64, 128):
        res, s_in = timed(lambda: inner.search(
            queries, 10, ef_search=ef, use_packed=False, device_out=True))
        with refine_k3_calls(k3_rec, "k2 sq8"):
            (d, i), s_rf = timed(lambda: refined.search(
                queries, 10, ef_search=ef, use_packed=False))
        r_in, r_rf = recall_of(res[1], truth), recall_of(i, truth)
        log(f"k2 sq8 {inner.ntotal} x 96 ef={ef}: recall@10 against the "
            f"f32 truth "
            f"inner {r_in:.4f} ({s_in * 1e3:.1f} ms), refined k_factor 4 "
            f"{r_rf:.4f} ({s_rf * 1e3:.1f} ms, best of 2 synced walls)")
        if r_rf < r_in or (ef == 128 and r_rf < 0.95):
            raise AssertionError(f"k2 ef={ef}: refined {r_rf:.4f} vs inner "
                                 f"{r_in:.4f} (>= inner, >= 0.95 at 128)")
        ok = i >= 0
        rows = refined._materialize()[torch.from_numpy(i[ok]).to(
            queries.device)]
        exact = ((queries[torch.from_numpy(np.nonzero(ok)[0]).to(
            queries.device)] - rows) ** 2).sum(-1).cpu().numpy()
        if not np.allclose(d[ok], exact, rtol=1e-4, atol=1e-3):
            raise AssertionError("k2: refined distances are not exact f32 "
                                 "squared L2")
        out[ef] = (r_in, r_rf, s_in, s_rf)
    return out


def idmap_pca_phase(wl, queries, dev) -> dict:
    """k3: IDMap over PCA64 over HNSW32 on the first WRAP_N points."""
    from hnsw_tpu_torch import IdMapIndex, PreTransformIndex, index_factory
    from hnsw_tpu_torch.ops.distances import brute_force_topk
    base = wl.base[:WRAP_N]
    log(f"phase k3 cut: {WRAP_N} of the north-star workload's "
        f"{len(wl.base)} points")
    idx = index_factory(128, "IDMap,PCA64,HNSW32,Flat", capacity=WRAP_N,
                        ef_construction=100, device=dev)
    ids = 10 ** 12 + np.random.default_rng(99).permutation(WRAP_N) \
        .astype(np.int64) * 7
    t0 = time.time()
    idx.train(base[:65536])
    torch.cuda.synchronize()
    t1 = time.time()
    idx.add_with_ids(base, ids)
    torch.cuda.synchronize()
    t2 = time.time()
    nbytes = idx.index.index.enable_packed(bits=8)
    log(f"k3 IDMap,PCA64,HNSW32,Flat: PCA train {t1 - t0:.1f} s, add "
        f"{t2 - t1:.1f} s, packed {nbytes} bytes")
    check_pca_training(idx.index.transforms[0], base[:65536])
    qn = queries.cpu().numpy()
    (d, i), secs = timed(lambda: idx.search(qn, 10, ef_search=64))
    _, rows = idx.index.search(qn, 10, ef_search=64)
    if not (i >= 0).all() or not np.isin(i, ids).all() or \
            not np.array_equal(i, ids[rows]):
        raise AssertionError("k3: result ids are not the user ids of the "
                             "inner rows")
    pca = idx.index.transforms[0]
    base_dev = torch.from_numpy(base).to(dev)
    _, gt_pca = brute_force_topk(pca.apply(queries), pca.apply(base_dev), 10)
    _, gt_raw = brute_force_topk(queries, base_dev, 10)
    del base_dev
    r_pca = recall_of(i, ids[gt_pca.cpu().numpy()])
    r_raw = recall_of(i, ids[gt_raw.cpu().numpy()])
    log(f"k3 packed ef=64: recall@10 {r_pca:.4f} against the PCA-space "
        f"oracle, {r_raw:.4f} against the 128-d truth (what PCA64 loses); "
        f"{len(qn) / secs:.0f} qps ({secs * 1e3:.1f} ms)")
    if r_pca < 0.95:
        raise AssertionError(f"k3 recall in the PCA space {r_pca:.4f} < 0.95")
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        path = os.path.join(tmp, "idmap_pca.npz")
        idx.save(path)
        back = IdMapIndex.load(path, index_cls=PreTransformIndex, device=dev)
        back.index.index.enable_packed(bits=8)
        d2, i2 = back.search(qn, 10, ef_search=64)
        same = np.array_equal(i2, i) and np.array_equal(d2, d)
        log(f"k3 save / load ({time.time() - t0:.1f} s): search identical: "
            f"{same}")
        if not same:
            raise AssertionError("k3 search differs after save / load")
    return {"pca": r_pca, "raw": r_raw}


def opq_pipeline_phase(dev, pq_truth: dict, k3_rec: dict) -> dict:
    """k4: OPQ12,HNSW32,PQ12,RFlat on phase h's data."""
    from hnsw_tpu_torch import index_factory, synthetic_workload
    from hnsw_tpu_torch.ops.distances import brute_force_topk
    wl = synthetic_workload(SMALL_CODEC_N, DEEP_D, n_queries=N_QUERIES,
                            seed=1234)
    queries = torch.from_numpy(wl.queries).to(dev)
    pipe = index_factory(DEEP_D, f"OPQ{DEEP_PQ_M},HNSW32,PQ{DEEP_PQ_M},RFlat",
                         capacity=SMALL_CODEC_N, ef_construction=100,
                         device=dev)
    opq, refined = pipe.transforms[0], pipe.index
    t0 = time.time()
    opq.train(wl.base[:65536])
    torch.cuda.synchronize()
    t1 = time.time()
    pipe.train(wl.base[:65536])          # the PQ codebooks, rotated space
    torch.cuda.synchronize()
    t2 = time.time()
    pipe.add(wl.base)
    torch.cuda.synchronize()
    log(f"k4 OPQ{DEEP_PQ_M},HNSW32,PQ{DEEP_PQ_M},RFlat: OPQ train "
        f"{t1 - t0:.1f} s, PQ train {t2 - t1:.1f} s, add "
        f"{time.time() - t2:.1f} s")
    check_opq_training(opq, wl.base[:65536], dev)
    _, truth = brute_force_topk(queries, torch.from_numpy(wl.base).to(dev),
                                10)
    truth = truth.cpu().numpy()
    rotated = opq.apply(queries)
    out = {}
    for ef in (64, 128):
        res, s_in = timed(lambda: refined.index.search(
            rotated, 10, ef_search=ef, device_out=True))
        with refine_k3_calls(k3_rec, "k4 OPQ pipeline"):
            (_, i), s_rf = timed(lambda: pipe.search(queries, 10,
                                                     ef_search=ef))
        r_in, r_rf = recall_of(res[1], truth), recall_of(i, truth)
        log(f"k4 ef={ef}: recall@10 against the f32 truth inner (OPQ + "
            f"PQ12) {r_in:.4f} ({s_in * 1e3:.1f} ms), refined {r_rf:.4f} "
            f"({s_rf * 1e3:.1f} ms); phase h's PQ12 without OPQ "
            f"{pq_truth.get(ef, float('nan')):.4f}")
        if r_rf < r_in:
            raise AssertionError(f"k4 ef={ef}: refined {r_rf:.4f} < inner "
                                 f"{r_in:.4f}")
        out[ef] = (r_in, r_rf)
    return out


def wrappers_path(dev, totals: dict, sq8, pq_truth: dict) -> dict:
    """Phase k (module docstring): the host builder and the faiss wrappers,
    one phase with the launch counts set to 0 before it and read after."""
    from hnsw_tpu_torch import synthetic_workload
    t0 = time.time()
    wl = synthetic_workload(NORTH_STAR_N, 128, n_queries=N_QUERIES,
                            seed=1234)
    queries = torch.from_numpy(wl.queries).to(dev)
    log(f"phase k workload: the north-star {NORTH_STAR_N} x 128 "
        f"({time.time() - t0:.1f} s)")
    k3_rec: dict = {}

    def run():
        return {"k1": host_build_phase(wl, queries, dev),
                "k2": refine_sq8_phase(sq8, k3_rec),
                "k3": idmap_pca_phase(wl, queries, dev),
                "k4": opq_pipeline_phase(dev, pq_truth, k3_rec)}

    out = phase("k host builder and wrappers", ("beam_update",
                "packed_row_dist", "gathered_vec_dist"), totals, run)
    log(f"phase k: {time.time() - t0:.1f} s, its workload included")
    out["refine_k3"] = measure_refine_k3(k3_rec)
    return out


def sharded_path(dev, totals: dict, unsharded: dict) -> dict:
    """Phase l (module docstring): the north-star workload as four shards
    of 250,000 on the card, one sub-phase each for the build, the fan-out
    searches, the health checks, the tombstones and vacuum, and the
    checkpoint (cut to 100,000 points). ``unsharded``: main_path's
    recalls, printed beside the sharded ones."""
    import tempfile
    from hnsw_tpu_torch import ShardedHnswIndex, make_mesh, synthetic_workload
    from hnsw_tpu_torch.ops.distances import brute_force_topk
    from hnsw_tpu_torch.parallel.sharded import merge_topk
    from hnsw_tpu_torch.utils.recall import recall_at_k
    n = SHARDS * SHARD_CAP
    t0 = time.time()
    wl = synthetic_workload(n, 128, n_queries=N_QUERIES, seed=1234)
    log(f"phase l workload: {n} x 128 ({time.time() - t0:.1f} s); device "
        f"memory in use {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    mesh = make_mesh(SHARDS, devices=[dev] * SHARDS)
    idx = ShardedHnswIndex(128, 32, "l2", mesh=mesh,
                           capacity_per_shard=SHARD_CAP, ef_construction=100)
    out: dict = {}

    def check_clean(tag, index):
        for s, st in enumerate(index.check()):
            if st["errors"] or st.get("links_to_dead", 0):
                raise AssertionError(f"{tag} shard {s}: {st['errors']}, "
                                     f"{st.get('links_to_dead')} links to "
                                     f"dead ids")

    def build():
        t0 = time.time()
        idx.add(wl.base)
        torch.cuda.synchronize()
        secs = time.time() - t0
        t1 = time.time()
        stats = idx.check()
        for s, st in enumerate(stats):
            if st["errors"]:
                raise AssertionError(f"l1 shard {s}: {st['errors']}")
        log(f"l1 sharded build: {n} points, {SHARDS} shards of {SHARD_CAP} "
            f"(counts {idx._counts.tolist()}): {secs:.1f} s "
            f"({n / secs:.0f} inserts/s); check() clean on every shard "
            f"({time.time() - t1:.1f} s), deg0_mean "
            f"{[round(st['deg0_mean'], 2) for st in stats]}, max_level "
            f"{[st['max_level'] for st in stats]}")
        return secs

    k3_build: dict = {}
    out["build_s"] = phase("l1 sharded build", ("gathered_vec_dist",),
                           totals, build_k3_calls(k3_build)(build))
    by_k = measure_build_k3(k3_build)
    del k3_build
    # the kernels line's row: K3 at the K that took the most kernel time
    # (launches x ms) in the shards' insert batches, with every K3 launch
    # of the build
    out["build_k3"] = dict(
        max(by_k.values(), key=lambda m: m["launches"] * m["ms"]),
        launches=sum(m["launches"] for m in by_k.values()))
    queries = torch.from_numpy(wl.queries).to(dev)
    base = torch.from_numpy(wl.base).to(dev)
    _, gt_t = brute_force_topk(queries, base, 10)
    gt = gt_t.cpu().numpy()

    def run(ef, tag, unsharded_recall):
        (d, i), secs = timed(lambda: idx.search(wl.queries, 10, ef_search=ef))
        if i.shape != (N_QUERIES, 10) or not np.isfinite(d[i >= 0]).all():
            raise AssertionError(f"l sharded {tag}: search output malformed")
        r = recall_at_k(i, gt, 10)
        log(f"  sharded {tag} ef={ef}: recall@10 {r:.4f} (unsharded, phase "
            f"b-c: {unsharded_recall:.4f}), {N_QUERIES / secs:.0f} qps "
            f"(best of 2, {secs * 1e3:.1f} ms)")
        out[f"{tag} ef={ef}"] = {"recall": r, "ms": secs * 1e3}
        return d, i, r

    def merge_ms(ef):
        """The merge alone: per-shard results made once, then
        ``merge_topk`` timed on the card (CUDA events after a spin)."""
        parts = [idx._search_shard(s, wl.queries, 10, ef, None)
                 for s in range(SHARDS)]
        ms = time_ms(lambda: merge_topk([p[0] for p in parts],
                                        [p[1] for p in parts], 10))
        log(f"  merge of {SHARDS} x [{N_QUERIES}, 10] (cat, stable sort, "
            f"gather): {ms:.4f} ms on the card")
        return ms

    def searches():
        run(64, "unpacked", unsharded["unpacked"])
        t0 = time.time()
        nbytes = idx.enable_packed(bits=8)
        torch.cuda.synchronize()
        log(f"  enable_packed(bits=8): {nbytes} bytes over {SHARDS} shards "
            f"in {time.time() - t0:.1f} s")
        by_ef = {ef: run(ef, "packed bytes", unsharded["recall"][ef])
                 for ef in (32, 64, 128)}
        out["merge_ms"] = merge_ms(64)
        idx.disable_packed()
        idx.enable_packed(bits=8, layout="words")
        d, i, r = run(64, "packed words", unsharded["words"][64])
        if not (np.array_equal(i, by_ef[64][1])
                and np.array_equal(d, by_ef[64][0])):
            raise AssertionError("l2 words rows differ from bytes rows")
        best = max(v[2] for v in by_ef.values())
        if best < 0.95:
            raise AssertionError(f"l2 sharded packed recall@10 {best:.4f} "
                                 f"< 0.95")
        return d, i

    d64, i64 = phase("l2 sharded search", ("beam_update", "packed_row_dist",
                                           "packed_row_dist_words",
                                           "gathered_vec_dist"), totals,
                     searches)

    def health():
        t0 = time.time()
        report = idx.health_check()
        log(f"l3 health_check: {[r['ok'] for r in report]} "
            f"({time.time() - t0:.2f} s)")
        if not all(r["ok"] for r in report):
            raise AssertionError(f"l3 health_check: {report}")
        idx.mark_shard_failed(1)
        d, i, r = run(64, "packed words, shard 1 failed", float("nan"))
        if (i[i >= 0] % SHARDS == 1).any():
            raise AssertionError("l3 a failed shard's id came back")
        idx.mark_shard_ok(1)
        d, i = idx.search(wl.queries, 10, ef_search=64)
        if not (np.array_equal(i, i64) and np.array_equal(d, d64)):
            raise AssertionError("l3 results differ after mark_shard_ok")
        log("  after mark_shard_ok(1): results equal to the healthy ones")

    phase("l3 sharded health", ("beam_update", "packed_row_dist_words",
                                "gathered_vec_dist"), totals, health)

    def tombstones():
        dead = np.random.default_rng(7).choice(n, DEAD_N, replace=False)
        idx.remove_ids(dead)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        alive[torch.from_numpy(dead).to(dev)] = False
        _, gt_live = live_oracle(queries, base, alive, n)
        gt_live = gt_live.cpu().numpy()
        (d, i), secs = timed(lambda: idx.search(wl.queries, 10,
                                                ef_search=64))
        if np.isin(i[i >= 0], dead).any():
            raise AssertionError("l4 a removed id came back (filtered)")
        log(f"l4 {DEAD_N} tombstones, filtered packed ef=64: recall@10 "
            f"{recall_at_k(i, gt_live, 10):.4f} against the survivors, "
            f"{N_QUERIES / secs:.0f} qps")
        t0 = time.time()
        nv = idx.vacuum()
        torch.cuda.synchronize()
        secs_v = time.time() - t0
        check_clean("l4 after vacuum", idx)
        if nv != DEAD_N or idx.packed_enabled:
            raise AssertionError(f"l4 vacuum: {nv} nodes, tables kept "
                                 f"{idx.packed_enabled}")
        (d, i), secs = timed(lambda: idx.search(wl.queries, 10,
                                                ef_search=64))
        if np.isin(i[i >= 0], dead).any():
            raise AssertionError("l4 a removed id came back (vacuumed)")
        r = recall_at_k(i, gt_live, 10)
        log(f"  vacuum(): {nv} nodes in {secs_v:.2f} s, check() clean; "
            f"unpacked ef=64 recall@10 {r:.4f} against the survivors, "
            f"{N_QUERIES / secs:.0f} qps")
        return {"vacuum_s": secs_v, "recall": r}

    out["vacuum"] = phase("l4 sharded tombstones and vacuum",
                          ("beam_update", "gathered_vec_dist"), totals,
                          tombstones)
    del idx, base
    torch.cuda.empty_cache()

    def checkpoint():
        m = SHARD_CUT_N
        log(f"l5 cut: {m} of the base vectors, {SHARDS} shards of "
            f"{m // SHARDS}")
        half = m // 2

        def make():
            return ShardedHnswIndex(128, 32, "l2", mesh=mesh,
                                    capacity_per_shard=m // SHARDS,
                                    ef_construction=100)

        t0 = time.time()
        a = make()
        a.add(wl.base[:half])
        a.add(wl.base[half:m])
        b = make()
        b.add(wl.base[:half])
        with tempfile.TemporaryDirectory() as tmp:
            p = os.path.join(tmp, "mid.npz")
            b.save(p)
            c = ShardedHnswIndex.load(p, mesh=mesh)
            c.add(wl.base[half:m])
            same = all(
                torch.equal(getattr(ga, f), getattr(gc, f))
                if torch.is_tensor(getattr(ga, f))
                else getattr(ga, f) == getattr(gc, f)
                for ga, gc in zip(a._graphs, c._graphs) for f in vars(ga))
            same &= all(torch.equal(x, y) for x, y in
                        zip(a._global_ids + a._vectors,
                            c._global_ids + c._vectors))
            log(f"  mid-build save / load / add against an uninterrupted "
                f"build: equal array for array {same} "
                f"({time.time() - t0:.1f} s for the three builds)")
            if not same:
                raise AssertionError("l5 resumed build differs")
            d0, i0 = c.search(wl.queries, 10, ef_search=64)
            t0 = time.time()
            p = os.path.join(tmp, "full.npz")
            c.save(p)
            secs_save = time.time() - t0
            c._vectors[2].fill_(float("nan"))
            failed = [r["shard"] for r in c.health_check() if not r["ok"]]
            t0 = time.time()
            restored = c.restore_shards(p)
            secs_restore = time.time() - t0
            d1, i1 = c.search(wl.queries, 10, ef_search=64)
            log(f"  save {secs_save:.1f} s ({os.path.getsize(p)} bytes); "
                f"shard 2 NaN'd: health_check failed {failed}; "
                f"restore_shards {restored} in {secs_restore:.1f} s; "
                f"search equal to before: "
                f"{np.array_equal(i1, i0) and np.array_equal(d1, d0)}")
        if failed != [2] or restored != [2] or not (
                np.array_equal(i1, i0) and np.array_equal(d1, d0)):
            raise AssertionError("l5 corrupt / restore round trip failed")
        return a

    one = phase("l5 sharded checkpoint", ("beam_update", "gathered_vec_dist"),
                totals, checkpoint)
    out["multiprocess"] = multiprocess_phase(
        dev, totals, one, wl.base[:SHARD_CUT_N], wl.queries)
    return out


# phase m: what each rank searches, in this order (unpacked, then packed
# bytes at each ef, then shard 1 failed on the packed rows)
MP_SEARCHES = (("unpacked", 64), ("packed", 32), ("packed", 64),
               ("degraded", 64))
MP_TIMEOUT = 300                # seconds a rank may take, start-up included


def mp_searches(idx, queries, timer) -> dict:
    """The searches of phase m on ``idx`` (one-process or one rank's), in
    ``MP_SEARCHES`` order: {tag: (D, I, best synced wall s)}. Leaves shard
    1 ok and the packed tables on."""
    out = {}
    for kind, ef in MP_SEARCHES:
        if kind == "packed" and not idx.packed_enabled:
            idx.enable_packed(bits=8)
        if kind == "degraded":
            idx.mark_shard_failed(1)
        (d, i), secs = timer(lambda: idx.search(queries, 10, ef_search=ef))
        out[f"{kind} ef={ef}"] = (d, i, secs)
        idx.mark_shard_ok(1)
    return out


def mp_child(args) -> None:
    """One rank of phase m (``--rank R --world W --port P --mp-dir DIR``):
    ``torch.distributed`` under gloo on 127.0.0.1, this rank's block of the
    four shards on ``--mp-device``, the same calls as the one-process
    index (two adds of half the cut, then ``mp_searches``); writes this
    rank's shards, results, launch counts and times to DIR."""
    import torch.distributed as dist
    from hnsw_tpu_torch import ShardedHnswIndex, make_mesh
    from hnsw_tpu_torch.graph import SCALAR_FIELDS, TENSOR_FIELDS
    from hnsw_tpu_torch.ops import _cuda
    from hnsw_tpu_torch.parallel.sharded import merge_topk
    dev = torch.device(args.mp_device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def timer(fn, runs=2):
        """Best synced wall of ``runs``, each started with the other ranks
        (a search's collective waits for the slowest)."""
        best = None
        for _ in range(runs):
            sync()
            dist.barrier()
            t = time.time()
            res = fn()
            sync()
            best = min(best or 1e9, time.time() - t)
        return res, best

    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{args.port}",
                            rank=args.rank, world_size=args.world)
    try:
        base = np.load(os.path.join(args.mp_dir, "base.npy"))
        queries = np.load(os.path.join(args.mp_dir, "queries.npy"))
        mesh = make_mesh(SHARDS, devices=[dev] * (SHARDS // args.world))
        idx = ShardedHnswIndex(128, 32, "l2", mesh=mesh,
                               capacity_per_shard=len(base) // SHARDS,
                               ef_construction=100)
        _cuda.reset_launch_counts()
        half = len(base) // 2
        (_, build_s) = timer(lambda: (idx.add(base[:half]),
                                      idx.add(base[half:])), runs=1)
        res = mp_searches(idx, queries, timer)
        counts = _cuda.launch_counts()
        tagged = _cuda.tagged_launch_counts()
        # the collective and the merge alone, on this rank's shard results
        parts = [idx._search_shard(s, queries, 10, 64, None)
                 for s in idx._local]
        walls = []
        for _ in range(5):
            sync()
            t = time.perf_counter()
            every = idx._gather_parts(parts, len(queries), 10)
            merge_topk([p[0] for p in every], [p[1] for p in every], 10)
            sync()
            walls.append(time.perf_counter() - t)
        arrays = {}
        for s in idx._local:
            g = idx._graphs[s]
            for f in TENSOR_FIELDS:
                arrays[f"s{s}_{f}"] = getattr(g, f).cpu().numpy()
            for f in SCALAR_FIELDS:
                arrays[f"s{s}_{f}"] = np.int64(getattr(g, f))
            arrays[f"s{s}_vectors"] = idx._vectors[s].cpu().numpy()
            arrays[f"s{s}_global_ids"] = idx._global_ids[s].cpu().numpy()
        for tag, (d, i, _) in res.items():
            arrays[f"D {tag}"], arrays[f"I {tag}"] = d, i
        np.savez(os.path.join(args.mp_dir, f"rank{args.rank}.npz"), **arrays)
        with open(os.path.join(args.mp_dir, f"rank{args.rank}.json"),
                  "w") as f:
            json.dump({"local": idx._local, "build_s": build_s,
                       "walls_s": {t: r[2] for t, r in res.items()},
                       "gather_merge_ms": float(np.median(walls)) * 1e3,
                       "counts": counts, "tagged": tagged,
                       "jax_imported": "jax" in sys.modules}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def multiprocess_phase(dev, totals: dict, one, base: np.ndarray,
                       queries: np.ndarray) -> dict:
    """Phase m (module docstring): two ranks under gloo on this device
    against ``one``, the one-process index of l5 built on the same cut."""
    import socket
    import tempfile
    from hnsw_tpu_torch.graph import SCALAR_FIELDS, TENSOR_FIELDS
    want = phase("m1 one-process sharded searches",
                 ("beam_update", "packed_row_dist", "gathered_vec_dist"),
                 totals, lambda: mp_searches(one, queries, timed))
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "base.npy"), base)
        np.save(os.path.join(tmp, "queries.npy"), queries)
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--world", "2", "--port", str(port), "--mp-dir", tmp,
             "--mp-device", str(dev)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            logs = [p.communicate(timeout=MP_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.time() - t0
        for r, (p, text) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"m2 rank {r} exited {p.returncode}:\n"
                                     + "\n".join(text.splitlines()[-30:]))
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                info = json.load(f)
            info["arrays"] = dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
            ranks.append(info)
    checked = 0
    for r, info in enumerate(ranks):
        a = info.pop("arrays")
        if info["jax_imported"]:
            raise AssertionError(f"m2 rank {r} imported jax")
        for s in info["local"]:
            g = one._graphs[s]
            pairs = [(f, getattr(g, f).cpu().numpy()) for f in TENSOR_FIELDS]
            pairs += [(f, np.int64(getattr(g, f))) for f in SCALAR_FIELDS]
            pairs += [("vectors", one._vectors[s].cpu().numpy()),
                      ("global_ids", one._global_ids[s].cpu().numpy())]
            for f, arr in pairs:
                if not np.array_equal(a[f"s{s}_{f}"], arr):
                    raise AssertionError(f"m2 rank {r} shard {s} {f} "
                                         f"differs from the one-process "
                                         f"index")
                checked += 1
        for tag, (d, i, _) in want.items():
            if not np.array_equal(a[f"I {tag}"], i):
                raise AssertionError(f"m2 rank {r} {tag}: ids differ from "
                                     f"the one-process index")
            np.testing.assert_allclose(a[f"D {tag}"], d, rtol=1e-5,
                                       atol=1e-3, err_msg=f"m2 {tag}")
        deg = a["I degraded ef=64"]
        if (deg[deg >= 0] % SHARDS == 1).any():
            raise AssertionError(f"m2 rank {r}: a failed shard's id came "
                                 f"back")
        missing = [k for k in ("beam_update", "packed_row_dist",
                               "gathered_vec_dist") if info["counts"][k] == 0]
        if missing and dev.type == "cuda":   # a CPU rehearsal launches none
            raise AssertionError(f"m2 rank {r}: kernels never launched: "
                                 f"{missing}")
        for k, c in info["counts"].items():
            totals[k] = totals.get(k, 0) + c
        by_tag = totals.setdefault("by_tag", {})
        for k, tags in info["tagged"].items():
            for t, c in tags.items():
                by_tag[(k, t)] = by_tag.get((k, t), 0) + c
        walls = ", ".join(f"{t} {w * 1e3:.1f} ms ({len(queries) / w:.0f} "
                          f"qps)" for t, w in info["walls_s"].items())
        log(f"m2 rank {r} (shards {info['local']}): build "
            f"{info['build_s']:.1f} s; {walls}; all_gather + merge "
            f"{info['gather_merge_ms']:.3f} ms; kernel launches "
            f"{info['counts']}, by tag {info['tagged']}")
    one_walls = ", ".join(f"{t} {w * 1e3:.1f} ms" for t, (_, _, w)
                          in want.items())
    log(f"m2 two ranks under gloo on {dev}, {wall:.1f} s with start-up: "
        f"{checked} shard arrays equal to the one-process index's, ids "
        f"equal at {[t for t in want]} and distances within rtol 1e-5 + "
        f"atol 1e-3; shard 1 failed: no id = 1 (mod {SHARDS}); the "
        f"one-process index's walls: {one_walls}")
    return {"ranks": ranks, "wall_s": wall}


CPU_BASE_N, CPU_BASE_Q = 20_000, 1_000   # phase n


def cpu_baseline_phase(dev, totals: dict, card: str) -> dict:
    """Phase n (module docstring): the serial C++ ``CpuHnsw`` on one host
    core beside the device build, on the same 20,000 x 128 points."""
    from hnsw_tpu_torch import HnswIndex, synthetic_workload
    from hnsw_tpu_torch.native.cpu_baseline import (CpuHnsw, build_library,
                                                    cpu_model)
    from hnsw_tpu_torch.ops.distances import brute_force_topk
    from hnsw_tpu_torch.utils.recall import recall_at_k
    wl = synthetic_workload(CPU_BASE_N, 128, n_queries=CPU_BASE_Q, seed=1234)
    _, gt = brute_force_topk(torch.from_numpy(wl.queries).to(dev),
                             torch.from_numpy(wl.base).to(dev), 10)
    gt = gt.cpu().numpy()
    t0 = time.time()
    build_library()
    lib_s = time.time() - t0
    cpu = CpuHnsw(128, 32, seed=1)
    t0 = time.time()
    cpu.add(wl.base, ef_construction=100)
    cpu_build_s = time.time() - t0
    cpu_out = {}
    for ef in (16, 32, 64):
        t0 = time.time()
        ids = cpu.search(wl.queries, 10, ef_search=ef)
        secs = time.time() - t0
        cpu_out[ef] = (recall_at_k(ids, gt, 10), CPU_BASE_Q / secs)

    def device():
        idx = HnswIndex(128, 32, "l2", capacity=CPU_BASE_N,
                        ef_construction=100, seed=1, device=dev)
        t0 = time.time()
        idx.add(wl.base)
        torch.cuda.synchronize()
        secs = time.time() - t0
        out = {}
        for ef in (16, 32, 64):
            (_, i), wall = timed(lambda: idx.search(wl.queries, 10,
                                                    ef_search=ef))
            out[ef] = (recall_at_k(i, gt, 10), CPU_BASE_Q / wall)
        return secs, out

    dev_build_s, dev_out = phase("n device build beside CpuHnsw",
                                 ("beam_update", "gathered_vec_dist"),
                                 totals, device)
    host = cpu_model()
    log(f"n CpuHnsw (serial C++, one core of {host}): library "
        f"{lib_s:.1f} s, build of {CPU_BASE_N} x 128 (M=32, efC=100) "
        f"{cpu_build_s:.2f} s ({CPU_BASE_N / cpu_build_s:.0f} inserts/s); "
        f"device build on {card} {dev_build_s:.2f} s")
    for ef in (16, 32, 64):
        (rc, qc), (rd, qd) = cpu_out[ef], dev_out[ef]
        log(f"  ef={ef}: recall@10 CpuHnsw {rc:.4f} at {qc:.0f} qps "
            f"(one core), device build {rd:.4f} at {qd:.0f} qps "
            f"({CPU_BASE_Q} queries, best of 2)")
        if rd < rc - 0.03:
            raise AssertionError(f"n ef={ef}: the device build's recall "
                                 f"{rd:.4f} is more than 0.03 below "
                                 f"CpuHnsw's {rc:.4f}")
    return {"cpu_build_s": cpu_build_s, "cpu": cpu_out, "device": dev_out,
            "host_cpu": host}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=NORTH_STAR_N,
                    help="base vectors of the main-path run")
    ap.add_argument("--profile", action="store_true",
                    help="also profile ef=64 searches: packed bytes and "
                         "words rows, HNSW_TPU_PALLAS_HOP=1, sq8 (adds "
                         "their runs to the launch counts)")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mp-dir", help=argparse.SUPPRESS)
    ap.add_argument("--mp-device", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:      # one rank of phase m
        mp_child(args)
        return
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
    k5_bf16 = measured["fused_gather_distances"]["bfloat16"]
    timed_cases = dict(measured)
    timed_cases["packed_row_dist (8-bit, d=96)"] = \
        measured["packed_row_dist"]["d96"]
    timed_cases["fused_gather_distances (bfloat16 rows)"] = k5_bf16
    for shape, m in measured["fused_gather_distances"]["shapes"].items():
        timed_cases[f"fused_gather_distances ({shape})"] = m
    for name, m in timed_cases.items():
        log(f"  {name}: kernel {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} "
            f"ms, bound {m['bound_ms']:.4f} ms by {m['bound_by']} "
            f"({m['bytes'] / 1e6:.1f} MB)")
    torch.cuda.empty_cache()

    if args.n < NORTH_STAR_N:
        log(f"main path cut: n={args.n} of {NORTH_STAR_N}")
    totals: dict = {}
    unsharded = main_path(args.n, dev, totals, args.profile)
    torch.cuda.empty_cache()       # the f32 index and its tables are gone
    log("K3 at the storage codecs' rows, and ADC, on the card:")
    codec_k3 = check_vec_dist_codecs(dev, gen)
    for tag, m in codec_k3.items():
        log(f"  gathered_vec_dist {tag} d={m['d']}: kernel {m['ms']:.4f} ms, "
            f"plain {m['plain_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms by "
            f"{m['bound_by']} ({m['bytes'] / 1e6:.1f} MB)")
    torch.cuda.empty_cache()
    codec = codec_path(dev, totals, args.profile)
    torch.cuda.empty_cache()
    wrapped = wrappers_path(dev, totals, codec.pop("sq8_refine"),
                            codec["pq_truth"])
    del codec
    torch.cuda.empty_cache()
    sharded = sharded_path(dev, totals, unsharded)
    log(f"phase l: build {sharded['build_s']:.1f} s, merge "
        f"{sharded['merge_ms']:.4f} ms")
    torch.cuda.empty_cache()
    cpu_baseline_phase(dev, totals, card)
    by_tag = totals.pop("by_tag")
    log(f"kernel launches over the main path's phases: {totals}; K3 and K5 "
        f"by row dtype {by_tag}")
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

    # K3's and K5's launches are counted by row dtype: their main rows are
    # the f32 rows' launches
    k3, k5_name = "gathered_vec_dist", "fused_gather_distances"
    rows = [row(name, m, by_tag.get((name, "float32"), 0)
                if name in (k3, k5_name) else totals[name])
            for name, m in measured.items()]
    rows += [row(k3, m, by_tag.get((k3, tag), 0),
                 f"{k3} ({tag} rows{' + dequant' if tag == 'uint8' else ''}"
                 f", d={m['d']})") for tag, m in codec_k3.items()]
    rows.append(row(k5_name, k5_bf16,
                    by_tag.get((k5_name, "bfloat16"), 0),
                    f"{k5_name} (bfloat16 rows, d=128)"))
    refine_k3 = wrapped["refine_k3"]
    rows.append(row(k3, refine_k3, refine_k3["launches"],
                    f"{k3} (refine rerank, f32 rows, {refine_k3['shape']})"))
    shard_k3 = sharded["build_k3"]
    rows.append(row(k3, shard_k3, shard_k3["launches"],
                    f"{k3} (sharded build, f32 rows, {shard_k3['shape']})"))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
