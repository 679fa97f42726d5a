"""Drive the PyTorch/CUDA port (``hnsw_tpu_torch``) once on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is not 0):

  1. require CUDA; print the card's name and power limit;
  2. build the hand-written kernels (nvcc, sm_90a) and print the seconds;
  3. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes (Q=8192, K=64, d=128, ef in {32, 64, 128, 512}) and
     at 4-bit, bf16, uint8-dequant, odd-d and IP variants; time both with
     CUDA events;
  4. the main path: ``synthetic_workload(n, 128, n_queries=8192,
     seed=1234)`` (SIFT1M-shaped, n = 1,000,000 by default), build with
     M=32 / efConstruction=100, ``check()``, ``enable_packed(bits=8)``,
     exact ground truth from ``brute_force_topk`` on the card, then k=10
     searches at ef in {32, 64, 128} packed and ef=64 unpacked. Requires
     packed recall@10 >= 0.95 at the best ef, packed and unpacked within
     0.01 at ef=64, and every kernel launched during the searches.

``--n N`` (N >= 300,000) cuts the main path's base to N vectors (the cut is
printed); with no arguments it runs the full 1,000,000.

The next-to-last lines are one JSON object with each kernel's launches,
error and times, and the ``nvidia-smi`` name and power limit; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

NORTH_STAR_N = 1_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
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


def check_vec_dist(dev, gen) -> dict:
    """K3. Tolerance: rtol 1e-5 + atol 1e-3 — f32 sums of d terms taken in
    another order than the plain version's."""
    from hnsw_tpu_torch.ops import dist_kernel as dk
    q, k, n = 8192, 64, NORTH_STAR_N
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
                    out["ms"] = time_ms(lambda: dk.gathered_vec_dist_ids(
                        table, ids, qs, metric="l2"))
                    out["plain_ms"] = time_ms(
                        lambda: dk.gathered_vec_dist_plain(
                            table, ids, qs, metric="l2"))
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


def check_packed_dist(dev, gen) -> dict:
    """K2 at the main path's row (64 neighbors x 128 dims x 8 bits = 8 KB)
    over a 300k-row table (2.46 GB, so row offsets cross 2^31), plus 4-bit,
    odd d and IP. Tolerance: rtol 1e-5 + atol 1e-2 (f32 sums of up to 128
    code * query terms, each up to ~500, in another order)."""
    from hnsw_tpu_torch.ops import dist_kernel as dk
    q, k = 8192, 64
    out = {}
    for d, bits, rows in ((128, 8, 300_000), (128, 4, 300_000),
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
        del codes, nbr_sq
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


def check_beam_update(dev, gen) -> dict:
    """K1: must equal the plain version exactly (both are a stable merge of
    buffer ++ fresh candidates), at Q=8192, K=64."""
    from hnsw_tpu_torch.ops import beam_kernel as bk
    q, k = 8192, 64
    out = {}
    for ef in (32, 64, 128, 512):
        for ef_live in sorted({ef, max(1, ef * 3 // 4)}):
            args = beam_inputs(q, ef, k, dev, gen)
            got = bk.beam_update(*args, ef_live)
            want = bk.beam_update_plain(*args, ef_live)
            torch.cuda.synchronize()
            names = ("buf_d", "buf_p", "cur", "ndis")
            for name, g, w in zip(names, got, want):
                if not torch.equal(g, w):
                    bad = int((g != w).sum())
                    raise AssertionError(f"beam_update ef={ef} ef_live="
                                         f"{ef_live}: {name} differs in "
                                         f"{bad} places")
            err = float((got[0] - want[0]).nan_to_num(0.0).abs().max())
            log(f"  beam_update ef={ef} ef_live={ef_live}: exact "
                f"(ndis mean {want[3].float().mean():.1f})")
            if ef == 64 and ef_live == ef:
                out["max_abs_err"] = err
                out["ms"] = time_ms(lambda: bk.beam_update(*args, ef_live))
                out["plain_ms"] = time_ms(
                    lambda: bk.beam_update_plain(*args, ef_live))
    return out


def main_path(n: int, dev) -> dict:
    from hnsw_tpu_torch import HnswIndex, synthetic_workload
    from hnsw_tpu_torch.ops import _cuda
    from hnsw_tpu_torch.ops.distances import brute_force_topk
    from hnsw_tpu_torch.utils.recall import recall_at_k

    t0 = time.time()
    wl = synthetic_workload(n, 128, n_queries=8192, seed=1234)
    log(f"workload: {n} x 128 base, 8192 queries ({time.time() - t0:.1f} s)")
    torch.cuda.reset_peak_memory_stats()
    idx = HnswIndex(128, 32, "l2", capacity=n, ef_construction=100,
                    device=dev)
    t0 = time.time()
    idx.add(wl.base)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    log(f"build: {build_s:.1f} s ({n / build_s:.0f} inserts/s), back-link "
        f"window drops {idx._builder.last_backlink_dropped}")
    t0 = time.time()
    stats = idx.check()
    log(f"check: {time.time() - t0:.1f} s, errors {stats['errors']}, "
        f"deg0_mean {stats['deg0_mean']:.2f}, reciprocity0 "
        f"{stats['reciprocity0']:.4f}, max_level {stats['max_level']}")
    if stats["errors"]:
        raise AssertionError(f"graph invariants: {stats['errors']}")
    t0 = time.time()
    nbytes = idx.enable_packed(bits=8)
    torch.cuda.synchronize()
    log(f"enable_packed(bits=8): {nbytes} bytes ({nbytes / 1e9:.2f} GB) in "
        f"{time.time() - t0:.1f} s")

    queries = torch.from_numpy(wl.queries).to(dev)
    t0 = time.time()
    gt_d, gt = brute_force_topk(queries, idx.vectors, 10, "l2", n_valid=n)
    gt = gt.cpu().numpy()
    log(f"ground truth (brute_force_topk on the card): "
        f"{time.time() - t0:.1f} s")

    def run(ef, packed):
        best = None
        for _ in range(2):   # best of two synced wall-clock runs
            torch.cuda.synchronize()
            t = time.time()
            d, i, st = idx.search(queries, 10, ef_search=ef, with_stats=True,
                                  use_packed=packed, device_out=True)
            torch.cuda.synchronize()
            dt = time.time() - t
            best = dt if best is None else min(best, dt)
        if tuple(i.shape) != (8192, 10) or not torch.isfinite(
                d[i >= 0]).all():
            raise AssertionError("search output malformed")
        r = recall_at_k(i.cpu().numpy(), gt, 10)
        log(f"search {'packed' if packed else 'unpacked'} ef={ef}: "
            f"recall@10 {r:.4f}, {8192 / best:.0f} qps (best of 2, "
            f"{best * 1e3:.1f} ms), hops {st.hops}, ndis mean "
            f"{st.ndis.float().mean():.1f}")
        return r, d, i

    before = _cuda.launch_counts()
    recalls = {}
    for ef in (32, 64, 128):
        recalls[ef], d, i = run(ef, True)
    unpacked, d_u, i_u = run(64, False)
    grew = {k: n - before[k] for k, n in _cuda.launch_counts().items()}
    log(f"kernel launches during the searches: {grew}")
    if min(grew.values()) <= 0:
        raise AssertionError(f"a kernel was not launched by the searches: "
                             f"{grew}")
    # returned distances are exact squared L2 of the returned ids
    x = idx.vectors[i[:, 0].long().clamp(min=0)]
    exact = ((queries - x) ** 2).sum(1)
    if not torch.allclose(d[:, 0], exact, rtol=1e-4, atol=1e-3):
        raise AssertionError("returned distances are not exact squared L2")
    best = max(recalls.values())
    if best < 0.95:
        raise AssertionError(f"packed recall@10 {best:.4f} < 0.95")
    if abs(recalls[64] - unpacked) > 0.01:
        raise AssertionError(f"packed {recalls[64]:.4f} vs unpacked "
                             f"{unpacked:.4f} recall at ef=64 differ > 0.01")
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return {"build_s": build_s, "recall": recalls, "unpacked": unpacked}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=NORTH_STAR_N,
                    help="base vectors of the main-path run")
    args = ap.parse_args()
    if args.n < 300_000:   # smaller tables keep 8 KB row offsets below 2^31
        raise SystemExit(f"chip_smoke: --n {args.n} is below 300,000")

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    import hnsw_tpu_torch  # noqa: F401  (sets exact-f32 matmul precision)
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
                "beam_update": check_beam_update(dev, gen)}
    for name, m in measured.items():
        log(f"  {name}: kernel {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms")
    torch.cuda.empty_cache()

    if args.n < NORTH_STAR_N:
        log(f"main path cut: n={args.n} of {NORTH_STAR_N}")
    _cuda.reset_launch_counts()
    main_path(args.n, dev)
    counts = _cuda.launch_counts()
    log(f"kernel launches during the main path: {counts}")
    missing = [k for k in measured if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    sources = {"gathered_vec_dist": ("hnsw_tpu_torch/csrc/dist_kernel.cu",
                                     "hnsw_tpu/ops/dist_kernel.py:308"),
               "packed_row_dist": ("hnsw_tpu_torch/csrc/dist_kernel.cu",
                                   "hnsw_tpu/ops/dist_kernel.py:129"),
               "beam_update": ("hnsw_tpu_torch/csrc/beam_kernel.cu",
                               "hnsw_tpu/ops/beam_kernel.py:204")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": counts[name],
         "max_abs_err": m["max_abs_err"], "ms": m["ms"],
         "plain_ms": m["plain_ms"]} for name, m in measured.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
