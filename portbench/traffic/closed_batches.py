"""Runner of ``closed_batches`` mixes: one client sends batches of
``batch`` queries back to back, each after the last returned, cycling a
pool of ``pool_batches`` distinct batches in an order drawn from the seed.
Reads ``batch``, ``pool_batches`` and ``trace_seconds``."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import cells, checks, faults, reference, system, traffic
from portbench.trace import Window, span, sync

# the cuts of a tiny run on the CPU (the tests' ``pb_tiny``)
TINY = dict(batch=128, pool_batches=2, trace_seconds=0.3)
FAULTS = faults.SEARCH
CONTROL_FAILS = ("dist_gap",)     # what the control has to fail


def pool_rows(spec: dict) -> int:
    return spec["batch"] * spec["pool_batches"]


def drive(cell, cfg, spec, seed, seconds, trace, device, t_process):
    ctx, res = cells.Context(cell, cfg, spec), cells.Result()
    k, ef, bsz = cfg["k"], cfg["ef_search"], spec["batch"]
    base, queries, idx = cells.setup_search(cfg, spec, seed, device)
    pool = [queries[j * bsz:(j + 1) * bsz]
            for j in range(spec["pool_batches"])]
    for stats in ((False, True) if trace else (False,)):
        for _ in range(3):        # capture, then replays
            system.search(idx, pool[0], k, ef, stats)
    perm = traffic.batch_order(spec["pool_batches"], seed,
                               spec["pool_batches"])
    win = Window(device) if trace else None
    if win is not None:
        win.warm()
    t_on, t_len = cells.trace_start(spec, seconds)
    answers, lat = checks.Answers(), []
    hops, ndis = 0, torch.zeros((), dtype=torch.int64, device=device)
    tr = {"ndis": torch.zeros((), dtype=torch.int64, device=device),
          "batches": 0, "q_rows": bsz}
    n = 0
    sync(device)
    t0 = time.perf_counter()
    res.e2e["setup_s"] = time.time() - t_process
    deadline = t0 + seconds
    t_end = t0
    while True:
        t = time.perf_counter()
        if t >= deadline:
            break
        if win is not None:
            if win.pending and t - t0 >= t_on:
                win.start()
                l0 = system.launches()
            elif win.active and win.elapsed() >= t_len:
                win.stop()
                tr["launches"] = cells.delta(system.launches(), l0)
        j = int(perm[n % len(perm)])
        with span("portbench.search"):
            out = system.search(idx, pool[j], k, ef, trace)
        t_end = time.perf_counter()
        lat.append(t_end - t)
        answers.add(j * bsz, out[0], out[1])
        if trace:
            hops += out[2].hops
            s = out[2].ndis.sum(dtype=torch.int64)
            ndis += s
            if win.active:
                tr["ndis"] += s
                tr["batches"] += 1
        n += 1
    if win is not None and win.active:
        win.stop()
        tr["launches"] = cells.delta(system.launches(), l0)
    res.attempted = n
    res.e2e["qps"] = n * bsz / (t_end - t0)
    res.e2e["p95_ms"] = float(np.percentile(lat, 95)) * 1e3
    res.notes.append(f"{n} batches of {bsz} in {t_end - t0:.3f} s; "
                     f"p50 {np.percentile(lat, 50) * 1e3:.3f} ms")
    res.peak = cells.peak(device)
    if trace:
        tr["ndis"] = int(tr["ndis"])
        ctx.counters.update(batches=n, queries=n * bsz, hops=hops,
                            ndis=int(ndis), traced=tr)
    del idx
    cells.free(device)
    cells.judge_search(res, cfg, base, queries, answers, seed, device)
    return res, ctx, win


def control(cfg, spec, seed, device, **_):
    """The verdict on the reference in the program's place, its operands
    rounded to TF32: every batch of the pool answered with the exact top-k
    over the stored rows."""
    base, queries = cells.host_data(cfg, pool_rows(spec), seed, device)
    ids, d = reference.control_topk(cfg, base, queries, device)
    answers = checks.Answers()
    b = spec["batch"]
    for j in range(spec["pool_batches"]):
        answers.add(j * b, d[j * b:(j + 1) * b], ids[j * b:(j + 1) * b])
    res = cells.Result()
    cells.judge_search(res, cfg, base, queries, answers, seed, device)
    return res.verdict
