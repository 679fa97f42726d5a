"""Runner of ``ingest`` mixes: ``add()`` calls of ``block`` vectors back
to back into an index that starts empty; a full index is followed by a new
empty one that takes the same blocks again. After the window each index's
stored rows, level-0 links and a search of ``check_queries`` queries over
it are judged against the data it was given."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import cells, checks, faults, reference, system
from portbench.trace import Window, span, sync

# the cuts of a tiny run on the CPU (the tests' ``pb_tiny``)
TINY = dict(block=500, check_queries=128)
FAULTS = faults.ADD
CONTROL_FAILS = ("dist_gap", "row_gap")   # what the control has to fail


def drive(cell, cfg, spec, seed, seconds, trace, device, t_process):
    ctx, res = cells.Context(cell, cfg, spec), cells.Result()
    bsz = spec["block"]
    base, queries = cells.host_data(cfg, spec["check_queries"], seed, device)
    blocks = [base[s:s + bsz] for s in range(0, len(base), bsz)]
    warm = system.new_index(cfg, device)
    for b in blocks[:2]:      # from empty, then into a graph of one block
        warm.add(b)
    sync(device)
    del warm
    gc.collect()
    win = Window(device) if trace else None
    if win is not None:
        win.warm()
    built = [[system.new_index(cfg, device), 0]]
    stats = []
    n = 0
    sync(device)
    t0 = time.perf_counter()
    res.e2e["setup_s"] = time.time() - t_process
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        idx, added = built[-1]
        if added + bsz > cfg["capacity"] or added >= len(base):
            built.append([system.new_index(cfg, device), 0])
            idx, added = built[-1]
        blk = blocks[added // bsz]
        tracing = win is not None and n == 1
        if tracing:
            win.start()
        with span("portbench.add"):
            idx.add(blk)
            sync(device)
        if tracing:
            win.stop()
        built[-1][1] += len(blk)
        stats.append(system.build_stats(idx))
        n += 1
    t_end = time.perf_counter()
    total = sum(a for _, a in built)
    res.attempted = n
    res.e2e["build_vps"] = total / (t_end - t0)
    res.notes.append(f"{n} add() calls of {bsz} ({total} vectors) in "
                     f"{t_end - t0:.3f} s, {t_end - deadline:.3f} s past "
                     f"the window's {seconds} s")
    res.peak = cells.peak(device)
    ctx.counters["build_stats"] = stats
    # the program's outputs: each index's rows and level-0 adjacency, and a
    # search of the check queries over it
    outs = []
    for idx, added in built:
        d, ids = system.search(idx, queries, cfg["k"], cfg["ef_search"])
        outs.append(dict(added=added, ntotal=idx.ntotal,
                         rows=system.stored_rows(idx),
                         nbrs=system.level0(idx), d=d, i=ids))
    del built, idx
    cells.free(device)
    judge_ingest(res, cfg, base, queries, outs, seed, device)
    return res, ctx, win


def judge_ingest(res, cfg, base, queries, outs, seed, device) -> None:
    """Each index the window built against the data it was given: its
    count, its stored rows (exact), its level-0 links valid, and a search
    over it judged as a search cell's answers are."""
    lim = cfg["limits"]
    k = cfg["k"]
    xq = torch.from_numpy(queries).to(device)
    count_gap = row_gap = links = bad = 0
    recall, gap = 1.0, 0.0
    for o in outs:
        want = torch.from_numpy(base[:o["added"]]).to(device)
        count_gap = max(count_gap, abs(o["ntotal"] - o["added"]))
        rows = torch.from_numpy(o["rows"]).to(device)
        if rows.shape != want.shape:
            row_gap = float("inf")
        elif len(rows):
            row_gap = max(row_gap, float((rows - want).abs().max()))
        links += checks.bad_links(torch.from_numpy(o["nbrs"]).to(device),
                                  o["ntotal"])
        del rows
        if not len(want):
            continue
        ans = checks.Answers()
        ans.add(0, o["d"], o["i"])
        truth, _ = reference.exact_topk(xq, want, k)
        r, b = checks.recall_and_bad(ans, truth, len(want))
        recall, bad = min(recall, r), bad + b
        gap = max(gap, checks.dist_gap(ans, [0], xq, want))
    res.verdict.add("count_gap", count_gap, "<=", 0)
    res.verdict.add("row_gap", row_gap, "<=", 0)
    res.verdict.add("bad_links", links, "<=", 0)
    res.verdict.add("bad_ids", bad, "<=", 0)
    res.verdict.add("recall_at_10", recall, ">=", lim["recall_at_10"])
    res.verdict.add("dist_gap", gap, "<=", lim["dist_gap"])


def control(cfg, spec, seed, device, rows=150_000, **_):
    """The verdict on the reference in the program's place: the first
    ``rows`` vectors stored rounded to TF32, and the check queries answered
    over them with the exact top-k by TF32 distances."""
    base, queries = cells.host_data(cfg, spec["check_queries"], seed,
                                    device)
    xb = torch.from_numpy(base[:rows]).to(device)
    stored = reference.tf32(xb)
    ids, d = reference.exact_topk(torch.from_numpy(queries).to(device),
                                  stored, cfg["k"], rounding=reference.tf32)
    out = dict(added=rows, ntotal=rows, rows=stored.cpu().numpy(),
               nbrs=np.full((rows, cfg["m0"]), -1, np.int32),
               d=d.cpu().numpy(), i=ids.cpu().numpy())
    del xb, stored
    res = cells.Result()
    judge_ingest(res, cfg, base, queries, [out], seed, device)
    return res.verdict
