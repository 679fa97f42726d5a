"""The ef sweep of a sharded fan-out cell (a ``fanout_batches`` mix,
``traffic/fanout_batches.py``), to choose the configuration's
``ef_search``: for each seed one set-up through the cell's runner (the
data, the sharded build), then at each ef two warm searches (a capture
where the ef's buffer is new), every pool batch searched ``--reps`` times
through the runner's ``serve`` (each unit handed out with ``ranks.step``),
and each rank's own shard searched alone at that ef. Once the group has
left, the reference (``reference.py``) judges every ef: recall@10 against
the exact top-10 over x̂ of the whole corpus, each shard's recall@10 of
its own top-10 against the exact top-10 over its own x̂ rows (the
search's quality on one shard, apart from the fan-out and the merge), and
recall against the f32 truth.

    python3 portbench/sweep_ef.py --workload <cell> --seeds 1 2 3 \\
        --efs 64 80 96 112 128 [--reps 3] [--bar 0.955] [--n N]

Prints one JSON line a (seed, ef): the recalls, the median and p95 batch
ms on rank 0's clock, the searches' captures over the ranks after the
warm searches, and whether every rank's answers equal rank 0's; then one
line with the smallest ef whose recall against x̂ reads at least
``--bar`` on every seed. ``--n`` cuts the corpus (and the capacity) for a
rehearsal.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import (cells, manifest, ranks, reference, spans,  # noqa: E402
                       traffic)


def _captures() -> int:
    t = spans.totals()
    return 0 if t is None else int(t.counters.get("captures.search", 0))


def _seed_part(cfg: dict, spec: dict, seed: int, device) -> list:
    """What every rank does for one seed, in the same order: a dict an ef
    of this rank's readings (rank 0's answers, every rank's own shard's
    ids)."""
    runner = traffic.runner(spec["kind"])
    lead = ranks.rank() == 0
    k, reps = cfg["k"], spec["reps"]
    t0 = time.perf_counter()
    _, _, pool, idx = runner.setup(cfg, spec, seed, device)
    setup_s = time.perf_counter() - t0
    out = []
    for ef in spec["efs"]:
        for _ in range(2):
            ranks.step(0) if lead else ranks.step()
            runner.serve(idx, pool[0], k, ef)
        before = _captures()
        times, answers = [], []
        digest = hashlib.sha256()
        for rep in range(reps):
            for j in range(len(pool)):
                t = time.perf_counter()
                ranks.step(j) if lead else ranks.step()
                d, i = runner.serve(idx, pool[j], k, ef)
                times.append(time.perf_counter() - t)
                if rep == 0:
                    digest.update(d.tobytes() + i.tobytes())
                    if lead:
                        answers.append((d, i))
        captures = _captures() - before
        own = {s: np.concatenate([
            idx._search_shard(s, q, k, ef, None)[1].cpu().numpy()
            for q in pool]) for s in idx._local}
        out.append({"ef": ef, "setup_s": setup_s, "times": times,
                    "captures": captures, "digest": digest.hexdigest(),
                    "answers": answers, "own": own})
    del idx
    cells.free(device)
    return out


def _part(cfg, spec, device) -> list:
    """Every seed's part on this rank; rank 0 gets every rank's."""
    got = []
    for seed in spec["seeds"]:
        mine = _seed_part(cfg, spec, seed, device)
        every = ranks.gather([{k: v for k, v in e.items() if k != "answers"}
                              for e in mine])
        got.append((seed, mine, every))
    ranks.step(-1) if ranks.rank() == 0 else ranks.step()
    return got


def follow(cell, cfg, spec, seed, seconds, trace, device):
    _part(cfg, spec, device)


def recall(ids: np.ndarray, truth, device) -> float:
    import torch
    got = torch.from_numpy(ids[:, :truth.shape[1]].astype(np.int64)).to(
        device)
    return reference.hits(got, truth) / got.numel()


def judge(cfg, spec, seed, mine, every, device) -> list:
    """One line an ef of one seed."""
    import torch
    base, queries = cells.host_data(cfg, traffic.runner(
        spec["kind"]).pool_rows(spec), seed, device)
    xb = torch.from_numpy(base).to(device)
    xq = torch.from_numpy(queries).to(device)
    k, shards = cfg["k"], cfg["shards"]
    truth_f32, _ = reference.exact_topk(xq, xb, k)
    xb = reference.stored_rows(cfg, xb)
    truth, _ = reference.exact_topk(xq, xb, k)
    own_truth = []
    for s in range(shards):
        t, _ = reference.exact_topk(xq, xb[s::shards].contiguous(), k)
        own_truth.append(t * shards + s)
    lines = []
    for e, rows in zip(mine, zip(*every)):
        ids = np.concatenate([i for _, i in e["answers"]])
        own = {s: i for r in rows for s, i in r["own"].items()}
        t = np.asarray(e["times"]) * 1e3
        lines.append({
            "seed": seed, "ef": e["ef"], "n": cfg["n"],
            "recall_xhat_at_10": recall(ids, truth, device),
            "recall_at_10": recall(ids, truth_f32, device),
            "shard_recall_xhat_at_10": [recall(own[s], own_truth[s], device)
                                        for s in range(shards)],
            "batch_ms_median": float(np.median(t)),
            "batch_ms_p95": float(np.percentile(t, 95)),
            "searches": len(t), "captures": sum(r["captures"] for r in rows),
            "ranks_equal": len({r["digest"] for r in rows}) == 1,
            "setup_s": [r["setup_s"] for r in rows]})
    del xb, xq, truth, truth_f32, own_truth
    cells.free(device)
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--efs", type=int, nargs="+", required=True)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--bar", type=float, default=0.955)
    p.add_argument("--n", type=int, default=0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    man = manifest.load(ROOT)
    cell = manifest.cell(man, a.workload)
    cfg = manifest.config(man, cell["config"], ROOT)
    if a.n:
        cfg.update(n=a.n, capacity=a.n)
    spec = dict(traffic.load(cell["traffic"]), seeds=a.seeds, efs=a.efs,
                reps=a.reps)
    if a.device == "cuda" and torch.cuda.device_count() < cell["chips"]:
        print(f"sweep: needs {cell['chips']} CUDA devices", file=sys.stderr)
        return 2
    with ranks.launched(a.workload, cfg, spec, a.seeds[0], 0.0, False,
                        a.device, cell["chips"],
                        module="portbench.sweep_ef") as dev:
        got = _part(cfg, spec, dev)
        ranks.leave()
    passing = set(a.efs)
    for seed, mine, every in got:
        for line in judge(cfg, spec, seed, mine, every, dev):
            print(json.dumps(line), flush=True)
            if line["recall_xhat_at_10"] < a.bar:
                passing.discard(line["ef"])
    print(json.dumps({"bar": a.bar, "seeds": a.seeds,
                      "smallest_ef": min(passing) if passing else None}),
          flush=True)
    return 0


if __name__ == "__main__":
    from portbench import sweep_ef
    sys.exit(sweep_ef.main())
