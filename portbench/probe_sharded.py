"""Probe of the port's one-process-a-card form (``ShardedHnswIndex`` under
a ``torch.distributed`` group, NCCL on cards) at the size of a four-card
cell: the Deep configuration's data (``portbench/configs/
deep1m-hnsw32-sq8.json``) at ``--n`` rows, sq8, M=32, one shard a rank.
Not a cell and not a test: it sizes one.

    python3 portbench/probe_sharded.py [--n 10000000] [--ranks 4] \\
        [--queries 8192] [--ef 64] [--reps 30] [--device cuda]

The ranks come up through the benchmark's launcher (``ranks.py``). Every
rank makes the data from the seed, trains the shared quantizer (on shard
0's rank, broadcast), inserts its own shard in the lockstep build, then
runs ``--reps`` replayed fan-out searches of ``--queries`` queries at ef
``--ef``, each unit handed out by ``ranks.step``. Prints one JSON line:
the set-up seconds (the group, the data, the build) and the peak host and
device memory of each rank, the median ms of a search on rank 0's clock,
whether every rank's (D, I) equals rank 0's, and recall@10 against the
exact top-10 over x̂ (``reference.py``, once the index is freed).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import resource
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import cells, manifest, ranks, reference  # noqa: E402
from portbench.trace import sync  # noqa: E402


def _part(cfg: dict, spec: dict, seed: int, device):
    """What every rank does, in the same order: (D, I, base, queries, this
    rank's readings)."""
    from hnsw_tpu_torch.parallel.sharded import ShardedHnswIndex, make_mesh
    lead = ranks.rank() == 0
    t0 = time.perf_counter()
    base, queries = cells.host_data(cfg, spec["queries"], seed, device)
    t1 = time.perf_counter()
    mesh = make_mesh(ranks.world(), 1, devices=[device])
    idx = ShardedHnswIndex(
        cfg["d"], cfg["m"], cfg["metric"], mesh=mesh,
        capacity_per_shard=math.ceil(cfg["n"] / ranks.world()),
        ef_construction=cfg["ef_construction"], ef_search=spec["ef"],
        dtype=cfg["dtype"])
    idx.train(base[:cfg["sq_train_rows"]])
    idx.add(base)
    sync(device)
    t2 = time.perf_counter()
    for _ in range(2):                  # capture, then a replay
        idx.search(queries, cfg["k"], ef_search=spec["ef"])
    t3 = time.perf_counter()
    times = []
    for rep in range(spec["reps"]):
        t = time.perf_counter()
        ranks.step(rep) if lead else ranks.step()
        d, i = idx.search(queries, cfg["k"], ef_search=spec["ef"])
        times.append(time.perf_counter() - t)
    ranks.step(-1) if lead else ranks.step()
    mine = {
        "rank": ranks.rank(), "data_s": t1 - t0, "build_s": t2 - t1,
        "warm_s": t3 - t2,
        "search_ms_median": 1e3 * sorted(times)[len(times) // 2],
        "digest": hashlib.sha256(d.tobytes() + i.tobytes()).hexdigest(),
        "host_peak_bytes": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024,
        "device_peak_bytes": cells.peak(device),
        "shard_rows": int(sum(g.ntotal for s, g in enumerate(idx._graphs)
                              if idx._is_local(s))),
    }
    del idx
    cells.free(device)
    return d, i, base, queries, mine


def follow(cell, cfg, spec, seed, seconds, trace, device):
    ranks.gather(None)
    mine = _part(cfg, spec, seed, device)[4]
    ranks.gather(mine)


def probe(a) -> dict:
    import torch
    man = manifest.load(ROOT)
    cfg = manifest.config(man, "deep1m-hnsw32-sq8", ROOT)
    cfg["n"] = a.n
    spec = {"queries": a.queries, "ef": a.ef, "reps": a.reps}
    t0 = time.perf_counter()
    with ranks.launched("probe", cfg, spec, a.seed, 0.0, False, a.device,
                        a.ranks, module="portbench.probe_sharded") as dev:
        ranks.gather(None)
        up_s = time.perf_counter() - t0
        d, i, base, queries, mine = _part(cfg, spec, a.seed, dev)
        every = ranks.gather(mine)
        print(f"probe, before the group's teardown: up {up_s} s, {every}",
              file=sys.stderr, flush=True)
        ranks.leave()
    xb = reference.stored_rows(cfg, torch.from_numpy(base).to(dev))
    truth, _ = reference.exact_topk(torch.from_numpy(queries).to(dev), xb,
                                    cfg["k"])
    got = torch.from_numpy(i[:, :cfg["k"]]).to(dev)
    recall = reference.hits(got, truth) / got.numel()
    return {
        "n": a.n, "d": cfg["d"], "ranks": a.ranks, "queries": a.queries,
        "ef": a.ef, "k": cfg["k"], "reps": a.reps, "seed": a.seed,
        "device": (torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu"),
        "group_up_s": up_s,
        "setup_s_max": up_s + max(r["data_s"] + r["build_s"] + r["warm_s"]
                                  for r in every),
        "search_ms_median": every[0]["search_ms_median"],
        "ranks_equal": len({r["digest"] for r in every}) == 1,
        "recall_xhat_at_10": recall, "per_rank": every,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--queries", type=int, default=8192)
    ap.add_argument("--ef", type=int, default=64)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=2_147_483_713)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)
    if a.device == "cuda" and (not torch.cuda.is_available() or
                               torch.cuda.device_count() < a.ranks):
        print(f"probe: needs {a.ranks} CUDA devices", file=sys.stderr)
        return 2
    print(json.dumps(probe(a)), flush=True)
    return 0


if __name__ == "__main__":
    from portbench import probe_sharded
    sys.exit(probe_sharded.main())
