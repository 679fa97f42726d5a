"""Eager and captured build walls of chip_smoke.py's three full-size builds.

    python3 scripts/torch_build_walls.py [--reps 3] [--eager-reps 1]
        [--configs a,f,l1]

On one CUDA card, for each configuration builds the index
``--eager-reps`` times with every insert batch run eagerly
(``graphs.eager()``, the plain version of a replay), then ``--reps`` times
as the port builds on a card (each batch profile captured once as a CUDA
graph and replayed). Each wall is synced; every build is held to the
first eager one array for array (graph arrays, scalars, vectors).
The configurations are chip_smoke.py's:

  a   f32 1,000,000 x 128 (``synthetic_workload(1_000_000, 128,
      seed=1234)``), M=32, efConstruction=100 (phase a);
  f   sq8 1,000,000 x 96 (``synthetic_workload(1_000_000, 96,
      seed=1234)``), trained on the first 262,144 (phase f);
  l1  the f32 workload of a as ``ShardedHnswIndex`` 4 x 250,000 on
      ``[card] * 4`` (phase l1).

Prints per build its wall, host reads, batches, replays and captures, and
peak device memory; per configuration the median and range of each form,
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def log(msg: str) -> None:
    print(msg, flush=True)


def make(config: str, dev, wl):
    from hnsw_tpu_torch import HnswIndex, ShardedHnswIndex, make_mesh
    if config == "a":
        return HnswIndex(128, 32, "l2", capacity=len(wl.base),
                         ef_construction=100, device=dev)
    if config == "f":
        idx = HnswIndex(96, 32, "l2", capacity=len(wl.base),
                        ef_construction=100, dtype="sq8", device=dev)
        idx.train(wl.base[:262144])
        return idx
    return ShardedHnswIndex(128, 32, "l2",
                            mesh=make_mesh(4, devices=[dev] * 4),
                            capacity_per_shard=len(wl.base) // 4,
                            ef_construction=100)


def arrays(idx) -> list:
    """Every graph tensor, scalar and stored row of ``idx``."""
    from hnsw_tpu_torch.graph import SCALAR_FIELDS, TENSOR_FIELDS
    graphs = getattr(idx, "_graphs", None) or [idx._graph]
    stores = idx._storage if isinstance(idx._storage, list) \
        else [idx._storage]
    vecs = [st.rows for st in stores]
    out = []
    for g, v in zip(graphs, vecs):
        out += [getattr(g, f) for f in TENSOR_FIELDS]
        out += [getattr(g, f) for f in SCALAR_FIELDS] + [v]
    return out


def same(a: list, b: list) -> bool:
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(a, b))


def stats_of(idx) -> dict:
    if hasattr(idx, "last_build_stats"):
        st = [s for s in idx.last_build_stats if s is not None]
        return {k: sum(s.get(k, 0) for s in st)
                for k in ("batches", "replayed", "eager", "captured")}
    return idx._builder.last_stats


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--eager-reps", type=int, default=1)
    ap.add_argument("--configs", default="a,f,l1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_build_walls: CUDA is not available")
    import hnsw_tpu_torch  # noqa: F401  (exact-f32 matmul precision)
    from hnsw_tpu_torch import graphs, synthetic_workload, trace
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}")

    def host_reads() -> int:
        return trace.totals().counters.get("host_reads", 0)

    dev = torch.device("cuda:0")
    for config in args.configs.split(","):
        d = 96 if config == "f" else 128
        wl = synthetic_workload(1_000_000, d, n_queries=1, seed=1234)
        walls = {"eager": [], "captured": []}
        want = None
        for eager in [True] * args.eager_reps + [False] * args.reps:
            form = "eager" if eager else "captured"
            idx = make(config, dev, wl)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            r0 = host_reads()
            t = time.time()
            with graphs.eager() if eager else contextlib.nullcontext():
                idx.add(wl.base)
            torch.cuda.synchronize()
            wall = time.time() - t
            walls[form].append(wall)
            got = arrays(idx)
            if want is None:
                want = [x.clone() if isinstance(x, torch.Tensor) else x
                        for x in got]
                equal = "the reference build"
            else:
                equal = same(got, want)
                if not equal:
                    raise AssertionError(f"{config}: a {form} build differs "
                                         f"from the first eager build")
            log(f"{config} {form}: {wall:.2f} s, host reads "
                f"{host_reads() - r0}, {stats_of(idx)}, peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, equal to "
                f"the first eager build: {equal}")
            del idx, got
            torch.cuda.empty_cache()
        for form, w in walls.items():
            if w:
                log(f"{config} {form} walls: median {np.median(w):.2f} s "
                    f"(range {min(w):.2f}-{max(w):.2f}) over {len(w)}; "
                    f"{card}")
        del want, wl
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
