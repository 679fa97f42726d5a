"""portbench: the benchmark of ``hnsw_tpu_torch`` (the PyTorch and CUDA port)
on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell (``workloads`` in
``BENCHMARK.json``) names a configuration (``portbench/configs/``) and a
traffic mix (``portbench/traffic/``). One run is one process a card (a
four-card cell's rank 0 starts the other three, ``portbench/ranks.py``):
it makes the data from the seed, sets up, measures for ``--seconds``,
judges what the window produced against the plain reference, and prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit
(also the last lines of standard error).

Exits with another code than 0, and prints no result, without as many
CUDA devices as the cell asks for, if a process of the run has loaded JAX
or the JAX package, or if a rank fails (3; its last lines end standard
error).
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one host thread for the libraries' own pools: a run is one process with
# few threads, so its host time is steady
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench_cache"
# every build and kernel cache at a fixed place inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(CACHE / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.ranks import loaded_forbidden  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import cells, manifest, ranks, traffic
    man = manifest.load(ROOT)
    cell = manifest.cell(man, args.workload)
    cfg = manifest.config(man, cell["config"], ROOT)
    spec = traffic.load(cell["traffic"])
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        out, lines = cells.run_cell(
            cell["name"], cfg, spec, args.seed, args.seconds,
            bool(args.trace), "cuda", T_PROCESS,
            manifest.metrics_for(man, "end_to_end", cell["name"]),
            manifest.metrics_for(man, "per_layer", cell["name"]),
            chips=cell["chips"])
    except ranks.RankFailure as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
