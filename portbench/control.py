"""The control of ``correct``: the plain reference put in the program's
place, computed one precision below the configuration's float32 (its
operands rounded to TF32, ``reference.tf32``), and judged by the same
comparison as a run's outputs. It has to come out as not correct.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \\
        [--rows N] [--seconds S]

Each traffic kind's runner (``traffic/<kind>.py``) has its ``control()``.
For a search cell it answers every query of the cell's pool (a batch cell)
or every request of a window's schedule (``--seconds``, a requests cell)
with the exact top-k by TF32 distances over the stored rows (x̂ for sq8),
and returns those distances. For the ingest cell it stores the first
``--rows`` vectors (as many as a run adds) rounded to TF32, and answers
the check queries over them the same way. Prints each seed's
numbers beside the cell's limits, and exits 0 when every seed's control
comes out not correct. Needs no program: it runs on the reference alone.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import manifest, traffic  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--rows", type=int, default=150_000)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    man = manifest.load(ROOT)
    cell = manifest.cell(man, a.workload)
    cfg = manifest.config(man, cell["config"], ROOT)
    spec = traffic.load(cell["traffic"])
    failed_all = True
    for seed in a.seeds:
        v = traffic.runner(spec["kind"]).control(
            cfg, spec, seed, a.device, rows=a.rows, seconds=a.seconds)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control_correct": v.correct,
                          "checks": v.as_json()}), flush=True)
        failed_all &= not v.correct
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
