"""The rate sweep of an open-loop requests cell: one set-up, then one
window at each offered rate, to find the highest rate the system sustains
without a growing backlog (the cell's rate is then fixed at about four
fifths of it, in its traffic file).

    python3 portbench/sweep.py --workload <cell> --seed <n> \\
        --seconds <s> --rates 5000 10000 20000

For each rate prints one JSON line: the latency p50 / p95, the submit lag
(how late a due request was handed to the system) over the first and the
last quarter of the window, and how long past the window the last result
came. A backlog grows where the last quarter's lag is well above the
first's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import cells, manifest, traffic  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    man = manifest.load(ROOT)
    cell = manifest.cell(man, a.workload)
    cfg = manifest.config(man, cell["config"], ROOT)
    spec = traffic.load(cell["traffic"])
    t0 = time.time()
    serve = traffic.runner(spec["kind"])
    _, pool, idx, srv = serve.setup_serve(cfg, spec, a.seed, a.device)
    print(json.dumps({"setup_s": time.time() - t0}), flush=True)
    for rate in a.rates:
        req = traffic.requests(spec, a.seed, a.seconds, rate)
        s0 = dict(srv.stats)
        out = serve.serve_window(srv, pool, req)
        lat, lag = out.lat, out.lag
        q = max(len(lag) // 4, 1)
        st = cells.delta(srv.stats, s0)
        print(json.dumps({
            "rate_per_s": rate, "requests": len(req),
            "queries_per_s": float(req.rows.sum()) / a.seconds,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p95_ms": float(np.percentile(lat, 95)) * 1e3,
            "lag_first_ms": float(lag[:q].mean()) * 1e3,
            "lag_last_ms": float(lag[-q:].mean()) * 1e3,
            "drain_s": out.seconds - a.seconds,
            "rows_per_launch": st["queries_served"] / max(st["launches"], 1),
            "pad_share": st["rows_padded"] / max(
                st["rows_padded"] + st["queries_served"], 1)}), flush=True)
    del srv, idx
    return 0


if __name__ == "__main__":
    sys.exit(main())
