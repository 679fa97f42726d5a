"""Tiny configurations and traffic of the benchmark's cells, for CPU tests:
the cells' own files with the scale cut (n, d, m, capacity; each runner's
``TINY`` cuts of its mixes: batch sizes, rates), every other key as the
files hold it."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import cells, manifest, traffic  # noqa: E402

MAN = manifest.load(ROOT)
SEED = 2_147_483_659      # past 2**31


def tiny_config(name: str) -> dict:
    c = manifest.config(MAN, name, ROOT)
    c.update(n=2000, d=16, m=8, m0=16, capacity=2000, ef_construction=40)
    if c["dtype"] == "sq8":
        c["sq_train_rows"] = 1000
    c["data"] = dict(c["data"], n_clusters=None)
    return c


def tiny_traffic(name: str) -> dict:
    spec = traffic.load(name)
    spec.update(traffic.runner(spec["kind"]).TINY)
    return spec


def runner(cell_name: str):
    """The runner of the cell's traffic kind."""
    cell = manifest.cell(MAN, cell_name)
    return traffic.runner(traffic.load(cell["traffic"])["kind"])


def run(cell_name: str, *, trace: bool = False, seconds: float = 1.0,
        seed: int = SEED):
    """(result line, stderr lines) of a tiny run of the cell on the CPU."""
    torch.set_num_threads(1)
    cell = manifest.cell(MAN, cell_name)
    return cells.run_cell(
        cell_name, tiny_config(cell["config"]), tiny_traffic(cell["traffic"]),
        seed, seconds, trace, "cpu", time.time(),
        manifest.metrics_for(MAN, "end_to_end", cell_name),
        manifest.metrics_for(MAN, "per_layer", cell_name),
        chips=cell["chips"])


CELLS = [w["name"] for w in MAN["workloads"]]
