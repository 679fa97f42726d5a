"""One run of one cell: set-up, the measured window, the check.

``run_cell`` takes a configuration and a traffic mix (as their files hold
them) and hands them to the runner the mix's ``kind`` names
(``traffic/<kind>.py``), which drives the system. A cell on more than one
card runs one process a card: ``ranks.launched`` starts the other ranks,
which run the runner's ``follow()``, before set-up, and the result line
gives the cell's card count and the fullest card's peak. The window
opens once set-up is done: data made, the index built (search cells),
every shape the traffic uses run once, so that every capture is made and
every kernel built. The window's end-to-end numbers are taken over all of
its work and all of its time. With ``trace`` the run keeps the program's
counters and profiles a part of the window (``trace.Window``); the
per-layer readers (``metrics/<name>.py``) take their numbers from those.

Once the window has closed the device's peak memory is read, the program's
outputs are copied out and its state is freed; then the reference
(``reference.py``, ``checks.py``) judges the outputs.
"""

from __future__ import annotations

import gc
import importlib.util
from pathlib import Path

import numpy as np
import torch

from . import checks, data, ranks, reference, system, traffic

METRICS_DIR = Path(__file__).resolve().parent / "metrics"
DIST_SAMPLE_ROWS = 1 << 17    # answered query rows whose distances are held


class Context:
    """What a per-layer reader reads: the cell, its configuration and
    traffic, the program's counters over the window and the trace's
    summary (None without ``--trace 1``)."""

    def __init__(self, cell: str, cfg: dict, spec: dict):
        self.cell, self.cfg, self.spec = cell, cfg, spec
        self.counters: dict = {}
        self.trace = None


class Result:
    def __init__(self):
        self.e2e: dict = {}
        self.attempted = 0
        self.failed = 0
        self.peak = 0
        self.verdict = checks.Verdict()
        self.notes: list[str] = []


def read_metric(name: str, ctx: Context):
    """Per-layer metric ``name`` from its reader, or None."""
    path = METRICS_DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def host_data(cfg: dict, n_queries: int, seed: int, device):
    """The configuration's data for ``seed`` as host arrays (the program
    takes numpy), the device copies dropped."""
    base, queries = data.make(cfg, n_queries, seed, device)
    out = base.cpu().numpy(), queries.cpu().numpy()
    del base, queries
    return out


def trace_start(spec: dict, seconds: float) -> tuple[float, float]:
    """(start in seconds into the window, length) of the traced part."""
    return seconds / 3, min(float(spec.get("trace_seconds", 1.0)),
                            seconds / 2)


def setup_search(cfg, spec, seed, device):
    """(base, query pool, index) of a search cell: the data for the
    seed, and the configuration's index built over it."""
    base, queries = host_data(cfg, traffic.runner(spec["kind"]).pool_rows(
        spec), seed, device)
    idx = system.build(cfg, base, device)
    return base, queries, idx


def judge_search(res: Result, cfg: dict, base: np.ndarray,
                 queries: np.ndarray, answers: checks.Answers, seed: int,
                 device) -> None:
    """The reference over the answers: recall@k of every answered query
    against the exact top-k over the f32 vectors (the end-to-end
    ``recall_at_10``; for sq8 storage also against the exact top-k over
    x̂, re-derived here, which the configuration's guarantee is stated
    on), every returned entry a valid and distinct id, and the distances
    of a sample of the answers against the stored rows (f32, or x̂)."""
    lim = cfg["limits"]
    k = cfg["k"]
    xb = torch.from_numpy(base).to(device)
    xq = torch.from_numpy(queries).to(device)
    truth, _ = reference.exact_topk(xq, xb, k)
    recall, bad = checks.recall_and_bad(answers, truth, len(xb))
    res.e2e["recall_at_10"] = recall
    del truth
    if cfg["dtype"] == "sq8":
        xb = reference.stored_rows(cfg, xb)
        truth, _ = reference.exact_topk(xq, xb, k)
        res.e2e["recall_xhat_at_10"], _ = checks.recall_and_bad(
            answers, truth, len(xb))
        del truth
    gen = traffic.rng(seed, 3)
    which = checks.sample_answers(len(answers),
                                  lambda a: len(answers.i[a]),
                                  DIST_SAMPLE_ROWS, gen)
    gap = checks.dist_gap(answers, which, xq, xb)
    for name in ("recall_at_10", "recall_xhat_at_10"):
        if name in lim:
            res.verdict.add(name, res.e2e[name], ">=", lim[name])
    res.verdict.add("dist_gap", gap, "<=", lim["dist_gap"])
    res.verdict.add("bad_ids", bad, "<=", 0)
    res.verdict.add("unanswered", res.failed, "<=", 0)


def delta(now: dict, before: dict) -> dict:
    return {key: v - before.get(key, 0) for key, v in now.items()}


def run_cell(cell: str, cfg: dict, spec: dict, seed: int, seconds: float,
             trace: bool, device, t_process: float, e2e_names, layer_names,
             chips: int = 1):
    """(result line as a dict, lines for standard error) of one run on
    ``chips`` cards (``ranks.RankFailure`` where a rank fails)."""
    drive = traffic.runner(spec["kind"]).drive
    if chips == 1:
        res, ctx, win = drive(cell, cfg, spec, seed, seconds, trace, device,
                              t_process)
    else:
        with ranks.launched(cell, cfg, spec, seed, seconds, trace, device,
                            chips) as device:
            res, ctx, win = drive(cell, cfg, spec, seed, seconds, trace,
                                  device, t_process)
    dev = torch.device(device)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "count": chips, "memory_peak_bytes": res.peak}
    out = {"correct": res.verdict.correct and res.failed == 0,
           "attempted": res.attempted, "failed": res.failed}
    if trace:
        ctx.trace = win.reduce() if win is not None and win.window_s \
            else None
        metrics = {}
        for m in layer_names:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        out["metrics"] = metrics
        if ctx.trace is not None:
            device_info["busy_s"] = ctx.trace.busy_s
            device_info["window_s"] = ctx.trace.window_s
        out["device"] = device_info
        if ctx.trace is not None:
            out["breakdown"] = ctx.trace.breakdown()
    else:
        missing = [m["name"] for m in e2e_names if m["name"] not in res.e2e]
        if missing:
            raise RuntimeError(f"{cell}: no reading of {missing}")
        out["metrics"] = {m["name"]: {"value": float(res.e2e[m["name"]]),
                                      "unit": m["unit"]}
                          for m in e2e_names}
        out["device"] = device_info
    out["checks"] = res.verdict.as_json()
    return out, res.notes + res.verdict.lines()
