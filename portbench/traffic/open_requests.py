"""Runner of ``open_requests`` mixes: requests arrive on a schedule that
does not wait for the system (``traffic.requests``: ``rate_per_s``,
``arrivals``, ``sizes``, ``pool_queries``); each turn of the serving loop
submits every request now due to one ``Searcher``, flushes, and hands the
results back. Latency is taken from the moment a request was due. Reads
``trace_seconds`` too."""

from __future__ import annotations

import time

import numpy as np

from portbench import cells, checks, faults, reference, system, traffic
from portbench.trace import Window, span, sync

# the cuts of a tiny run on the CPU (the tests' ``pb_tiny``)
TINY = dict(rate_per_s=4000, pool_queries=512, trace_seconds=0.3)
FAULTS = faults.SEARCH
CONTROL_FAILS = ("dist_gap",)     # what the control has to fail

WARM_ROWS = (512, 1024, 2048, 4096, 8192)   # every search size a flush makes


def pool_rows(spec: dict) -> int:
    return spec["pool_queries"]


def setup_serve(cfg, spec, seed, device):
    """The index, its ``Searcher`` and the query pool; every capture the
    serving layer's size buckets can ask for made (each bucket's search
    pads its rows to a multiple of 512)."""
    base, pool, idx = cells.setup_search(cfg, spec, seed, device)
    srv = system.searcher(idx, cfg["k"], cfg["ef_search"])
    for rows in WARM_ROWS:
        if rows <= srv.max_bucket:
            for _ in range(2):
                srv.search(pool[:rows])
    return base, pool, idx, srv


class Served:
    """What a window of requests gave: the answers, each request's latency
    and submit lag (seconds), the seconds to the last result, and the
    serving layer's counters when the traced part began (None without
    one)."""

    def __init__(self, n: int):
        self.answers = checks.Answers()
        self.lat = np.zeros(n)
        self.lag = np.zeros(n)
        self.seconds = 0.0
        self.stats_at_trace = None


def serve_window(srv, pool, req, win=None, t_on=0.0, t_len=0.0) -> Served:
    """Drive ``srv`` with the open-loop schedule ``req``, tracing from
    ``t_on`` for ``t_len`` seconds with ``win``."""
    out = Served(len(req))
    lat, lag = out.lat, out.lag
    i, due = 0, req.due
    t0 = time.perf_counter()
    t_end = t0
    while i < len(req):
        now = time.perf_counter() - t0
        if win is not None:
            if win.pending and now >= t_on:
                out.stats_at_trace = dict(srv.stats)
                win.start()
            elif win.active and win.elapsed() >= t_len:
                win.stop()
        if due[i] > now:
            with span("portbench.wait"):
                wait = due[i] - now
                if wait > 2e-3:
                    time.sleep(wait - 1e-3)
                while time.perf_counter() - t0 < due[i]:
                    pass
            continue
        j = int(np.searchsorted(due, now, side="right"))
        with span("portbench.submit"):
            hs = [srv.submit(pool[s:s + r])
                  for s, r in zip(req.start[i:j], req.rows[i:j])]
        lag[i:j] = now - due[i:j]
        with span("portbench.flush"):
            srv.flush()
        with span("portbench.result"):
            for r, h in zip(range(i, j), hs):
                d, ids = srv.result(h)
                out.answers.add(req.start[r], d, ids)
        t_end = time.perf_counter()
        lat[i:j] = (t_end - t0) - due[i:j]
        i = j
    if win is not None and win.active:
        win.stop()
    out.seconds = t_end - t0
    return out


def serve_note(req, served: Served, seconds) -> str:
    lat, lag = served.lat, served.lag
    q = len(lat) // 4
    if not q:
        return "no requests"
    return (f"{len(req)} requests ({int(req.rows.sum())} queries) due in "
            f"{seconds} s, served by {served.seconds:.3f} s; latency p50 "
            f"{np.percentile(lat, 50) * 1e3:.3f} ms, p95 "
            f"{np.percentile(lat, 95) * 1e3:.3f} ms; submit lag p95 "
            f"{np.percentile(lag, 95) * 1e3:.3f} ms, mean over the first "
            f"and last quarter {lag[:q].mean() * 1e3:.3f} / "
            f"{lag[-q:].mean() * 1e3:.3f} ms")


def drive(cell, cfg, spec, seed, seconds, trace, device, t_process):
    """One run. The serving counters (``ctx.counters["serve"]``) cover the
    window up to the start of its traced part, so that they read the
    cell's own load and not the backlog the profiler's cost makes."""
    ctx, res = cells.Context(cell, cfg, spec), cells.Result()
    base, pool, idx, srv = setup_serve(cfg, spec, seed, device)
    req = traffic.requests(spec, seed, seconds)
    win = Window(device) if trace else None
    if win is not None:
        win.warm()
    t_on, t_len = cells.trace_start(spec, seconds)
    s0 = dict(srv.stats)
    sync(device)
    res.e2e["setup_s"] = time.time() - t_process
    served = serve_window(srv, pool, req, win, t_on, t_len)
    res.attempted = len(req)
    res.e2e["p95_ms"] = float(np.percentile(served.lat, 95)) * 1e3
    res.notes.append(serve_note(req, served, seconds))
    res.peak = cells.peak(device)
    ctx.counters["serve"] = cells.delta(
        served.stats_at_trace or srv.stats, s0)
    del srv, idx
    cells.free(device)
    cells.judge_search(res, cfg, base, pool, served.answers, seed, device)
    return res, ctx, win


def control(cfg, spec, seed, device, seconds=10.0, **_):
    """The verdict on the reference in the program's place, its operands
    rounded to TF32: every request of a window of ``seconds`` answered
    with the exact top-k over the stored rows."""
    base, pool = cells.host_data(cfg, pool_rows(spec), seed, device)
    ids, d = reference.control_topk(cfg, base, pool, device)
    answers = checks.Answers()
    req = traffic.requests(spec, seed, seconds)
    for s, r in zip(req.start, req.rows):
        answers.add(s, d[s:s + r], ids[s:s + r])
    res = cells.Result()
    cells.judge_search(res, cfg, base, pool, answers, seed, device)
    return res.verdict
