"""Runner of ``fanout_batches`` mixes: a corpus sharded over the cards, one
shard a rank (``hnsw_tpu_torch.parallel.sharded.ShardedHnswIndex`` under
the run's ``torch.distributed`` group), fed by one client on rank 0 in a
closed loop: batches of ``batch`` queries back to back, each after the
last returned, cycling a pool of ``pool_batches`` distinct batches in an
order drawn from the seed. Every batch goes to every rank: rank 0 hands
out each unit with ``ranks.step`` and every rank makes the same
``search`` call, which searches the rank's own shard, gathers every
shard's top-k with one ``all_gather`` and merges them on every rank.
Reads ``batch``, ``pool_batches`` and ``trace_seconds``; the
configuration gives ``shards`` (one a rank) and ``capacity_per_shard``.

A traced run profiles every card over the same part of the window (rank 0
hands out its start and its end as units); each rank reduces its own
trace, and the window returned averages the ranks' ``Summary``s. The
per-layer readers take each rank's program table (spans, device phase
times, counters) from the window's start on, gathered to rank 0.

``correct`` adds to a search cell's checks ``rank_gap``: the rows in which
any rank's last answer differs from rank 0's."""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench import cells, checks, ranks, reference, spans, traffic
from portbench.trace import Summary, Window, span, sync

# the cuts of a tiny run on the CPU (the tests' ``pb_tiny``)
TINY = dict(batch=128, pool_batches=2, trace_seconds=0.3)
CONTROL_FAILS = ("dist_gap",)     # what the control has to fail
WARM = 3                          # searches before the window: capture,
#                                   then replays
START, STOP = -2, -3              # units: the traced part starts, ends


def pool_rows(spec: dict) -> int:
    return spec["batch"] * spec["pool_batches"]


def shard_capacity(cfg: dict) -> int:
    """Rows a shard holds: ``capacity_per_shard``, or the configuration's
    ``capacity`` over its shards where that is less (a tiny run cuts the
    capacity)."""
    return min(cfg["capacity_per_shard"], -(-cfg["capacity"] // cfg["shards"]))


def build(cfg: dict, base: np.ndarray, device):
    """The configuration's sharded index over ``base`` on every rank alike:
    one shard a rank, the sq8 quantizer trained on the first
    ``sq_train_rows`` rows (where shard 0 lives, for every rank), one
    ``add()`` of the whole corpus (each rank inserts its own shard)."""
    from hnsw_tpu_torch.parallel.sharded import ShardedHnswIndex, make_mesh
    if ranks.world() != cfg["shards"]:
        raise ValueError(f"{cfg['shards']} shards need as many ranks, got "
                         f"{ranks.world()}")
    idx = ShardedHnswIndex(
        cfg["d"], cfg["m"], cfg["metric"],
        mesh=make_mesh(cfg["shards"], 1, devices=[device]),
        capacity_per_shard=shard_capacity(cfg), m0=cfg["m0"],
        ef_construction=cfg["ef_construction"], ef_search=cfg["ef_search"],
        dtype=cfg["dtype"])
    if cfg["dtype"] == "sq8":
        idx.train(base[:cfg["sq_train_rows"]])
    idx.add(base)
    return idx


def setup(cfg, spec, seed, device):
    """(base, queries, query batches, index) on every rank alike."""
    base, queries = cells.host_data(cfg, pool_rows(spec), seed, device)
    b = spec["batch"]
    pool = [queries[j * b:(j + 1) * b] for j in range(spec["pool_batches"])]
    return base, queries, pool, build(cfg, base, device)


def serve(idx, q: np.ndarray, k: int, ef: int):
    """One batch's merged answer (D, I), host arrays: the same call on
    every rank."""
    return idx.search(q, k, ef_search=ef)


def captures():
    """The program's count of search captures in this process so far
    (``captures.search``), or None where it keeps no such counter."""
    t = spans.totals()
    return None if t is None else t.counters.get("captures.search", 0)


def warm(idx, pool, k, ef, lead: bool):
    """``WARM`` searches of the pool's first batch, each a unit: the
    capture, then replays. Every batch of the window has that batch's
    shapes, so a warm search after the first that captures anew means the
    program would compile inside the window on every search: the run
    fails then, before the window opens. Returns the last answer."""
    seen = None
    for i in range(WARM):
        if i == 1:
            seen = captures()
        ranks.step(0) if lead else ranks.step()
        out = serve(idx, pool[0], k, ef)
    now = captures()
    if seen is not None and now > seen:
        raise RuntimeError(
            f"rank {ranks.rank()}: {now - seen} of the last {WARM - 1} warm "
            "searches captured anew; this program cannot run the cell "
            "without compiling inside the measured window")
    return out


def wrap_up(win, before, last, device) -> tuple:
    """What every rank does once the window has closed, in the same order:
    its traced part ended and reduced, the fullest card's peak, and every
    rank's (last answer, program table since the window opened, trace
    summary) gathered. Returns (peak, every rank's dict)."""
    if win is not None and win.active:
        win.stop()
    summ = win.reduce() if win is not None and win.window_s else None
    peak = ranks.fullest(device)
    now = spans.totals()
    table = None if now is None or before is None else now.minus(before)
    mine = {"last": last,
            "device": None if table is None else table.device,
            "counters": None if table is None else table.counters,
            "summary": None if summ is None else
            (summ.window_s, summ.busy_s, summ.ops, summ.gaps)}
    return peak, ranks.gather(mine)


class Averaged:
    """The ranks' traced windows as one (``cells.run_cell`` reduces it):
    window and busy seconds, device time by op and idle time by label,
    each the mean over the ranks."""

    def __init__(self, parts: list):
        self.parts = [p for p in parts if p is not None]
        self.window_s = float(np.mean([p[0] for p in self.parts])) \
            if self.parts else 0.0

    def reduce(self) -> Summary:
        n = len(self.parts)

        def mean(i):
            out = {}
            for p in self.parts:
                for key, v in p[i].items():
                    out[key] = out.get(key, 0.0) + v / n
            return out
        return Summary(self.window_s,
                       float(np.mean([p[1] for p in self.parts])),
                       mean(2), mean(3))


def rank_gap(every: list) -> int:
    """Rows in which any rank's last (D, I) differs from rank 0's, bit for
    bit (all of them where a shape differs)."""
    d0, i0 = every[0]["last"]
    apart = np.zeros(len(i0), bool)
    for r in every[1:]:
        d, i = r["last"]
        if d.shape != d0.shape or i.shape != i0.shape:
            return len(i0)
        apart |= (i != i0).any(1) | (np.ascontiguousarray(d).view(np.uint32)
                                     != np.ascontiguousarray(d0).view(
                                         np.uint32)).any(1)
    return int(apart.sum())


def drive(cell, cfg, spec, seed, seconds, trace, device, t_process):
    ctx, res = cells.Context(cell, cfg, spec), cells.Result()
    k, ef, bsz = cfg["k"], cfg["ef_search"], spec["batch"]
    base, queries, pool, idx = setup(cfg, spec, seed, device)
    last = warm(idx, pool, k, ef, True)
    perm = traffic.batch_order(spec["pool_batches"], seed,
                               spec["pool_batches"])
    win = Window(device) if trace else None
    if win is not None:
        win.warm()
    t_on, t_len = cells.trace_start(spec, seconds)
    before = spans.totals()
    answers, lat = checks.Answers(), []
    n = 0
    sync(device)
    t0 = time.perf_counter()
    res.e2e["setup_s"] = time.time() - t_process
    deadline = t0 + seconds
    t_end = t0
    while True:
        t = time.perf_counter()
        if t >= deadline:
            break
        if win is not None:
            if win.pending and t - t0 >= t_on:
                ranks.step(START)
                win.start()
            elif win.active and win.elapsed() >= t_len:
                ranks.step(STOP)
                win.stop()
        j = int(perm[n % len(perm)])
        with span("portbench.search"):
            ranks.step(j)
            last = serve(idx, pool[j], k, ef)
        t_end = time.perf_counter()
        lat.append(t_end - t)
        answers.add(j * bsz, *last)
        n += 1
    ranks.step(-1)
    res.attempted = n
    res.e2e["qps"] = n * bsz / (t_end - t0)
    res.e2e["p95_ms"] = float(np.percentile(lat, 95)) * 1e3
    res.notes.append(f"{n} batches of {bsz} in {t_end - t0:.3f} s on "
                     f"{ranks.world()} ranks; p50 "
                     f"{np.percentile(lat, 50) * 1e3:.3f} ms")
    res.peak, every = wrap_up(win, before, last, device)
    ranks.leave()
    gap = rank_gap(every)
    if trace:
        ctx.counters.update(batches=n, queries=n * bsz, shard=every)
    del idx
    cells.free(device)
    cells.judge_search(res, cfg, base, queries, answers, seed, device)
    res.verdict.add("rank_gap", gap, "<=", cfg["limits"]["rank_gap"])
    return res, ctx, None if win is None else Averaged(
        [r["summary"] for r in every])


def follow(cell, cfg, spec, seed, seconds, trace, device):
    k, ef = cfg["k"], cfg["ef_search"]
    _, _, pool, idx = setup(cfg, spec, seed, device)
    last = warm(idx, pool, k, ef, False)
    win = Window(device) if trace else None
    if win is not None:
        win.warm()
    before = spans.totals()
    while True:
        j = ranks.step()
        if j == -1:
            break
        if j == START:
            win.start()
        elif j == STOP:
            win.stop()
        else:
            last = serve(idx, pool[j], k, ef)
    wrap_up(win, before, last, device)


def control(cfg, spec, seed, device, **_):
    """The verdict on the reference in the program's place, its operands
    rounded to TF32: every batch of the pool answered with the exact top-k
    over the stored rows of the whole corpus (rank 0 alone)."""
    base, queries = cells.host_data(cfg, pool_rows(spec), seed, device)
    ids, d = reference.control_topk(cfg, base, queries, device)
    answers = checks.Answers()
    b = spec["batch"]
    for j in range(spec["pool_batches"]):
        answers.add(j * b, d[j * b:(j + 1) * b], ids[j * b:(j + 1) * b])
    res = cells.Result()
    cells.judge_search(res, cfg, base, queries, answers, seed, device)
    return res.verdict


# the faults a fan-out can have, planted on every rank (``ranks.PLANTS``)
def stale(setattr):
    """The search answers every batch with its first answer."""
    real, first = _self().serve, []

    def serve(idx, q, k, ef):
        if not first:
            first.append(real(idx, q, k, ef))
        return first[0]
    setattr(_self(), "serve", serve)


def shard_left_out(setattr):
    """The last shard's part is left out of every merge."""
    from hnsw_tpu_torch.parallel import sharded
    real = sharded.merge_topk
    setattr(sharded, "merge_topk",
            lambda dists, ids, k: real(dists[:-1], ids[:-1], k))


def exchange_left_out(setattr):
    """The ``all_gather`` is skipped: each rank merges its own shard
    alone."""
    from hnsw_tpu_torch.parallel.sharded import ShardedHnswIndex
    setattr(ShardedHnswIndex, "_gather_parts",
            lambda self, parts, n, k: parts)


def altered(setattr):
    """One id of each answer replaced by another id, its distance kept."""
    real = _self().serve

    def serve(idx, q, k, ef):
        d, i = real(idx, q, k, ef)
        i = i.copy()
        i[:, 0] = (i[:, 0] + 1) % idx.ntotal
        return d, i
    setattr(_self(), "serve", serve)


def _self():
    return sys.modules[__name__]


FAULTS = {"stale": stale, "shard_left_out": shard_left_out,
          "exchange_left_out": exchange_left_out, "altered": altered}
