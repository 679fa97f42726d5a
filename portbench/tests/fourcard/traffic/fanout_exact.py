"""Runner of ``fanout_exact`` mixes: a four-card kind for the harness's
own tests, which shows what such a kind provides. Each rank holds every
``world``-th base row from its rank on, answers each batch with the exact
top-k over its rows (the reference's ``exact_topk``), the ranks exchange
their [2, batch, k] results with one ``all_gather``, and every rank merges
them; rank 0 keeps the merged answers, and the reference judges them as a
search cell's. A closed loop of ``batch``-query batches from a pool of
``pool_batches``, in an order drawn from the seed."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import cells, checks, ranks, reference, traffic
from portbench.trace import sync

TINY = dict(batch=64, pool_batches=2)
CONTROL_FAILS = ("dist_gap",)


def pool_rows(spec: dict) -> int:
    return spec["batch"] * spec["pool_batches"]


def setup(cfg, spec, seed, device):
    """(base, query batches, this rank's rows) on every rank alike."""
    base, queries = cells.host_data(cfg, pool_rows(spec), seed, device)
    b = spec["batch"]
    pool = [queries[j * b:(j + 1) * b] for j in range(spec["pool_batches"])]
    mine = torch.from_numpy(base[ranks.rank()::ranks.world()]).to(device)
    return base, queries, pool, mine


def local(mine, q, k, device):
    """This rank's exact top-k of ``q``, as global row ids."""
    ids, d = reference.exact_topk(torch.from_numpy(q).to(device), mine, k)
    return d, ids * ranks.world() + ranks.rank()


def exchange(d, ids):
    """Every rank's (D, I), [world, Q, k] each: one all_gather of
    [2, Q, k] float32, the ids' int32 bits riding as float32."""
    mine = torch.stack([d, ids.to(torch.int32).view(torch.float32)])
    out = [torch.empty_like(mine) for _ in range(ranks.world())]
    torch.distributed.all_gather(out, mine)
    got = torch.stack(out)
    return got[:, 0], got[:, 1].view(torch.int32).long()


def serve(mine, q, k, device):
    """One batch's merged answer (D, I) [Q, k], host arrays."""
    d, ids = exchange(*local(mine, q, k, device))
    d = d.permute(1, 0, 2).reshape(len(q), -1)
    ids = ids.permute(1, 0, 2).reshape(len(q), -1)
    d, o = torch.sort(d, dim=1, stable=True)
    return (d[:, :k].cpu().numpy(),
            torch.gather(ids, 1, o[:, :k]).cpu().numpy())


def drive(cell, cfg, spec, seed, seconds, trace, device, t_process):
    ctx, res = cells.Context(cell, cfg, spec), cells.Result()
    k, bsz = cfg["k"], spec["batch"]
    base, queries, pool, mine = setup(cfg, spec, seed, device)
    seen = [ranks.step(0)]
    serve(mine, pool[0], k, device)            # every shape, once
    perm = traffic.batch_order(spec["pool_batches"], seed,
                               spec["pool_batches"])
    answers, lat = checks.Answers(), []
    sync(device)
    t0 = time.perf_counter()
    res.e2e["setup_s"] = time.time() - t_process
    deadline, t_end, n = t0 + seconds, t0, 0
    while time.perf_counter() < deadline:
        t = time.perf_counter()
        j = int(perm[n % len(perm)])
        seen.append(ranks.step(j))
        d, ids = serve(mine, pool[j], k, device)
        t_end = time.perf_counter()
        lat.append(t_end - t)
        answers.add(j * bsz, d, ids)
        n += 1
    seen.append(ranks.step(-1))
    res.attempted = n
    res.e2e["qps"] = n * bsz / (t_end - t0)
    res.e2e["p95_ms"] = float(np.percentile(lat, 95)) * 1e3
    res.peak = ranks.fullest(device)
    every = ranks.gather(seen)
    ranks.leave()
    res.notes.append(f"units each rank saw: {[len(s) for s in every]}")
    if trace:
        ctx.counters.update(batches=n, gathered_rows=n * ranks.world()
                            * bsz * k)
    del mine
    cells.free(device)
    cells.judge_search(res, cfg, base, queries, answers, seed, device)
    res.verdict.add("ranks_apart", sum(s != seen for s in every), "<=", 0)
    return res, ctx, None


def follow(cell, cfg, spec, seed, seconds, trace, device):
    _, _, pool, mine = setup(cfg, spec, seed, device)
    seen = []
    while True:
        j = ranks.step()
        seen.append(j)
        if j < 0:
            break
        serve(mine, pool[j], cfg["k"], device)
    ranks.fullest(device)
    ranks.gather(seen)


def control(cfg, spec, seed, device, **_):
    """The verdict on the reference in the program's place, its operands
    rounded to TF32: every batch of the pool answered with the exact top-k
    over all the rows."""
    base, queries = cells.host_data(cfg, pool_rows(spec), seed, device)
    ids, d = reference.control_topk(cfg, base, queries, device)
    answers = checks.Answers()
    answers.add(0, d, ids)
    res = cells.Result()
    cells.judge_search(res, cfg, base, queries, answers, seed, device)
    return res.verdict


# the faults a fan-out can have, planted on every rank (``ranks.PLANTS``)
def exchange_left_out(setattr):
    """Each rank merges its own results alone."""
    setattr(_self(), "exchange", lambda d, ids: (d[None], ids[None]))


def stale(setattr):
    """Every batch answered with the first answer."""
    real, first = _self().serve, []

    def serve(mine, q, k, device):
        if not first:
            first.append(real(mine, q, k, device))
        return first[0]
    setattr(_self(), "serve", serve)


def half(setattr):
    """The second half of each batch answered with the first half's."""
    real = _self().serve

    def serve(mine, q, k, device):
        d, ids = real(mine, q[:len(q) // 2], k, device)
        return np.concatenate([d, d]), np.concatenate([ids, ids])
    setattr(_self(), "serve", serve)


def altered(setattr):
    """One id of each answer replaced where it is produced."""
    real = _self().local

    def local(mine, q, k, device):
        d, ids = real(mine, q, k, device)
        ids = ids.clone()
        ids[:, 0] += ranks.world()
        return d, ids
    setattr(_self(), "local", local)


def _self():
    import sys
    return sys.modules[__name__]


FAULTS = {"exchange_left_out": exchange_left_out, "stale": stale,
          "half": half, "altered": altered}
