"""The one traffic generator. A traffic mix is a data file,
``traffic/<name>.json``, of parameters that this module reads. Its
``kind`` names the runner that runs the mix against the system:
``traffic/<kind>.py``, found by that name. A new kind is a new runner
file; a new mix of a kind is a new data file.

Every runner has:

  * ``drive(cell, cfg, spec, seed, seconds, trace, device, t_process)``:
    one run of a cell, returning (``cells.Result``, ``cells.Context``, the
    trace's window or None);
  * ``control(cfg, spec, seed, device, **kw)``: the verdict on the
    reference in the program's place, and ``CONTROL_FAILS``, the numbers
    it has to fail;
  * ``TINY``: the mix's cuts for a tiny run on the CPU (the tests);
  * ``FAULTS``: ``{name: plant}``, the faults its cells can have
    (``faults.py``);
  * a search kind, ``pool_rows(spec)``: the queries the mix draws from.

A one-card kind's ``drive()`` is the whole run. A four-card kind (a cell
with ``"chips": 4``) runs one process a card (``ranks.py``): its
``drive()`` runs on rank 0 once the group is up, with the device
``cuda:0``; ``follow(cell, cfg, spec, seed, seconds, trace, device)``
runs on ranks 1-3, each on ``cuda:<rank>``, with the same dicts; every
rank makes the same calls in the same order, rank 0 handing out each unit
of work with ``ranks.step(j)`` and the followers taking it with
``ranks.step()`` until it reads -1; ``drive()`` sets ``Result.peak`` from
``ranks.fullest(device)`` in the window's wake, then calls
``ranks.leave()`` after its last collective and before the reference
runs (a follower leaves when ``follow()`` returns), and ``control()`` runs
on rank 0 alone.

Open-loop requests (``requests``) read these parameters:

  * ``rate_per_s``: requests offered a second, on a schedule that does not
    wait for the system;
  * ``arrivals``: ``{"cv": c}``, the arrivals a renewal process whose gaps
    are gamma-distributed with coefficient of variation ``c``: 1 is a
    Poisson process, above 1 bursts and lulls;
  * ``sizes``: ``[[min_rows, max_rows, weight], ...]``, each request's
    number of queries drawn from a group by weight, then uniform over the
    group's range;
  * ``pool_queries``: each request's queries are consecutive rows of a
    pool of that many.

Every seed gets the same amount of work: the same number of arrivals and
the same multiset of request sizes (drawn from a fixed stream), in an
order and at times drawn from the seed.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np

DIR = Path(__file__).resolve().parent / "traffic"
FIXED = 20_240_917        # the stream every seed's set of sizes comes from
KIND = re.compile(r"[A-Za-z_][A-Za-z0-9_]{0,63}")


def load(name: str) -> dict:
    spec = json.loads((DIR / f"{name}.json").read_text())
    runner(spec.get("kind", ""))
    return spec


@functools.cache
def runner(kind: str):
    """The runner module ``traffic/<kind>.py``."""
    path = DIR / f"{kind}.py"
    if not KIND.fullmatch(kind) or not path.is_file():
        raise ValueError(f"traffic kind {kind!r}: no runner {path.name}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_traffic_{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # its faults find it by its name
    spec.loader.exec_module(mod)
    return mod


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def batch_order(n_batches: int, seed: int, count: int) -> np.ndarray:
    """Pool batch of each of ``count`` batches: the pool's ``n_batches``
    batches in an order drawn from the seed, cycled."""
    perm = rng(seed, 1).permutation(n_batches)
    return perm[np.arange(count) % len(perm)]


class Requests:
    """An open-loop schedule: ``due`` seconds after the window opens,
    ``rows`` queries each, starting at ``start`` in the pool."""

    def __init__(self, due: np.ndarray, rows: np.ndarray, start: np.ndarray):
        self.due, self.rows, self.start = due, rows, start

    def __len__(self) -> int:
        return len(self.due)


def sizes(spec: dict, n: int, gen: np.random.Generator) -> np.ndarray:
    """``n`` request sizes drawn from the mix's ``sizes`` groups."""
    groups = np.asarray(spec["sizes"], dtype=np.float64)
    w = groups[:, 2] / groups[:, 2].sum()
    g = gen.choice(len(groups), size=n, p=w)
    lo = groups[g, 0].astype(np.int64)
    hi = groups[g, 1].astype(np.int64)
    return lo + (gen.random(n) * (hi - lo + 1)).astype(np.int64)


def arrival_times(spec: dict, n: int, seconds: float,
                  gen: np.random.Generator) -> np.ndarray:
    """``n`` sorted arrival times in [0, seconds): the renewal process of
    ``arrivals`` conditioned on ``n`` arrivals in the window (its n + 1
    gaps scaled to span it; for cv 1 the same law as n sorted uniform
    times)."""
    cv = float(spec["arrivals"]["cv"])
    gaps = gen.gamma(1.0 / cv ** 2, 1.0, n + 1)
    t = np.cumsum(gaps)
    return t[:n] / t[n] * seconds


def requests(spec: dict, seed: int, seconds: float,
             rate: float | None = None) -> Requests:
    """The schedule of one window of ``seconds`` (``rate`` overrides the
    mix's, for a sweep)."""
    rate = spec["rate_per_s"] if rate is None else rate
    n = int(round(rate * seconds))
    rows = sizes(spec, n, rng(FIXED, 0))
    r = rng(seed, 2)
    rows = rows[r.permutation(n)]
    due = arrival_times(spec, n, seconds, r)
    start = (r.random(n) * (spec["pool_queries"] - rows + 1)).astype(np.int64)
    return Requests(due, rows, start)
