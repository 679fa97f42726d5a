"""Failures planted in the followers of a four-card tiny run
(``ranks.PLANTS``): each ``plant(setattr)`` runs in every follower before
its ``follow()``, and acts on one rank."""

from __future__ import annotations

import sys
import time


def _at_step(setattr, rank: int, nth: int, act) -> None:
    """On ``rank``, ``act()`` at its ``nth`` ``ranks.step()``."""
    from portbench import ranks
    if ranks.rank() != rank:
        return
    real, calls = ranks.step, [0]

    def step(j=None):
        calls[0] += 1
        if calls[0] == nth:
            act()
        return real(j)
    setattr(ranks, "step", step)


def raise_on_rank_1(setattr):
    def act():
        raise RuntimeError("planted: rank 1 fails at its third step")
    _at_step(setattr, 1, 3, act)


def sleep_on_rank_2(setattr):
    def act():
        print("planted: rank 2 sleeps past the timeout", flush=True)
        time.sleep(3600)
    _at_step(setattr, 2, 3, act)


def jax_on_rank_3(setattr):
    from portbench import ranks
    if ranks.rank() == 3:
        import jax  # noqa: F401


def peak_by_rank(setattr):
    """Each rank's peak reads 1000 + 10 * its rank."""
    from portbench import cells, ranks
    setattr(cells, "peak", lambda device: 1000 + 10 * ranks.rank())


def serve_forever(setattr):
    """Rank 0 prints its children's ids at its first batch, then waits."""
    from portbench import ranks, traffic
    mod = traffic.runner("fanout_exact")

    def serve(*_):
        print("PIDS", *ranks._GROUP.pids, flush=True)
        sys.stdout.flush()
        time.sleep(3600)
    setattr(mod, "serve", serve)
