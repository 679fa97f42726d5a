"""The ``fanout_batches`` runner's own parts at no scale: the ranks'
traced windows averaged, the rank gap, the shard capacity of a tiny run,
and the Shards readers from counters made by hand (each rank's program
table since the window opened, as the runner gathers them)."""

import numpy as np
import pytest

import pb_tiny
from portbench import cells, traffic
from portbench.trace import Summary

RUN = traffic.runner("fanout_batches")


def _ctx(every, trace=True, batches=10):
    c = cells.Context("cell", {}, {})
    c.counters.update(batches=batches, shard=every)
    if trace:
        c.trace = Summary(1.0, 0.6, {}, {})
    return c


def _rank(local=(4, 80.0), gather=(4, 2.0), captures=0):
    return {"device": {"hnsw.shard.local": list(local),
                       "hnsw.shard.gather": list(gather)},
            "counters": {"captures.search": captures} if captures else {}}


def test_windows_averaged_over_the_ranks():
    win = RUN.Averaged([(1.0, 0.6, {"k": 0.4}, {"a": 0.1}),
                        (1.2, 0.2, {"k": 0.2, "m": 0.1}, {"b": 0.3}),
                        None])
    assert win.window_s == pytest.approx(1.1)
    s = win.reduce()
    assert s.busy_s == pytest.approx(0.4)
    assert s.ops == pytest.approx({"k": 0.3, "m": 0.05})
    assert s.gaps == pytest.approx({"a": 0.05, "b": 0.15})
    assert s.idle_percent() == pytest.approx(100 * (1 - 0.4 / 1.1))
    assert RUN.Averaged([None]).window_s == 0.0


def test_rank_gap_counts_rows_apart_bit_for_bit():
    d = np.arange(12, dtype=np.float32).reshape(4, 3)
    i = np.arange(12, dtype=np.int64).reshape(4, 3)
    d2, i2 = d.copy(), i.copy()
    d2[1, 2] = np.nextafter(d2[1, 2], np.float32(1e9))
    i2[3, 0] = 99
    every = [{"last": (d, i)}, {"last": (d.copy(), i.copy())},
             {"last": (d2, i2)}]
    assert RUN.rank_gap(every) == 2
    assert RUN.rank_gap(every[:2]) == 0
    assert RUN.rank_gap([{"last": (d, i)}, {"last": (d[:2], i[:2])}]) == 4


def test_shard_capacity_follows_a_cut_capacity():
    cfg = pb_tiny.tiny_config("deep10m-hnsw32-sq8-4shard")
    assert RUN.shard_capacity(cfg) == 500
    full = pb_tiny.manifest.config(pb_tiny.MAN, "deep10m-hnsw32-sq8-4shard",
                                   pb_tiny.ROOT)
    assert RUN.shard_capacity(full) == full["capacity_per_shard"] == \
        full["n"] // full["shards"]


def test_shard_readers():
    every = [_rank((4, 80.0), (4, 2.0), captures=4), _rank((4, 88.0)),
             _rank((2, 36.0)), _rank((4, 72.0))]
    c = _ctx(every)
    assert cells.read_metric("local_ms.shard", c) == pytest.approx(19.5)
    assert cells.read_metric("gather_ms.shard", c) == pytest.approx(0.5)
    assert cells.read_metric("captures_per_search.shard", c) == 0.4
    assert cells.read_metric("idle_share.fanout", c) == pytest.approx(40.0)
    # the CPU runs no device op: no device times to read, the counter reads
    c.trace = Summary(1.0, 0.0, {}, {})
    assert cells.read_metric("local_ms.shard", c) is None
    assert cells.read_metric("gather_ms.shard", c) is None
    assert cells.read_metric("captures_per_search.shard", c) == 0.4
    # a program without the shard phases, or without a trace module
    bare = [{"device": {}, "counters": {}}] * 4
    assert cells.read_metric("local_ms.shard", _ctx(bare)) is None
    assert cells.read_metric("gather_ms.shard", _ctx(bare)) is None
    assert cells.read_metric("captures_per_search.shard", _ctx(bare)) == 0
    none = [{"device": None, "counters": None}] * 4
    assert cells.read_metric("captures_per_search.shard", _ctx(none)) is None
    assert cells.read_metric("local_ms.shard", _ctx(none)) is None


@pytest.mark.parametrize("recaptures", [False, True])
def test_warm_up_fails_a_program_that_captures_every_search(monkeypatch,
                                                            recaptures):
    from hnsw_tpu_torch import trace
    calls = []

    def serve(idx, q, k, ef):
        if recaptures or not calls:
            trace.count("captures.search")
        calls.append(q)
        return "answer"
    monkeypatch.setattr(RUN, "serve", serve)
    monkeypatch.setattr(RUN.ranks, "step", lambda j=None: 0)
    if recaptures:
        with pytest.raises(RuntimeError, match="captured anew"):
            RUN.warm(None, [np.zeros((2, 3))], 10, 64, True)
    else:
        assert RUN.warm(None, [np.zeros((2, 3))], 10, 64, True) == "answer"
    assert len(calls) == RUN.WARM
