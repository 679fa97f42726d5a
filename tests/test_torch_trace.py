"""The port's spans, device phase times and counters (hnsw_tpu_torch/trace.py)
on the CPU: nothing recorded with tracing off, ``collect()`` scoping its
block, the counters that replace the graph layer's globals, and traced
calls giving the same answers as untraced ones, with the documented spans
present. The card's side (phase times, split captures) is in
tests/test_torch_cuda.py."""

import time

import numpy as np
import pytest
import torch

import hnsw_tpu_torch
from hnsw_tpu_torch import graphs, trace
from hnsw_tpu_torch.serving import Searcher

from torch_threads import one_torch_thread  # noqa: F401  (a fixture)

SEARCH_SPANS = {"hnsw.search", "hnsw.search.upload", "hnsw.search.plan",
                "hnsw.search.entry", "hnsw.search.hops",
                "hnsw.search.rerank", "hnsw.search.download"}
BUILD_SPANS = {"hnsw.build.plan", "hnsw.build.step", "hnsw.build.eager",
               "hnsw.build.finish", "hnsw.build.write",
               "hnsw.build.descent", "hnsw.build.upper", "hnsw.build.beams",
               "hnsw.build.select", "hnsw.build.backlinks"}
SERVE_SPANS = {"hnsw.serve.flush", "hnsw.serve.concat",
               "hnsw.serve.download", "hnsw.serve.split", "hnsw.search"}


@pytest.fixture(scope="module")
def wl():
    return hnsw_tpu_torch.synthetic_workload(1500, 16, n_queries=96,
                                             seed=61)


def new_index():
    return hnsw_tpu_torch.HnswIndex(16, 8, "l2", capacity=2048,
                                    ef_construction=40, device="cpu")


@pytest.fixture(scope="module")
def index(wl):
    idx = new_index()
    idx.add(wl.base[:1200])
    return idx


def names(table) -> set:
    return {n for n, _ in table.spans}


def test_nothing_recorded_when_off(index, wl):
    assert not trace.enabled()
    before = trace.totals()
    index.search(wl.queries, 10, with_stats=True)
    Searcher(index, k=10).search(wl.queries[:5])
    new_index().add(wl.base[:300])
    with trace.span("outside"):
        pass
    got = trace.totals().minus(before)
    assert got.spans == {} and got.device == {}
    assert got.counters["host_reads"] > 0      # counters count regardless


def test_collect_scopes_spans_self_times_and_counters():
    with trace.collect() as outer:
        assert trace.enabled()
        with trace.span("a"):
            time.sleep(0.02)
            with trace.span("b"):
                time.sleep(0.03)
            with trace.collect() as inner:
                with trace.span("b"):
                    time.sleep(0.01)
                trace.count("things", 2)
        trace.count("things", 3)
    assert not trace.enabled()
    assert outer.spans.keys() == {("a", None), ("b", "a")}
    assert outer.calls("a") == 1 and outer.calls("b") == 2
    assert outer.calls("b", parent="a") == 2 and outer.calls("b", None) == 0
    a, b = outer.seconds("a"), outer.seconds("b")
    assert a >= 0.06 and 0.04 <= b < a
    assert outer.self_seconds("a") == pytest.approx(a - b)
    assert outer.self_seconds("b") == pytest.approx(b)
    assert outer.counters == {"things": 5}
    assert inner.spans.keys() == {("b", "a")} and inner.calls("b") == 1
    assert inner.counters == {"things": 2}
    assert inner.device == {} and outer.device_ms("b") == (0, 0.0)
    # the process-wide table holds what the blocks recorded
    assert trace.totals().calls("a") >= 1


def test_device_times_and_phases_off_the_card():
    """Device times are added while tracing is on; on the CPU a phase
    marks its span and times nothing."""
    trace.add_device("x", {"p": 2.0})            # off: dropped
    with trace.collect() as t:
        trace.add_device("x", {"p": 1.5, "q": 0.5})
        trace.add_device("x", {"p": 2.5})
        with trace.Phases("x", "cpu", timed=True) as ph:
            ph.mark("p")
            ph.mark("q")
    assert t.device_ms("x.p") == (2, 4.0) and t.device_ms("x.q") == (1, 0.5)
    assert ph.ms() is None
    assert names(t) == {"x.p", "x.q"}


def test_counters_replace_the_globals(wl, monkeypatch):
    """``host_reads`` counts every ``graphs.host_read``; the globals are
    gone, and a CPU build captures nothing."""
    assert not hasattr(graphs, "HOST_READS")
    assert not hasattr(graphs, "LAST_CAPTURE_MS")
    calls = [0]
    orig = graphs.host_read

    def read(t):
        calls[0] += 1
        return orig(t)
    monkeypatch.setattr(graphs, "host_read", read)
    idx = new_index()
    with trace.collect() as t:
        idx.add(wl.base[:600])
        idx.search(wl.queries, 10, with_stats=True)
    assert t.counters["host_reads"] == calls[0] > 0
    assert not any(k.startswith("capture") for k in t.counters)
    assert idx._builder.last_stats["capture_ms"] == []
    assert not hasattr(idx._builder, "backlink_dropped_total")


@pytest.mark.parametrize("with_stats", [False, True])
def test_traced_search_is_the_search(index, wl, with_stats):
    want = index.search(wl.queries, 10, ef_search=48, with_stats=with_stats)
    with trace.collect() as t:
        got = index.search(wl.queries, 10, ef_search=48,
                           with_stats=with_stats)
    for a, b in zip(want[:2], got[:2]):
        np.testing.assert_array_equal(a, b)
    if with_stats:
        assert got[2].hops == want[2].hops
        assert torch.equal(got[2].ndis, want[2].ndis)
        assert got[2].phase_ms is None and want[2].phase_ms is None
    assert names(t) == SEARCH_SPANS
    assert t.calls("hnsw.search") == 1
    for n in SEARCH_SPANS - {"hnsw.search"}:
        assert t.calls(n, parent="hnsw.search") == 1, n
    assert t.seconds("hnsw.search") >= sum(
        t.seconds(n) for n in SEARCH_SPANS - {"hnsw.search"})
    assert t.device == {}


def test_traced_add_is_the_add(wl):
    a, b = new_index(), new_index()
    for x in (wl.base[:700], wl.base[700:1400]):
        a.add(x)
        with trace.collect() as t:
            b.add(x)
    for k, v in a.graph.numpy().items():
        np.testing.assert_array_equal(b.graph.numpy()[k], v, err_msg=k)
    assert torch.equal(a.vectors, b.vectors)
    assert a._builder.last_stats == b._builder.last_stats
    assert names(t) == BUILD_SPANS
    batches = b._builder.last_stats["batches"]
    assert t.calls("hnsw.build.plan") == t.calls("hnsw.build.finish") == 1
    assert t.calls("hnsw.build.step") == batches
    assert t.calls("hnsw.build.eager", parent="hnsw.build.step") == batches
    for stage in ("write", "descent", "beams", "select", "backlinks"):
        assert t.calls(f"hnsw.build.{stage}",
                       parent="hnsw.build.eager") == batches, stage
    assert 0 < t.calls("hnsw.build.upper") <= batches
    assert t.device == {}


def test_traced_flush_is_the_flush(index, wl):
    sizes = [1, 7, 3, 30, 2]
    starts = np.cumsum([0] + sizes[:-1])

    def serve():
        s = Searcher(index, k=10, ef_search=48)
        hs = [s.submit(wl.queries[a:a + n]) for a, n in zip(starts, sizes)]
        s.flush()
        return [s.result(h) for h in hs], s.stats

    want, want_stats = serve()
    with trace.collect() as t:
        got, got_stats = serve()
    for (wd, wi), (gd, gi) in zip(want, got):
        np.testing.assert_array_equal(wd, gd)
        np.testing.assert_array_equal(wi, gi)
    assert got_stats == want_stats
    assert SERVE_SPANS <= names(t)
    assert t.calls("hnsw.serve.flush") == 1
    for n in SERVE_SPANS - {"hnsw.serve.flush"}:
        assert t.calls(n, parent="hnsw.serve.flush") == 1, n
    # the CPU has no device to wait for
    assert t.calls("hnsw.search.wait") == 0


def test_phase_ms_is_none_on_the_cpu(index, wl):
    _, _, st = index.search(wl.queries[:8], 5, with_stats=True)
    assert st.phase_ms is None
    assert st._fields == ("hops", "ndis", "phase_ms")
