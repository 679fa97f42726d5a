"""The readers of the program's spans (``portbench/spans.py`` and every
``program_span`` metric) on hand-made tables, on the program's own table
after a traced call, and without a device trace or without the program's
trace module (a checkout that has none)."""

import sys

import numpy as np
import pytest

import pb_tiny
from portbench import cells, spans
from portbench.trace import Summary

import hnsw_tpu_torch
from hnsw_tpu_torch import HnswIndex, trace

SPAN_METRICS = {m["name"] for m in pb_tiny.MAN["per_layer"]
                if m["source"] == "program_span"}
SEARCH = {  # 4 searches: 60 ms of wall, 20 of it waiting; 6 ms of launches
    ("hnsw.search", None): [4, 0.060, 0.010],
    ("hnsw.search.wait", "hnsw.search"): [4, 0.020, 0.020],
    ("hnsw.graph.launch", "hnsw.search.hops"): [12, 0.006, 0.006],
}
SERVE = {   # 10 flushes: 50 ms, 10 of it waiting; 4 ms of launches
    ("hnsw.serve.flush", None): [10, 0.050, 0.015],
    ("hnsw.search", "hnsw.serve.flush"): [10, 0.025, 0.021],
    ("hnsw.search.wait", "hnsw.serve.flush"): [10, 0.010, 0.010],
    ("hnsw.graph.launch", "hnsw.search"): [10, 0.004, 0.004],
}
BUILD = {("hnsw.build.plan", None): [2, 0.040, 0.040]}
DEVICE = {"hnsw.search.entry": [4, 4.0], "hnsw.search.hops": [4, 30.0],
          "hnsw.search.rerank": [4, 2.0], "hnsw.build.beams": [20, 300.0],
          "hnsw.build.backlinks": [20, 700.0]}
WANT = {
    ("entry_ms.search", "search"): 1.0,
    ("hops_ms.search", "search"): 7.5,
    ("rerank_ms.search", "search"): 0.5,
    ("host_ms.search", "search"): 10.0,
    ("launch_ms.search", "search"): 1.5,
    ("beams_ms.build", "build"): 15.0,
    ("backlinks_ms.build", "build"): 35.0,
    ("plan_ms.build", "build"): 20.0,
    ("host_ms.serve", "serve"): 4.0,
    ("launch_ms.serve", "serve"): 0.4,
}
TABLES = {"search": SEARCH, "serve": SERVE, "build": BUILD}


def _ctx(summary):
    c = cells.Context("cell", {"d": 128}, {})
    c.trace = summary
    return c


def test_every_span_metric_has_a_case():
    assert SPAN_METRICS == {name for name, _ in WANT}
    assert all(m["unit"] == "ms" and m["better"] == "lower"
               for m in pb_tiny.MAN["per_layer"]
               if m["name"] in SPAN_METRICS)


@pytest.mark.parametrize("name,kind", sorted(WANT))
def test_reads_a_hand_made_table(name, kind, monkeypatch):
    monkeypatch.setattr(spans, "totals",
                        lambda: trace.Table(TABLES[kind], DEVICE))
    c = _ctx(Summary(1.0, 0.5, {}, {}))
    assert cells.read_metric(name, c) == pytest.approx(WANT[(name, kind)])
    # nothing without a device trace, on an idle one, or from an empty
    # table (a program that records nothing)
    for summary in (None, Summary(1.0, 0.0, {}, {})):
        assert cells.read_metric(name, _ctx(summary)) is None
    monkeypatch.setattr(spans, "totals", trace.Table)
    assert cells.read_metric(name, c) is None


def test_nothing_from_a_program_without_its_trace(monkeypatch):
    monkeypatch.delattr(hnsw_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "hnsw_tpu_torch.trace", None)
    assert spans.totals() is None
    c = _ctx(Summary(1.0, 0.5, {}, {}))
    for name in SPAN_METRICS:
        assert cells.read_metric(name, c) is None


def test_reads_the_program_table():
    """A traced search of the program, then the readers over its
    process-wide table: the host spans read, the device phases do not
    (the CPU times none)."""
    rng = np.random.default_rng(3)
    idx = HnswIndex(8, 4, capacity=256, ef_construction=20, device="cpu")
    idx.add(rng.normal(size=(200, 8)).astype(np.float32))
    before = spans.totals().calls("hnsw.search")
    with trace.collect():
        idx.search(rng.normal(size=(16, 8)).astype(np.float32), 5)
    assert spans.totals().calls("hnsw.search") == before + 1
    c = _ctx(Summary(1.0, 0.5, {}, {}))
    assert cells.read_metric("host_ms.search", c) > 0
    assert cells.read_metric("entry_ms.search", c) is None
