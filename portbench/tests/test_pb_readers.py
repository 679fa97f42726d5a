"""Each per-layer reader at a tiny size on the CPU: from a traced tiny run
of its cells, and from counters and a trace summary made by hand."""

import pytest

import pb_tiny
from portbench import cells, roofline
from portbench.trace import Summary

LAYER = {m["name"]: m for m in pb_tiny.MAN["per_layer"]}
COUNTERS = {m["name"] for m in pb_tiny.MAN["per_layer"]
            if m["source"] == "program_counter"}


def test_every_metric_has_a_reader():
    for name in LAYER:
        assert (cells.METRICS_DIR / f"{name}.py").exists(), name


@pytest.mark.parametrize("cell", pb_tiny.CELLS)
def test_traced_tiny_run_reads_counters(cell):
    out, lines = pb_tiny.run(cell, trace=True)
    assert out["correct"], lines
    names = {m["name"] for m in pb_tiny.manifest.metrics_for(
        pb_tiny.MAN, "per_layer", cell)}
    # the CPU runs no device op: the trace's readers find nothing to read
    assert set(out["metrics"]) == names & COUNTERS
    for v in out["metrics"].values():
        assert v["value"] >= 0
    assert list(out)[-1] == "checks"


def _ctx(**counters):
    c = cells.Context("cell", {"d": 96}, {})
    c.counters.update(counters)
    return c


def test_counter_readers():
    c = _ctx(batches=4, hops=288, queries=400, ndis=80_000)
    assert cells.read_metric("hops_per_batch.search", c) == 72
    assert cells.read_metric("ndis_per_query.search", c) == 200
    c = _ctx(build_stats=[
        {"batches": 25, "replayed": 20, "capture_ms": [100.0, 300.0]},
        {"batches": 25, "replayed": 15, "capture_ms": [200.0]}])
    assert cells.read_metric("replayed_share.build", c) == 70.0
    assert cells.read_metric("capture_ms_per_add.build", c) == 300.0
    c = _ctx(serve={"launches": 10, "queries_served": 600,
                    "rows_padded": 400})
    assert cells.read_metric("pad_share.serve", c) == 40.0
    assert cells.read_metric("rows_per_launch.serve", c) == 60.0
    for name in COUNTERS:
        assert cells.read_metric(name, _ctx()) is None


def test_trace_readers():
    c = _ctx(traced={"batches": 2, "ndis": 1_000_000, "q_rows": 8192,
                     "launches": {"gathered_vec_dist/uint8": 146}})
    c.trace = Summary(0.5, 0.4, {"void vec_dist_bytes_kernel<true>": 0.1,
                                 "other": 0.3}, {})
    for n in ("idle_share.search", "idle_share.build", "idle_share.serve"):
        assert cells.read_metric(n, c) == pytest.approx(20.0)
    nbytes, flops = roofline.vec_dist_work(1_000_000, 146, 8192, 96, 96)
    want = 100 * max(nbytes / roofline.HBM_BYTES_PER_S,
                     flops / roofline.F32_FLOPS) / 0.1
    assert cells.read_metric("k3_roofline.sq8", c) == pytest.approx(want)
    c.trace = Summary(0.5, 0.4, {"other": 0.4}, {})
    assert cells.read_metric("k3_roofline.sq8", c) is None   # no K3 time
    c.trace = None
    assert cells.read_metric("idle_share.search", c) is None


def test_serve_counters_stop_where_the_trace_starts():
    """The serving counters of a traced requests run cover the window up
    to its traced part: the requests due before it, not all of them."""
    name = next(c for c in pb_tiny.CELLS if "requests" in c)
    cell = pb_tiny.manifest.cell(pb_tiny.MAN, name)
    cfg = pb_tiny.tiny_config(cell["config"])
    spec = pb_tiny.tiny_traffic(cell["traffic"])
    drv = pb_tiny.traffic.runner(spec["kind"])
    res, ctx, _ = drv.drive(name, cfg, spec, pb_tiny.SEED, 1.5, True, "cpu",
                            0.0)
    served = ctx.counters["serve"]["queries_served"]
    due = pb_tiny.traffic.requests(spec, pb_tiny.SEED, 1.5)
    t_on, _ = cells.trace_start(spec, 1.5)
    before = int(due.rows[due.due < t_on].sum())
    assert 0 < served <= before < int(due.rows.sum())
    assert res.attempted == len(due)
