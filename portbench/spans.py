"""The program's own spans and device phase times, for the per-layer
readers: ``hnsw_tpu_torch.trace``'s process-wide table. The program traces
only while ``torch.profiler`` records in the process, so in a ``--trace 1``
run the table holds exactly the traced part of the window
(``trace.Window``). A program without that module gives no table, and its
readers nothing. Like the ``idle_share`` readers, these read nothing
without a device trace (``busy_s`` 0: the CPU runs no device op).
"""

from __future__ import annotations


def totals():
    """``hnsw_tpu_torch.trace.totals()``, or None where the program has
    no such module."""
    try:
        from hnsw_tpu_torch import trace
    except ImportError:
        return None
    return trace.totals()


def table(ctx):
    """The program's table of a traced run on a device, else None."""
    if ctx.trace is None or not ctx.trace.busy_s:
        return None
    return totals()


def device_ms(ctx, name: str):
    """Device ms of phase span ``name`` over the phases timed."""
    t = table(ctx)
    if t is None:
        return None
    n, ms = t.device_ms(name)
    return ms / n if n else None


def host_ms(ctx, name: str):
    """Host ms of span ``name`` less its child ``hnsw.search.wait`` (the
    device's time), over the span's calls."""
    t = table(ctx)
    n = 0 if t is None else t.calls(name)
    if not n:
        return None
    return 1e3 * (t.seconds(name)
                  - t.seconds("hnsw.search.wait", parent=name)) / n


def span_ms(ctx, name: str, per: str):
    """Host ms of span ``name`` over the calls of span ``per``."""
    t = table(ctx)
    if t is None or not t.calls(name) or not t.calls(per):
        return None
    return 1e3 * t.seconds(name) / t.calls(per)
