"""Spans, device phase times and counters of ``hnsw_tpu_torch``.

Three records, kept in memory for the life of the process:

  * spans (``span(name)``): the host seconds, calls and self seconds (the
    duration less what the span's child spans cover) of named blocks of
    the program, keyed by (name, name of the enclosing span; None at the
    top). A span is also a ``torch.profiler.record_function`` range, so
    it sits on the profiler's clock beside the device's events;
  * device phase times (``Phases``): the milliseconds between CUDA events
    recorded at the phase boundaries of a search or an insert batch,
    keyed by the phase's span name;
  * counters (``count(name, n)``): ``host_reads`` (every
    ``graphs.host_read``), ``captures.search`` / ``captures.build`` and
    ``capture_ms.search`` / ``capture_ms.build`` (CUDA graph captures and
    their host milliseconds), ``searches.kernel_hop`` /
    ``searches.composed_hop`` (the fused-beam searches whose hops ran K1's
    hop entry on a CUDA device, or its plain composition on the CPU;
    counted on the host once a search call), ``searches.kernel_entry`` /
    ``searches.composed_entry`` (the sampled-entry searches whose scan ran
    K6 on a CUDA device, or its plain composition on the CPU; counted the
    same way), ``shard.gathered_bytes``
    (the bytes a sharded search's ``all_gather`` brought to this rank).

Tracing is on while ``torch.profiler`` records in the process, or inside
``collect()``. Spans and device times are recorded only while it is on;
counters count whether it is on or off. With tracing off a span is one
check and a shared no-op context.

An operator scopes a block::

    from hnsw_tpu_torch import trace
    with trace.collect() as t:
        idx.search(queries, 10)
    t.seconds("hnsw.search"), t.calls("hnsw.graph.launch")
    t.device_ms("hnsw.search.hops"), t.counters["host_reads"]

``totals()`` is the process-wide table. The spans, each under the span
that encloses it where it runs:

  * ``hnsw.search`` (``HnswIndex.search``), with ``hnsw.search.upload``
    (the queries to the device), ``hnsw.search.plan`` (the statics and the
    capture key), the phases ``hnsw.search.entry`` / ``.hops`` /
    ``.rerank``, ``hnsw.graph.inputs`` (the copies into a capture's static
    inputs), ``hnsw.graph.launch`` (each CUDA graph launch),
    ``hnsw.search.wait`` and ``hnsw.search.download`` (the outputs to the
    host);
  * ``hnsw.build.plan`` (an ``add()``'s level draw, schedule and staging
    copies), ``hnsw.build.step`` (one insert batch) with
    ``hnsw.build.eager``, ``hnsw.build.capture`` or ``hnsw.graph.launch``
    and the stages ``hnsw.build.write`` / ``.descent`` / ``.upper`` /
    ``.beams`` / ``.select`` / ``.backlinks``; ``hnsw.build.sync`` and
    ``hnsw.build.finish``;
  * ``hnsw.serve.flush`` (``Searcher.flush``), with
    ``hnsw.serve.concat``, the searches, ``hnsw.search.wait``,
    ``hnsw.serve.download`` and ``hnsw.serve.split``;
  * ``hnsw.shard.search`` (``ShardedHnswIndex.search``), with the phases
    ``hnsw.shard.local`` (the rank's shard searches), ``.gather`` (the
    ``all_gather`` across processes) and ``.merge``, then
    ``hnsw.search.wait`` and ``hnsw.shard.download``;
    ``hnsw.shard.add`` (``ShardedHnswIndex.add``), with
    ``hnsw.shard.plan`` and ``hnsw.shard.stage`` before the insert
    batches' spans.

While tracing is on, the first blocking read of a search waits for the
device inside ``hnsw.search.wait`` (``wait``), so that the spans after it
measure host work alone.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

_ANY = object()           # ``Table`` lookups: a span under any parent

_lock = threading.Lock()
_local = threading.local()
_SPANS: dict = {}         # (name, parent) -> [calls, seconds, self seconds]
_DEVICE: dict = {}        # phase span name -> [phases timed, ms]
_COUNTERS: dict = {}      # name -> value
_collecting = 0           # open collect() blocks
_NOOP = contextlib.nullcontext()


class Table:
    """Spans, device phase times and counters: ``spans`` {(name, parent):
    [calls, seconds, self seconds]}, ``device`` {phase span name: [phases
    timed, ms]} and ``counters`` {name: value}."""

    def __init__(self, spans=None, device=None, counters=None):
        self.spans = {k: list(v) for k, v in (spans or {}).items()}
        self.device = {k: list(v) for k, v in (device or {}).items()}
        self.counters = dict(counters or {})

    def _span_sum(self, name: str, parent, col: int) -> float:
        return sum(v[col] for (n, p), v in self.spans.items()
                   if n == name and (parent is _ANY or p == parent))

    def calls(self, name: str, parent=_ANY) -> int:
        """Calls of span ``name`` (under ``parent`` if given)."""
        return int(self._span_sum(name, parent, 0))

    def seconds(self, name: str, parent=_ANY) -> float:
        """Host seconds of span ``name`` (under ``parent`` if given)."""
        return self._span_sum(name, parent, 1)

    def self_seconds(self, name: str, parent=_ANY) -> float:
        """Host seconds of span ``name`` outside its child spans."""
        return self._span_sum(name, parent, 2)

    def device_ms(self, name: str) -> tuple[int, float]:
        """(phases timed, device ms) of phase span ``name``."""
        n, ms = self.device.get(name, (0, 0.0))
        return int(n), float(ms)

    def minus(self, before: Table) -> Table:
        """What this table holds beyond ``before`` (an earlier copy)."""
        def diff(now: dict, old: dict) -> dict:
            out = {}
            for k, v in now.items():
                w = [a - b for a, b in zip(v, old.get(k, [0] * len(v)))]
                if w[0]:
                    out[k] = w
            return out
        counters = {k: v - before.counters.get(k, 0)
                    for k, v in self.counters.items()}
        return Table(diff(self.spans, before.spans),
                     diff(self.device, before.device),
                     {k: v for k, v in counters.items() if v})


def enabled() -> bool:
    """Tracing is on: ``torch.profiler`` records, or a ``collect()`` block
    is open."""
    return _collecting > 0 or torch.autograd._profiler_enabled()


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name`` (tracing on or off)."""
    with _lock:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "rf", "t0", "child")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.child = 0.0
        _stack().append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        st = _stack()
        st.pop()
        parent = st[-1] if st else None
        if parent is not None:
            parent.child += dt
        key = (self.name, None if parent is None else parent.name)
        with _lock:
            row = _SPANS.setdefault(key, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += dt
            row[2] += dt - self.child
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager recording the block as span ``name`` while
    tracing is on (else a shared no-op)."""
    return _Span(name) if enabled() else _NOOP


def wait(t) -> None:
    """While tracing is on, wait for the device of CUDA tensor ``t``
    (its current stream) inside span ``hnsw.search.wait``; else
    nothing."""
    if isinstance(t, torch.Tensor) and t.is_cuda and enabled():
        with span("hnsw.search.wait"):
            torch.cuda.current_stream(t.device).synchronize()


def add_device(prefix: str, ms: dict | None) -> None:
    """Add one run's phase times ``ms`` ({label: ms}) under
    ``<prefix>.<label>`` while tracing is on."""
    if not ms or not enabled():
        return
    with _lock:
        for label, v in ms.items():
            row = _DEVICE.setdefault(f"{prefix}.{label}", [0, 0.0])
            row[0] += 1
            row[1] += v


class Phases:
    """The phase marks of one run of a search or an insert batch.
    ``mark(label)`` ends the open phase and begins ``label``: its span
    ``<prefix>.<label>`` and, when ``timed`` on a CUDA device, an event
    recorded on the current stream; ``stop()`` ends the last phase (with
    an event). The runner of the program calls them: ``graphs.EagerLoop``
    at each mark of the body, ``graphs._Entry.replay`` between the graph
    launches of a capture split at the marks.

    ``ms()``, once the device has passed the last event: {label: device
    ms}, a phase's time running from its boundary event to the next. It
    includes any wait of the device for the phase's own launches. None
    when nothing was timed (on the CPU, untimed, or a capture not split).
    Used as a context manager, its exit stops it."""

    def __init__(self, prefix: str, device, timed: bool):
        self.prefix = prefix
        self.timed = bool(timed) and torch.device(device).type == "cuda"
        self.label = None
        self.events: list = []     # (label, event); label None: the end
        self._span = _NOOP

    def _record(self, label) -> None:
        if self.timed:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append((label, ev))

    def mark(self, label: str) -> None:
        if label == self.label:
            return
        self._span.__exit__(None, None, None)
        self.label = label
        self._span = span(f"{self.prefix}.{label}")
        self._span.__enter__()
        self._record(label)

    def stop(self) -> None:
        if self.label is None:
            return
        self._record(None)
        self._span.__exit__(None, None, None)
        self._span, self.label = _NOOP, None

    def ms(self) -> dict | None:
        if not self.events:
            return None
        out: dict = {}
        for (label, a), (_, b) in zip(self.events, self.events[1:]):
            if label is not None:
                out[label] = out.get(label, 0.0) + a.elapsed_time(b)
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def totals() -> Table:
    """The process-wide table: the spans and device times recorded while
    tracing was on, and the counters."""
    with _lock:
        return Table(_SPANS, _DEVICE, _COUNTERS)


@contextlib.contextmanager
def collect():
    """Tracing on inside the block; yields a ``Table`` that holds, once
    the block ends, the spans, device phase times and counters of the
    block."""
    global _collecting
    out = Table()
    before = totals()
    with _lock:
        _collecting += 1
    try:
        yield out
    finally:
        with _lock:
            _collecting -= 1
        got = totals().minus(before)
        out.spans, out.device, out.counters = (got.spans, got.device,
                                               got.counters)
