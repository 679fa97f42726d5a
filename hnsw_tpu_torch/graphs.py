"""A search, and an insert batch of the build, as one device program: the
counterparts of the reference's ``_SEARCH_EXECS`` (``hnsw_tpu/search.py``)
and of its staged insert step (``_get_step`` / ``_get_scan`` in
``hnsw_tpu/build.py``), one jitted executable per set of static arguments,
whose loops are ``lax.while_loop``s with their conditions evaluated on the
device.

Two layers:

  * loops with device-side conditions. A loop is ``run(cond, step, state,
    bound)``: ``step`` maps a state (a dict of tensors) to the next one and
    leaves it unchanged once ``cond`` is false, so extra steps past the end
    are no-ops. ``EagerLoop`` runs the steps in chunks of ``LOOP_CHUNK``
    with no host read inside a chunk and reads the condition once after
    each (``host_read``, the one counted place where a search reads the
    card). A loop with a static ``bound`` (a count of steps that surely
    covers it) skips the read once the bound is reached. This layer runs
    on every device;
  * captured CUDA graphs. On a CUDA device ``replay_or_capture`` keeps one
    capture per key (the reference's static arguments plus the identity
    of every index tensor the search reads). A key's first search runs
    eagerly (the warm-up a capture needs), is captured and then replayed.
    ``_Capture`` records the search body on a side stream as a chain of
    graphs: code and bounded loops (unrolled, ``bound`` steps) join the
    current graph; a loop without a bound ends it and becomes a graph of
    one chunk, replayed until its condition reads false. Runtime values
    (queries, ef_live, hop_limit, the graph's scalars, a filter) are
    copied into the capture's static inputs before each replay, and the
    outputs are cloned after it: a later replay overwrites them. An
    insert batch (``insert_or_replay``) is captured the same way, but its
    first run is the batch itself: it writes the index in place, so the
    key's first batch runs eagerly and the capture only records (a
    captured launch executes nothing); later batches of the key replay.
    It reads its runtime values (which batch, the graph's scalars) from
    a schedule staged on the device through a cursor the batch advances,
    so a replay copies nothing in and leaves no output behind.

Every capture, search or build, allocates from one memory pool. That is
sound because one program runs at a time (searches and builds are issued
from one host thread, on one stream) and none leaves state in the pool
behind it: a search copies its outputs out before the next program, a
build batch writes only the index and its staged schedule (allocated
outside the pool), a graph's temporaries are dead outside its own
replay, and the state a chain passes from one graph to the next lives
only within one search or one batch.
Once every capture is dropped the next one starts a new pool (PyTorch
reuses a pool only while a graph holds it). The warm-up runs on the
capture stream, as PyTorch's capture recipe has it, so what a library
sets up for that stream (cuBLAS's workspace) is made outside the pool.
A failed capture or replay raises; nothing falls back to the eager loop.
The eager loop on the card is the plain version of a replay, for
comparisons only (``eager()``, for searches and builds alike).

Launch counts stay true (``ops/_cuda.py``): a capture records the launches
of each graph instead of counting them, and each replay adds them.

Phases (``trace.py``): a body marks its phases through its loop runner
(``loop.phase(label)``). ``EagerLoop`` passes each mark to its
``trace.Phases`` (a span, and on a card a timing event). A capture asked
to ``split`` (a search with ``with_stats``, a build traced) ends the
current graph at each mark and labels the parts; its replay then marks
its ``trace.Phases`` between the launches of two phases. Other captures
ignore the marks: one chain of graphs, as many launches as without them.
"""

from __future__ import annotations

import contextlib
import gc
import time
import weakref
from typing import Callable

import torch

from . import trace
from .ops._cuda import add_recorded, start_recording, stop_recording

# steps a loop runs between two reads of its condition (>= 16 keeps a
# search to a few reads; 1 reads once a step, as a plain loop would)
LOOP_CHUNK = 16
# padded query rows on the card (the reference pads its fused path's
# queries to a multiple of 512: a capture then serves nearby batch sizes)
CUDA_Q_ALIGN = 512
# the same on the CPU, where nothing is captured (tests raise it to drive
# the padded rows)
CPU_Q_ALIGN = 1


def host_read(t: torch.Tensor):
    """The value of a tensor on the host (a number for one element, else
    a list): the only place the search loops and the build wait on the
    device. Counted in the counter ``host_reads`` (``trace.py``)."""
    trace.count("host_reads")
    return t.item() if t.numel() == 1 else t.tolist()


def padded_rows(qn: int, device: torch.device) -> int:
    """The query rows a search runs: ``qn`` padded to a multiple of the
    device's alignment (and to at least one multiple)."""
    a = CUDA_Q_ALIGN if device.type == "cuda" else CPU_Q_ALIGN
    return max(a, -(-qn // a) * a)


class EagerLoop:
    """Runs each loop on the host: ``chunk`` steps, then one read of the
    condition (none once ``bound`` steps have run). Phase marks go to
    ``phases`` (a ``trace.Phases``; none: ignored)."""

    def __init__(self, chunk: int | None = None, phases=None):
        self.chunk = LOOP_CHUNK if chunk is None else int(chunk)
        if self.chunk < 1:
            raise ValueError(f"loop chunk must be >= 1, got {self.chunk}")
        self.phases = phases

    def phase(self, label: str) -> None:
        if self.phases is not None:
            self.phases.mark(label)

    def run(self, cond: Callable[[dict], torch.Tensor],
            step: Callable[[dict], dict], state: dict,
            bound: int | None = None) -> dict:
        done = 0
        while True:
            n = self.chunk if bound is None else min(self.chunk,
                                                     bound - done)
            for _ in range(n):
                state = step(state)
            done += n
            if bound is not None and done >= bound:
                return state
            if not host_read(cond(state)):
                return state


_EAGER_ONLY = False


@contextlib.contextmanager
def eager():
    """Searches and insert batches on the card run eagerly inside the
    block: the plain version of a replay, which tests and
    ``chip_smoke.py`` hold replays against. Not a serving mode."""
    global _EAGER_ONLY
    before, _EAGER_ONLY = _EAGER_ONLY, True
    try:
        yield
    finally:
        _EAGER_ONLY = before


def capturing_enabled(device: torch.device) -> bool:
    return device.type == "cuda" and not _EAGER_ONLY


def tensor_identity(t: torch.Tensor | None) -> tuple | None:
    """What a captured graph bakes in about a tensor it reads."""
    if t is None:
        return None
    return (t.data_ptr(), tuple(t.shape), str(t.dtype), tuple(t.stride()),
            str(t.device))


class _Capture:
    """Records one run of a search body as a chain of CUDA graphs (see the
    module docstring). ``parts``: [(graph, launches, flag, phase)], flag
    the condition tensor of a loop graph (None for straight code), phase
    the label of the phase the graph belongs to (None unless ``split``)."""

    def __init__(self, pool, chunk: int, split: bool = False):
        self.pool = pool
        self.chunk = chunk
        self.split = split
        self.label = None
        self._after_loop = False
        self.parts: list = []
        self.held: list = []
        self._graph = None

    def begin(self) -> None:
        self._graph = torch.cuda.CUDAGraph()
        start_recording()
        self._graph.capture_begin(pool=self.pool)

    def end(self, flag: torch.Tensor | None = None) -> None:
        g, self._graph = self._graph, None
        try:
            g.capture_end()
        finally:
            counts = stop_recording()
        self.parts.append((g, counts, flag, self.label))

    def phase(self, label: str) -> None:
        """With ``split``: the graph so far ends and the next ones belong
        to ``label``. The graph the body began in, and one begun after a
        loop graph, take the label instead of ending (what they recorded
        before the mark is little or nothing, and an empty graph would be
        a launch that does no work)."""
        if not self.split or label == self.label:
            return
        if self.label is not None and not self._after_loop:
            self.end()
            self.begin()
        self.label = label
        self._after_loop = False

    def abort(self) -> None:
        if self._graph is not None:
            g, self._graph = self._graph, None
            try:
                g.capture_end()
            except Exception:  # noqa: BLE001 — the first error is raised
                pass
            finally:
                stop_recording()

    def run(self, cond, step, state: dict, bound: int | None = None):
        if bound is not None:
            for _ in range(bound):
                state = step(state)
            return state
        # the state the loop graph updates in place: fresh tensors, made in
        # the graph before it, never an input or another value's alias
        state = {k: None if v is None else v.clone()
                 for k, v in state.items()}
        self.end()
        self.begin()
        new = state
        for _ in range(self.chunk):
            new = step(new)
        for k, v in state.items():
            if v is not None and new[k] is not v:
                v.copy_(new[k])
        flag = cond(state)
        self.end(flag)
        self.held.append((state, flag))
        self.begin()
        self._after_loop = True
        return state


class _Entry:
    """One key's capture: its graphs, static inputs and outputs, the loop
    graphs' state and flags (kept alive with them), weak references to
    the index tensors it reads, and the capture's host ms."""

    def __init__(self, parts, inputs: dict, outputs: dict, held, refs,
                 capture_ms: float):
        self.parts = parts
        self.inputs = inputs
        self.outputs = outputs
        self.held = held
        self.refs = [weakref.ref(t) for t in refs]
        self.capture_ms = capture_ms

    def alive(self) -> bool:
        return all(r() is not None for r in self.refs)

    def replay(self, inputs: dict, phases=None) -> dict:
        """Launch the chain; a split capture marks ``phases`` (a
        ``trace.Phases``) at the first graph of each phase and stops it
        after the last."""
        if inputs:
            with trace.span("hnsw.graph.inputs"):
                for k, v in inputs.items():
                    self.inputs[k].copy_(v)
        for g, counts, flag, label in self.parts:
            if label is not None and phases is not None:
                phases.mark(label)
            _launch(g, counts)
            if flag is not None:
                while host_read(flag):
                    _launch(g, counts)
        if phases is not None:
            phases.stop()
        return {k: v.clone() for k, v in self.outputs.items()}


def _launch(g, counts) -> None:
    with trace.span("hnsw.graph.launch"):
        g.replay()
    add_recorded(counts)


_CACHE: dict = {}
_POOL = None
_STREAM = None


def clear() -> None:
    """Drop every captured search (and with them the memory pool)."""
    global _POOL
    _CACHE.clear()
    _POOL = None


def _purge() -> None:
    """Drop the captures whose index tensors are gone (grow, a re-pack, a
    deleted index): their graphs read freed memory."""
    global _POOL
    for key in [k for k, e in _CACHE.items() if not e.alive()]:
        del _CACHE[key]
    if not _CACHE:
        _POOL = None


def _stream() -> torch.cuda.Stream:
    global _STREAM
    if _STREAM is None:
        _STREAM = torch.cuda.Stream()
    return _STREAM


@contextlib.contextmanager
def _on_capture_stream():
    s = _stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        yield
    torch.cuda.current_stream().wait_stream(s)


def capture(body: Callable, inputs: dict, refs, *, chunk: int | None = None,
            what: str = "search", split: bool = False) -> _Entry:
    """Capture ``body(inputs, loop)`` with its own copies of ``inputs``;
    a loop without a bound becomes a graph of ``chunk`` steps
    (``LOOP_CHUNK`` by default); with ``split`` each phase mark ends a
    graph. The entry carries the capture's host ms, also counted in
    ``captures.<what>`` and ``capture_ms.<what>`` (``trace.py``). Raises
    RuntimeError if the capture fails."""
    global _POOL
    t0 = time.perf_counter()
    if _POOL is None:
        _POOL = torch.cuda.graph_pool_handle()
    static = {k: v.clone() for k, v in inputs.items()}
    # as torch.cuda.graph does before a capture
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    cap = _Capture(_POOL, LOOP_CHUNK if chunk is None else chunk, split)
    failed = None
    with _on_capture_stream():      # a capture ends on the stream it began
        try:
            cap.begin()
            outputs = body(static, cap)
            cap.end()
        except Exception as e:
            cap.abort()
            failed = e
    if failed is not None:
        raise RuntimeError(f"{what} capture failed: {failed}") from failed
    ms = (time.perf_counter() - t0) * 1e3
    trace.count(f"captures.{what}")
    trace.count(f"capture_ms.{what}", ms)
    return _Entry(cap.parts, static, outputs, cap.held, refs, ms)


def replay_or_capture(key, refs, inputs: dict, body: Callable, *,
                      split: bool = False, phases=None) -> dict:
    """The search ``body`` for ``key``: replayed from its capture, captured
    first (after one eager run) on the key's first search, split at its
    phase marks with ``split`` (which the key must hold). ``refs``: the
    index tensors the key names (a capture is dropped once one is freed).
    ``phases``: the replay's ``trace.Phases``. Returns fresh copies of the
    outputs."""
    _purge()
    entry = _CACHE.get(key)
    if entry is None:
        with _on_capture_stream():
            body(inputs, EagerLoop())   # the warm-up a capture needs
        entry = capture(body, inputs, refs, split=split)
        _CACHE[key] = entry
    try:
        return entry.replay(inputs, phases)
    except Exception as e:
        raise RuntimeError(f"search replay failed: {e}") from e


def insert_or_replay(key, refs, body: Callable, *, chunk: int, keep: bool,
                     split: bool = False, phases=None):
    """One insert batch, ``body(None, loop)``, which writes the index in
    place and returns nothing: replayed from the capture of ``key``, else
    run eagerly (the batch's own insert, on the capture stream, with its
    loops read once every ``chunk`` steps) and, with ``keep`` (a later
    batch has this key), captured after it, split at its stage marks with
    ``split`` (which the key must hold). The capture records without
    running, so the batch is inserted once. ``refs``: the tensors the key
    names; ``phases``: the batch's ``trace.Phases``. Returns (what ran:
    "replayed", "eager" or "captured", an eager run then the capture; the
    key's ``_Entry``, None after "eager")."""
    def run(inputs, loop):
        body(inputs, loop)
        return {}

    _purge()
    entry = _CACHE.get(key)
    if entry is None:
        with _on_capture_stream(), trace.span("hnsw.build.eager"):
            run(None, EagerLoop(chunk, phases))
            if phases is not None:
                phases.stop()
        if not keep:
            return "eager", None
        with trace.span("hnsw.build.capture"):
            entry = _CACHE[key] = capture(run, {}, refs, chunk=chunk,
                                          what="build", split=split)
        return "captured", entry
    try:
        entry.replay({}, phases)
    except Exception as e:
        raise RuntimeError(f"build replay failed: {e}") from e
    return "replayed", entry
