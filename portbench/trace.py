"""Timing and tracing helpers of the benchmark (copies, not calls, of the
program's ``chip_smoke.py`` methods: synced walls after an untimed warm
call, and ``busy_ms``'s union of CUDA events).

``Window`` runs ``torch.profiler`` over a part of a run's measured window
and reduces it to what the per-layer readers take: the device's busy
seconds (the union of its kernel and copy events), the traced window's
seconds, device time by operation name, and the idle gaps labelled by
what the host was doing (the innermost host event around each gap's
start: one of the harness's own spans, a PyTorch op or a CUDA runtime
call). The window's two ends, from its start to the first device event
and from the last one to its end, are gaps too, so the gaps sum to the
idle time.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

SHORT_GAP_S = 10e-6      # shorter idle gaps are summed under one label
TOP = 10                 # entries of each breakdown list
NAME_CHARS = 120         # a device op's name is cut to this length
START, END = "portbench.window.start", "portbench.window.end"   # markers


def short_name(name: str) -> str:
    """A kernel's demangled name without ``void``, anonymous namespaces
    and its argument list (a copy's name keeps its kind in parentheses),
    cut to ``NAME_CHARS``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i and name[i - 1] != " ":
            name = name[:i]
            break
    return name[:NAME_CHARS]


def span(name: str):
    """A host span of the harness (a profiler range; a no-op cost when the
    profiler is off)."""
    return torch.profiler.record_function(name)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


class Summary:
    """What a traced window held, reduced to numbers."""

    def __init__(self, window_s: float, busy_s: float, ops: dict,
                 gaps: dict):
        self.window_s = window_s
        self.busy_s = busy_s
        self.ops = ops            # {device op's full name: seconds}
        self.gaps = gaps          # {host label: idle seconds}

    def idle_percent(self):
        """1 - busy / window, in % (None for an empty trace)."""
        if self.window_s <= 0 or self.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def op_seconds(self, substring: str) -> float:
        """Device seconds of the ops whose name holds ``substring``."""
        return sum(s for name, s in self.ops.items() if substring in name)

    def breakdown(self) -> dict:
        """The device ops that took most time (by short name) and the
        longest idle gaps by host label, at most ``TOP`` each."""
        ops = defaultdict(float)
        for name, sec in self.ops.items():
            ops[short_name(name)] += sec

        def top(d):
            return [[k, v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(self.gaps)}


def summarize(events, window_s: float) -> Summary:
    """Reduce profiler events (``prof.events()``) to a ``Summary``. The
    window opens at its ``START`` marker (at the first host event where
    there is none); its end gap is the idle time the others leave."""
    from torch.autograd import DeviceType
    dev, host = [], []
    opened = None
    for e in events:
        if getattr(e, "is_user_annotation", False) and \
                e.device_type != DeviceType.CPU:
            continue          # a range's device-side shadow spans its gaps
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            dev.append((a, b, e.name))
        elif e.name == START:
            opened = a
        elif e.device_type == DeviceType.CPU and e.name != END:
            host.append((a, b, e.name))
    ops = defaultdict(float)
    for a, b, name in dev:
        ops[name] += (b - a) / 1e6
    busy = union_seconds((a, b) for a, b, _ in dev) / 1e6
    gaps = defaultdict(float)
    if dev:
        host.sort()
        starts = [h[0] for h in host]
        merged, end = [], float("-inf")
        for a, b, _ in sorted(dev):
            if merged and a <= end:
                end = max(end, b)
                merged[-1][1] = end
            else:
                merged.append([a, b])
                end = b
        if opened is None:
            opened = min(starts[0], merged[0][0]) if starts \
                else merged[0][0]
        # (start, end, when to read the host's label): the window's head
        # is labelled by what the host did as the device started
        head = merged[0][0]
        spans = [(opened, head, head - 1)]
        spans += [(g0, g1, g0) for (_, g0), (g1, _) in
                  zip(merged, merged[1:])]
        inner = sum(max(g1 - g0, 0) for g0, g1, _ in spans) / 1e6
        # the end: what the window's length leaves after busy and the gaps
        tail = merged[-1][1]
        spans.append((tail, tail + 1e6 * (window_s - busy - inner), tail))
        for g0, g1, at in spans:
            gap = (g1 - g0) / 1e6
            if gap <= 0:
                continue
            if gap < SHORT_GAP_S:
                gaps[f"gaps under {SHORT_GAP_S * 1e6:.0f} us"] += gap
                continue
            gaps[_label(host, starts, at)] += gap
    return Summary(window_s, busy, dict(ops), dict(gaps))


def _label(host, starts, t, reach: int = 4000) -> str:
    """The shortest host event that covers time ``t``."""
    i = bisect.bisect_right(starts, t)
    best, best_len = "no host event", float("inf")
    for a, b, name in host[max(0, i - reach):i][::-1]:
        if b > t and b - a < best_len:
            best, best_len = name, b - a
    return best


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


class Window:
    """Profile from ``start()`` to ``stop()``; the ends are synchronized, so
    ``window_s`` is the traced window's length on the host's clock.
    ``warm()`` (in set-up) starts and stops the profiler once around a
    small device op, so that its one-time start (about a second) is not
    in the window."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.summary: Summary | None = None
        self._t0 = 0.0
        self.window_s = 0.0

    def warm(self) -> None:
        p = _profiler()
        p.start()
        torch.ones(1024, device=self.device).sum()
        sync(self.device)
        p.stop()
        p.events()

    def start(self) -> None:
        sync(self.device)
        self.prof = _profiler()
        self.prof.start()
        with span(START):
            pass
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        """Seconds since ``start()``."""
        return time.perf_counter() - self._t0

    def stop(self) -> None:
        sync(self.device)
        self.window_s = time.perf_counter() - self._t0
        with span(END):
            pass
        self.prof.stop()

    @property
    def pending(self) -> bool:
        """Not started yet."""
        return self.prof is None and not self.window_s

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.window_s

    def reduce(self) -> Summary:
        """Reduce the trace (once the measured window has closed)."""
        if self.summary is None:
            self.summary = summarize(self.prof.events(), self.window_s)
            self.prof = None
        return self.summary
