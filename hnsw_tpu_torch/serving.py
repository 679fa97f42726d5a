"""Serving front end, ported from ``hnsw_tpu.serving``: request
micro-batching over ``HnswIndex.search``.

A batched search is one pass of launches for the whole batch, so a serving
layer's job is to collect small requests into device-sized batches:

  * a request of any size is padded to a power-of-two size bucket (the
    last row repeated), so batch shapes repeat and so does the work a
    shape sets up;
  * many small requests can share one search (``submit`` + ``flush``),
    spreading the per-search host cost over their callers;
  * ``ef_search`` / ``max_hops`` are per-search values: changing them
    between requests costs nothing.

No threads are started here: a single caller drives ``search`` / ``flush``,
and callers that submit from several threads hold their own lock.

While tracing is on (``trace.py``) a flush is span ``hnsw.serve.flush``,
with ``hnsw.serve.concat``, its searches, ``hnsw.search.wait`` (the wait
for the device before the copies), ``hnsw.serve.download`` and
``hnsw.serve.split``; ``submit`` records nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import trace


def size_bucket(n: int, min_bucket: int = 64, max_bucket: int = 8192) -> int:
    """The next power of two >= n, clamped to [min_bucket, max_bucket]."""
    b = 1 << max(int(n - 1).bit_length(), 0)
    return int(min(max(b, min_bucket), max_bucket))


def _host(a) -> np.ndarray:
    """A search output (device tensor or numpy) as a host array."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class _Pending(NamedTuple):
    start: int   # row offset inside the coalesced batch
    n: int       # rows belonging to this request


class Searcher:
    """Micro-batching search front end over any index with
    ``search(x, k, ef_search=...)``.

    Direct mode, one request padded to its bucket::

        s = Searcher(index, k=10, ef_search=64)
        D, I = s.search(queries)          # any number of rows

    Coalescing mode, many requests in one search::

        h1 = s.submit(q_small_a)          # queues, returns a handle
        h2 = s.submit(q_small_b)
        s.flush()                         # ONE padded search
        D1, I1 = s.result(h1)
        D2, I2 = s.result(h2)
    """

    def __init__(self, index, k: int = 10, *, ef_search: int | None = None,
                 max_hops: int = 0, min_bucket: int = 64,
                 max_bucket: int = 8192):
        self.index = index
        self.k = int(k)
        self.ef_search = ef_search
        self.max_hops = int(max_hops)
        self.min_bucket = int(min_bucket)
        self.max_bucket = int(max_bucket)
        self._device_out = True   # falls to False on the first TypeError
        self._queue: list[np.ndarray] = []
        self._pending: dict[int, _Pending] = {}
        self._results: dict[int, tuple] = {}
        self._next_handle = 0
        self._queued_rows = 0
        # serving counters
        self.launches = 0
        self.queries_served = 0
        self.rows_padded = 0

    def _kw(self, ef_search=None) -> dict:
        kw = {}
        ef = ef_search if ef_search is not None else self.ef_search
        if ef is not None:
            kw["ef_search"] = int(ef)
        if self.max_hops:
            kw["max_hops"] = self.max_hops
        return kw

    def search(self, x: np.ndarray, *, k: int | None = None,
               ef_search: int | None = None):
        """One request: split into ``max_bucket``-row chunks, each padded
        to its bucket and searched; returns (D [n, k] f32, I [n, k] int64).
        Every chunk is searched before any result is copied to the host,
        with ``device_out`` where the index takes it; an index whose
        ``search`` does not take ``device_out`` (a TypeError) is called
        without it from then on."""
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        if x.ndim == 1:
            x = x[None]
        n = len(x)
        k = self.k if k is None else int(k)
        out_d = np.zeros((n, k), np.float32)
        out_i = np.zeros((n, k), np.int64)
        pending = []     # (start, rows, d, i)
        for s in range(0, n, self.max_bucket):
            chunk = x[s:s + self.max_bucket]
            b = size_bucket(len(chunk), self.min_bucket, self.max_bucket)
            pad = b - len(chunk)
            xb = np.concatenate([chunk, np.broadcast_to(
                chunk[-1:], (pad, x.shape[1]))]) if pad else chunk
            if self._device_out:
                try:
                    d, i = self.index.search(xb, k, device_out=True,
                                             **self._kw(ef_search))
                except TypeError:    # the index does not take device_out
                    self._device_out = False
            if not self._device_out:
                d, i = self.index.search(xb, k, **self._kw(ef_search))
            pending.append((s, len(chunk), d, i))
            self.launches += 1
            self.rows_padded += pad
        if pending:
            trace.wait(pending[0][2])
        with trace.span("hnsw.serve.download"):
            for s, nr, d, i in pending:
                out_d[s:s + nr] = _host(d)[:nr]
                out_i[s:s + nr] = _host(i)[:nr]
        self.queries_served += n
        return out_d, out_i

    def submit(self, x: np.ndarray) -> int:
        """Queue a request; returns a handle for ``result()``. Flushes by
        itself once the queue holds ``max_bucket`` rows."""
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        if x.ndim == 1:
            x = x[None]
        h = self._next_handle
        self._next_handle += 1
        self._pending[h] = _Pending(self._queued_rows, len(x))
        self._queue.append(x)
        self._queued_rows += len(x)
        if self._queued_rows >= self.max_bucket:
            self.flush()
        return h

    def flush(self) -> None:
        """Search everything queued in one (or a few) padded searches."""
        if not self._queue:
            return
        with trace.span("hnsw.serve.flush"):
            with trace.span("hnsw.serve.concat"):
                x = np.concatenate(self._queue, axis=0)
            pend, self._pending = self._pending, {}
            self._queue, self._queued_rows = [], 0
            d, i = self.search(x)
            with trace.span("hnsw.serve.split"):
                for h, p in pend.items():
                    self._results[h] = (d[p.start:p.start + p.n],
                                        i[p.start:p.start + p.n])

    def result(self, handle: int):
        """(D, I) of a submitted request; flushes if it is still queued."""
        if handle in self._pending:
            self.flush()
        return self._results.pop(handle)

    @property
    def stats(self) -> dict:
        return {"launches": self.launches,
                "queries_served": self.queries_served,
                "rows_padded": self.rows_padded}
