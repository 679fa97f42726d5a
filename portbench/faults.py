"""Faults planted under the timed path, for the tests that see ``correct``
come out false once for each fault a cell can have. Each is a function
``plant(setattr)`` that breaks the program in this process through the
``setattr`` it is given (a test's ``monkeypatch.setattr``, or the builtin
in a follower, ``ranks.PLANTS``). A runner lists its cells' faults as
``FAULTS``: ``SEARCH`` for the search kinds, ``ADD`` for ingest.
"""

from __future__ import annotations

import numpy as np


def _index():
    from hnsw_tpu_torch.models.hnsw import HnswIndex
    return HnswIndex


def _rows(a, n):
    """The first ``n`` rows of ``a`` (an array or a tensor), repeated where
    it holds fewer; anything else as it is."""
    if a is None or not hasattr(a, "shape") or not a.ndim:
        return a
    reps = -(-n // len(a))
    if isinstance(a, np.ndarray):
        return np.concatenate([a] * reps)[:n]
    import torch
    return torch.cat([a] * reps)[:n]


def search_stale(setattr):
    """Every search answers with the first answer it gave."""
    cls = _index()
    real = cls.search

    def search(self, x, k, **kw):
        if not hasattr(self, "_pb_first"):
            self._pb_first = real(self, x, k, **kw)
        return tuple(_rows(o, len(x)) for o in self._pb_first)
    setattr(cls, "search", search)


def search_half(setattr):
    """The second half of the batch is left out: its rows repeat the first
    half's answers."""
    cls = _index()
    real = cls.search

    def search(self, x, k, **kw):
        h = max(len(x) // 2, 1)
        return tuple(_rows(o, len(x)) for o in real(self, x[:h], k, **kw))
    setattr(cls, "search", search)


def search_altered(setattr):
    """One id of each answer replaced by another id, its distance kept."""
    cls = _index()
    real = cls.search

    def search(self, x, k, **kw):
        out = list(real(self, x, k, **kw))
        ids = out[1].copy() if isinstance(out[1], np.ndarray) \
            else out[1].clone()
        ids[:, 0] = (ids[:, 0] + 1) % self.ntotal
        out[1] = ids
        return tuple(out)
    setattr(cls, "search", search)


def add_unchanged(setattr):
    """add() leaves the index as it was (after its first call)."""
    cls = _index()
    real = cls.add

    def add(self, x):
        if self.ntotal == 0:
            real(self, x)
    setattr(cls, "add", add)


def add_half(setattr):
    cls = _index()
    real = cls.add
    setattr(cls, "add", lambda self, x: real(self, x[:len(x) // 2]))


def add_altered(setattr):
    cls = _index()
    real = cls.add

    def add(self, x):
        x = np.array(x, np.float32)
        x[len(x) // 2] += 1.0
        real(self, x)
    setattr(cls, "add", add)


SEARCH = {"stale": search_stale, "half": search_half,
          "altered": search_altered}
ADD = {"unchanged": add_unchanged, "half": add_half, "altered": add_altered}
