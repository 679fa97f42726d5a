"""A run with the timed path broken underneath comes out as not correct,
once for each fault a cell can have: a step that returns its state
unchanged, half of the batch left out, and an answer altered where it is
produced. (One card: there is no exchange between chips to leave out.)"""

import numpy as np
import pytest

import pb_tiny
from hnsw_tpu_torch.models.hnsw import HnswIndex

REAL_SEARCH = HnswIndex.search
REAL_ADD = HnswIndex.add


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


def _search_stale(self, x, k, **kw):
    """Every search answers with the first answer it gave."""
    if not hasattr(self, "_pb_first"):
        self._pb_first = REAL_SEARCH(self, x, k, **kw)
    return tuple(_rows(o, len(x)) for o in self._pb_first)


def _search_half(self, x, k, **kw):
    """The second half of the batch is left out: its rows repeat the first
    half's answers."""
    h = max(len(x) // 2, 1)
    return tuple(_rows(o, len(x)) for o in REAL_SEARCH(self, x[:h], k, **kw))


def _search_altered(self, x, k, **kw):
    """One id of each answer replaced by another id, its distance kept."""
    out = list(REAL_SEARCH(self, x, k, **kw))
    ids = out[1]
    if isinstance(ids, np.ndarray):
        ids = ids.copy()
        ids[:, 0] = (ids[:, 0] + 1) % self.ntotal
    else:
        ids = ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % self.ntotal
    out[1] = ids
    return tuple(out)


def _add_unchanged(self, x):
    """add() leaves the index as it was (after its first call)."""
    if self.ntotal == 0:
        REAL_ADD(self, x)


def _add_half(self, x):
    REAL_ADD(self, x[:len(x) // 2])


def _add_altered(self, x):
    x = np.array(x, np.float32)
    x[len(x) // 2] += 1.0
    REAL_ADD(self, x)


SEARCH_FAULTS = {"stale": _search_stale, "half": _search_half,
                 "altered": _search_altered}
ADD_FAULTS = {"unchanged": _add_unchanged, "half": _add_half,
              "altered": _add_altered}
CASES = [(c, f) for c in pb_tiny.CELLS
         for f in (ADD_FAULTS if "ingest" in c else SEARCH_FAULTS)]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    if "ingest" in cell:
        monkeypatch.setattr(HnswIndex, "add", ADD_FAULTS[fault])
    else:
        monkeypatch.setattr(HnswIndex, "search", SEARCH_FAULTS[fault])
    out, lines = pb_tiny.run(cell, seconds=1.0)
    assert out["correct"] is False, lines
