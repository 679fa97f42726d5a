"""The comparison that decides ``correct``: the program's outputs against
the plain reference (``reference.py``), each number beside its limit.

Every number here is worked out by the reference from the benchmark's own
data; the program's outputs (ids, distances, stored rows, adjacency) are
only read, to be judged.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference

CHUNK_ROWS = 1 << 20        # answered query rows moved to the device at once
GAP_ROWS = 1 << 14          # answered rows whose distances are worked at once


class Answers:
    """Search answers as the harness kept them: for each request the first
    row of its queries in the query pool, and the program's distances and
    ids (host arrays [rows, k])."""

    def __init__(self):
        self.start: list[int] = []
        self.d: list[np.ndarray] = []
        self.i: list[np.ndarray] = []

    def add(self, start: int, d, i) -> None:
        self.start.append(int(start))
        self.d.append(d)
        self.i.append(i)

    def __len__(self) -> int:
        return len(self.start)


def _dev_ids(parts, device) -> torch.Tensor:
    return torch.from_numpy(np.concatenate(parts).astype(np.int64)).to(device)


def bad_ids(ids: torch.Tensor, dists: torch.Tensor, n: int) -> int:
    """Returned entries that are no answer: an id outside [0, n), a
    distance that is not finite, or an id twice in one row."""
    bad = (ids < 0) | (ids >= n) | ~torch.isfinite(dists)
    s = torch.sort(ids, dim=1).values
    dup = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)
    return int(bad.sum()) + int(dup.sum())


def recall_and_bad(answers: Answers, truth: torch.Tensor, n: int) -> tuple:
    """(recall@k over every answered query, bad entries) against the
    reference's exact ids ``truth`` [pool, k]."""
    dev = truth.device
    k = truth.shape[1]
    hit = bad = rows = 0
    parts_i, parts_d, parts_r = [], [], []
    held = 0

    def flush():
        nonlocal hit, bad, rows
        if not parts_i:
            return
        ids = _dev_ids(parts_i, dev)
        ds = torch.from_numpy(np.concatenate(parts_d)).to(dev)
        where = _dev_ids(parts_r, dev)
        hit += reference.hits(ids, truth[where])
        bad += bad_ids(ids, ds, n)
        rows += len(ids)
        parts_i.clear(), parts_d.clear(), parts_r.clear()

    for s, d, i in zip(answers.start, answers.d, answers.i):
        parts_i.append(i[:, :k])
        parts_d.append(d[:, :k])
        parts_r.append(np.arange(s, s + len(i)))
        held += len(i)
        if held >= CHUNK_ROWS:
            flush()
            held = 0
    flush()
    return hit / max(rows * k, 1), bad


def dist_gap(answers: Answers, which, queries: torch.Tensor,
             stored: torch.Tensor) -> float:
    """The widest gap between a returned distance and the reference's
    squared L2 (float64) from the query to the stored row of the returned
    id (f32 rows, or x̂ re-derived for sq8), over the answers ``which``;
    as a share of the larger of that distance and the median of them."""
    dev = queries.device
    n = len(stored)
    if not len(which):
        return float("inf")
    ids = _dev_ids([answers.i[a] for a in which], dev)
    ds = torch.from_numpy(np.concatenate(
        [answers.d[a] for a in which])).to(dev).double()
    q_rows = _dev_ids([np.arange(answers.start[a],
                                 answers.start[a] + len(answers.i[a]))
                       for a in which], dev)
    got, want = [], []
    for r0 in range(0, len(ids), GAP_ROWS):
        i = ids[r0:r0 + GAP_ROWS]
        ok = (i >= 0) & (i < n)
        ref = reference.pair_dist(queries[q_rows[r0:r0 + GAP_ROWS]],
                                  stored[i.clamp(0, n - 1)])
        got.append(ds[r0:r0 + GAP_ROWS][ok])
        want.append(ref[ok])
    got, want = torch.cat(got), torch.cat(want)
    if not len(got):
        return float("inf")
    med = want.median()
    gap = (got - want).abs() / torch.maximum(want.abs(), med)
    return float(gap.max())


def sample_answers(n_answers: int, rows_each, want_rows: int,
                   gen: np.random.Generator) -> list:
    """Answers drawn from the seed, in a random order, until they hold
    ``want_rows`` query rows (all of them if they hold fewer)."""
    order = gen.permutation(n_answers)
    out, rows = [], 0
    for a in order:
        out.append(int(a))
        rows += rows_each(int(a))
        if rows >= want_rows:
            break
    return sorted(out)


def bad_links(nbrs: torch.Tensor, ntotal: int) -> int:
    """Level-0 adjacency entries that are no link: an id outside [-1,
    ntotal) (-1 pads a row), a node linked to itself, or an id twice in
    one row."""
    own = torch.arange(len(nbrs), device=nbrs.device)[:, None]
    bad = (nbrs < -1) | (nbrs >= ntotal) | (nbrs == own)
    s = torch.sort(nbrs, dim=1).values
    dup = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)
    return int(bad.sum()) + int(dup.sum())


class Verdict:
    """The numbers compared, each beside its limit."""

    def __init__(self):
        self.items: list[tuple] = []     # (name, value, op, limit)

    def add(self, name: str, value, op: str, limit) -> None:
        self.items.append((name, value, op, limit))

    @staticmethod
    def _holds(value, op, limit) -> bool:
        if value is None or (isinstance(value, float) and np.isnan(value)):
            return False
        return value <= limit if op == "<=" else value >= limit

    @property
    def correct(self) -> bool:
        return bool(self.items) and all(
            self._holds(v, op, lim) for _, v, op, lim in self.items)

    def as_json(self) -> dict:
        return {name: {"value": v, "limit": f"{op} {lim}"}
                for name, v, op, lim in self.items}

    def lines(self) -> list[str]:
        return [f"check {name}: {v} (limit {op} {lim}) "
                f"{'ok' if self._holds(v, op, lim) else 'FAILED'}"
                for name, v, op, lim in self.items]
