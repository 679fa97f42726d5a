"""Fixed-width batched best-first beam search (faiss ``search_from_candidates``
as masked fixed-width tensors), ported from ``hnsw_tpu.ops.beam``.

Each query keeps one ascending top-ef buffer with an "expanded" flag per
slot; a candidate is fresh iff its id is not already in the buffer ("buffer"
visited mode: a node displaced from the buffer is worse than the buffer's
worst, so a re-encounter can never be expanded again).

Two loops:

  * ``beam_search`` — the legacy multi-op hop with ``n_expand`` expansions
    per query per hop. The build's insert beams use it. It runs a fixed
    number of hops with no host read: a query whose buffer is fully expanded
    no longer changes, so the extra hops leave every result as the
    reference's run-to-convergence loop would.
  * ``beam_search_fused`` — one expansion per hop, with all bookkeeping in
    the K1 kernel (``ops/beam_kernel.py``). Serving uses it. It reads
    ``(cur >= 0).any()`` once per hop, so ``hops`` equals the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .beam_kernel import beam_update

INF = float("inf")


@dataclasses.dataclass
class BeamState:
    buf_ids: torch.Tensor   # int32 [Q, ef] ascending by buf_dist; -1 empty
    buf_dist: torch.Tensor  # f32   [Q, ef] (+inf for empty slots)
    buf_exp: torch.Tensor   # bool  [Q, ef] (True == expanded OR empty)
    hops: int               # loop iterations run for the batch
    ndis: torch.Tensor      # int32 [Q] distances computed per query


def init_beam(entry_ids: torch.Tensor, entry_dists: torch.Tensor,
              ef: int) -> BeamState:
    """Seed each query's buffer with one (already visited) entry point. The
    reference's ``active`` mask is not needed: the build passes only the
    rows that take part."""
    q = entry_ids.shape[0]
    dev = entry_ids.device
    buf_ids = torch.full((q, ef), -1, dtype=torch.int32, device=dev)
    buf_ids[:, 0] = entry_ids
    buf_dist = torch.full((q, ef), INF, dtype=torch.float32, device=dev)
    buf_dist[:, 0] = entry_dists.float()
    buf_exp = torch.ones((q, ef), dtype=torch.bool, device=dev)
    buf_exp[:, 0] = False
    return BeamState(buf_ids, buf_dist, buf_exp, 0,
                     torch.zeros(q, dtype=torch.int32, device=dev))


def beam_search(state: BeamState,
                gather_neighbors: Callable[[torch.Tensor], torch.Tensor],
                distance_to: Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor],
                max_hops: int, n_expand: int = 1,
                ef_live: int | None = None) -> BeamState:
    """Run ``max_hops`` best-first hops ("buffer" visited mode, f32 keys).
    ``max_hops`` is the hop cap: the reference's static bound and traced
    ``hop_limit`` are one host int here.

    gather_neighbors: ids [Q, T] -> neighbor ids [Q, T, K] int32, -1-padded,
        duplicate-free per source node.
    distance_to: (ids [Q, T*K], fresh mask) -> f32 [Q, T*K] distances.
    n_expand: buffer entries expanded per hop per query (T).
    ef_live: after each merge, slots >= ef_live are killed.
    """
    buf_ids, buf_dist, buf_exp = state.buf_ids, state.buf_dist, state.buf_exp
    ndis = state.ndis
    q, ef = buf_ids.shape
    pos = torch.arange(ef, device=buf_ids.device)[None, :]
    for _ in range(max_hops):
        key = torch.where(buf_exp, INF, buf_dist)
        if n_expand == 1:
            j = torch.argmin(key, dim=1, keepdim=True)
            sel = torch.gather(key, 1, j)
        else:
            sel, j = torch.topk(key, n_expand, dim=1, largest=False)
        step_ok = sel < INF                                      # [Q, T]
        cur = torch.where(step_ok, torch.gather(buf_ids, 1, j), 0)
        buf_exp = buf_exp.scatter(1, j, torch.gather(buf_exp, 1, j) | step_ok)

        nbrs = gather_neighbors(cur)                             # [Q, T, K]
        k = nbrs.shape[2]
        nbrs = nbrs.reshape(q, -1)
        valid = (nbrs >= 0) & step_ok.repeat_interleave(k, dim=1)
        member = (nbrs[:, :, None] == buf_ids[:, None, :]).any(2)
        fresh = valid & ~member
        dist = torch.where(fresh, distance_to(nbrs, fresh), INF)
        ndis = ndis + fresh.sum(1, dtype=torch.int32)

        all_d = torch.cat([buf_dist, dist], 1)
        payload = torch.cat(
            [(buf_ids << 1) | buf_exp.to(torch.int32),
             (torch.where(fresh, nbrs, -1) << 1) | (~fresh).to(torch.int32)],
            1)
        sd, order = torch.sort(all_d, dim=1, stable=True)
        sp = torch.gather(payload, 1, order[:, :ef])
        buf_dist = sd[:, :ef]
        buf_ids = sp >> 1
        buf_exp = (sp & 1) == 1
        if ef_live is not None and ef_live < ef:
            dead = pos >= ef_live
            buf_dist = torch.where(dead, INF, buf_dist)
            buf_ids = torch.where(dead, -1, buf_ids)
            buf_exp = buf_exp | dead
    return BeamState(buf_ids, buf_dist, buf_exp, state.hops + max_hops, ndis)


def beam_search_fused(entry_ids: torch.Tensor, entry_dists: torch.Tensor,
                      expand: Callable, *, ef: int, max_hops: int,
                      ef_live: int, hop_limit: int) -> BeamState:
    """Level-0 search with one K1 launch per hop.

    expand(cur [Q], step_ok [Q]) -> (nbrs int32 [Q, K], dist f32 [Q, K]).
    Entries are [Q] or [Q, E] (E < ef), each row distance-sorted with -1 /
    inf for invalid seeds. Column 0 starts expanded with ``cur`` pointing at
    it; the other seeds wait unexpanded in the buffer. Seeds at columns >=
    ``ef_live`` are dropped, as the first hop's ef_live mask would."""
    if entry_ids.dim() == 1:
        entry_ids, entry_dists = entry_ids[:, None], entry_dists[:, None]
    q, e = entry_ids.shape
    if e >= ef:
        raise ValueError(f"{e} entry seeds do not fit an ef={ef} buffer")
    dev = entry_ids.device
    col = torch.arange(e, device=dev)[None, :]
    active = (entry_ids >= 0) & (col < ef_live)
    buf_d = torch.full((q, ef), INF, dtype=torch.float32, device=dev)
    buf_d[:, :e] = torch.where(active, entry_dists.float(), INF)
    buf_p = torch.full((q, ef), -1, dtype=torch.int32, device=dev)
    buf_p[:, :e] = torch.where(active, (entry_ids << 1) | (col == 0).int(), -1)
    cur = torch.where(active[:, 0], entry_ids[:, 0], -1).to(torch.int32)
    ndis = torch.zeros(q, dtype=torch.int32, device=dev)
    hops = 0
    while hops < min(max_hops, hop_limit) and bool((cur >= 0).any()):
        step_ok = cur >= 0
        nbrs, dist = expand(torch.where(step_ok, cur, 0), step_ok)
        nbrs = torch.where((nbrs >= 0) & step_ok[:, None], nbrs, -1)
        buf_d, buf_p, cur, nd = beam_update(buf_d, buf_p, nbrs,
                                            dist.contiguous(), ef_live)
        ndis += nd
        hops += 1
    return BeamState(buf_p >> 1, buf_d, (buf_p & 1) == 1, hops, ndis)


def dedup_sorted_buffer(buf_ids: torch.Tensor, buf_dist: torch.Tensor):
    """Collapse duplicate ids in a distance-sorted buffer: a (dist, id)
    two-key sort makes duplicates adjacent even among equal distances; they
    are masked and pushed to the end as (-1, inf). Returns (ids, dists)."""
    o = torch.argsort(buf_ids, dim=1, stable=True)
    ids, d = torch.gather(buf_ids, 1, o), torch.gather(buf_dist, 1, o)
    d, o = torch.sort(d, dim=1, stable=True)
    ids = torch.gather(ids, 1, o)
    prev = torch.cat([torch.full_like(ids[:, :1], -2), ids[:, :-1]], 1)
    dup = (ids == prev) & (ids >= 0)
    d = torch.where(dup, INF, d)
    ids = torch.where(dup, -1, ids)
    d, o = torch.sort(d, dim=1, stable=True)
    return torch.gather(ids, 1, o), d
