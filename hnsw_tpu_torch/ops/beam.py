"""Fixed-width batched best-first beam search (faiss ``search_from_candidates``
as masked fixed-width tensors), ported from ``hnsw_tpu.ops.beam``.

Each query keeps one ascending top-ef buffer with an "expanded" flag per
slot; a candidate is fresh iff its id is not already in the buffer ("buffer"
visited mode: a node displaced from the buffer is worse than the buffer's
worst, so a re-encounter can never be expanded again) or, in "bitmap" mode,
iff its bit in a [Q, ceil(capacity/32)] visited bitmap is clear.

Two loops:

  * ``beam_search`` — the legacy multi-op hop with ``n_expand`` expansions
    per query per hop, "buffer" or "bitmap" visited mode, f32 or bf16 merge
    keys, and an optional filtered result buffer (``allowed``). Two uses:
    the build's insert beams run a fixed number of hops with no host read
    (a query whose buffer is fully expanded no longer changes, so the extra
    hops leave every result as the reference's run-to-convergence loop
    would); the search (``early_exit``) runs the reference's
    ``lax.while_loop`` with its condition ``any(~buf_exp) & hops <
    min(max_hops, hop_limit)`` on the device;
  * ``beam_search_fused`` — one expansion per hop, with all bookkeeping in
    K1's hop entry (``ops/beam_kernel.py`` ``beam_hop``): on the card a
    hop is the distance kernel and K1, two launches. Serving uses it when
    no legacy option is asked for. Its condition is the reference's
    ``any(cur >= 0) & hops < min(max_hops, hop_limit)``, on the device.

A search loop is run by a ``loop`` runner (``graphs.py``): in chunks of
steps with one host read of the condition after each, or captured into a
CUDA graph. A step taken once the condition is false leaves the state as
it was, so ``hops`` counts the iterations where the condition held, as the
reference's loop does. ``ef_live`` and ``hop_limit`` may be host ints or
0-d device tensors (a captured search reads them at replay).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..graphs import EagerLoop
from .beam_kernel import beam_hop

INF = float("inf")


@dataclasses.dataclass
class BeamState:
    buf_ids: torch.Tensor   # int32 [Q, ef] ascending by buf_dist; -1 empty
    buf_dist: torch.Tensor  # f32 or bf16 [Q, ef] (+inf for empty slots)
    buf_exp: torch.Tensor   # bool  [Q, ef] (True == expanded OR empty)
    hops: int | torch.Tensor  # loop iterations run for the batch (int32
    #                           0-d tensor from a search loop)
    ndis: torch.Tensor      # int32 [Q] distances computed per query
    visited: torch.Tensor | None = None   # int32 [Q, W] ("bitmap" mode)
    # filtered search: allowed candidates also compete for this result
    # top-k (f32 keys); None when no filter is active
    res_ids: torch.Tensor | None = None   # int32 [Q, k]
    res_dist: torch.Tensor | None = None  # f32   [Q, k]


def init_visited(q: int, capacity: int, device=None) -> torch.Tensor:
    """[Q, ceil(capacity/32)] zeroed 32-bit words (int32: bit 31 is the
    sign bit)."""
    return torch.zeros((q, (capacity + 31) // 32), dtype=torch.int32,
                       device=device)


def mark_visited(visited: torch.Tensor, ids: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Set the bits of ids [Q, K] where mask, IN PLACE (the bitmap is ~1 GB
    at 1M x 8192 queries; a copy per hop would double it), and return it.
    Ids must be unique within a row: an add of distinct bits is their OR
    (int32 adds wrap in two's complement, so bit 31 is exact too)."""
    safe = torch.where(mask, ids, 0).long()
    bit = torch.where(mask, 1 << (safe & 31), 0)                 # int64
    bit = torch.where(bit >= 1 << 31, bit - (1 << 32), bit).to(torch.int32)
    return visited.scatter_add_(1, safe >> 5, bit)


def test_visited(visited: torch.Tensor, ids: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """bool [Q, K]: True where the id is already visited (or masked off)."""
    safe = torch.where(mask, ids, 0).long()
    w = torch.gather(visited, 1, safe >> 5)
    seen = ((w >> (safe & 31)) & 1) == 1
    return torch.where(mask, seen, True)


def init_beam(entry_ids: torch.Tensor, entry_dists: torch.Tensor, ef: int,
              capacity: int = 0, active: torch.Tensor | None = None, *,
              visited_mode: str = "buffer",
              key_dtype: torch.dtype = torch.float32) -> BeamState:
    """Seed each query's buffer with one (already visited) entry point.

    ``active`` (bool [Q]): inactive queries start fully expanded. ``capacity``
    sizes the "bitmap" visited set. ``key_dtype``: the buffer distances'
    dtype (bf16 merge keys where the search asks for them; the build keeps
    f32, its buffer distances feed the neighbor selection)."""
    q = entry_ids.shape[0]
    dev = entry_ids.device
    if active is None:
        active = torch.ones(q, dtype=torch.bool, device=dev)
    buf_ids = torch.full((q, ef), -1, dtype=torch.int32, device=dev)
    buf_ids[:, 0] = torch.where(active, entry_ids, -1)
    buf_dist = torch.full((q, ef), INF, dtype=key_dtype, device=dev)
    buf_dist[:, 0] = torch.where(active, entry_dists.float(), INF)
    buf_exp = torch.ones((q, ef), dtype=torch.bool, device=dev)
    buf_exp[:, 0] = ~active
    visited = None
    if visited_mode == "bitmap":
        visited = mark_visited(init_visited(q, capacity, dev),
                               entry_ids[:, None], active[:, None])
    return BeamState(buf_ids, buf_dist, buf_exp, 0,
                     torch.zeros(q, dtype=torch.int32, device=dev), visited)


def attach_result_buffer(state: BeamState, k: int,
                         allowed: torch.Tensor) -> BeamState:
    """Enable filtered search: a separate [Q, k] result top-k collects only
    ids with allowed[id] True (the entry point too, when allowed). It keeps
    f32 keys even when the beam merges in bf16: it selects the final k."""
    q = state.buf_ids.shape[0]
    dev = state.buf_ids.device
    e_id = state.buf_ids[:, 0]
    ok = (e_id >= 0) & allowed[e_id.clamp(min=0).long()]
    res_ids = torch.full((q, k), -1, dtype=torch.int32, device=dev)
    res_ids[:, 0] = torch.where(ok, e_id, -1)
    res_dist = torch.full((q, k), INF, dtype=torch.float32, device=dev)
    res_dist[:, 0] = torch.where(ok, state.buf_dist[:, 0].float(), INF)
    return dataclasses.replace(state, res_ids=res_ids, res_dist=res_dist)


def _limit(max_hops: int, hop_limit):
    """min(max_hops, hop_limit) for a host int or 0-d tensor hop_limit."""
    if hop_limit is None:
        return max_hops
    if isinstance(hop_limit, torch.Tensor):
        return torch.clamp(hop_limit, max=max_hops)
    return min(max_hops, hop_limit)


def _legacy_hop(s: dict, gather_neighbors, distance_to, *, n_expand: int,
                visited_mode: str, allowed, ef_live, expand, live) -> dict:
    """One hop of the legacy beam on state ``s`` (the BeamState fields).
    ``live``: None (the build: every query steps, ``torch.topk`` picks the
    n_expand entries) or the search's 0-d bool condition (a stable sort
    picks them); a hop with ``live`` false expands nothing, and then every
    merge below keeps the sorted buffers as they are (a stable sort of a
    sorted buffer ++ +inf candidates), so the state comes back
    unchanged."""
    buf_ids, buf_dist, buf_exp = s["buf_ids"], s["buf_dist"], s["buf_exp"]
    visited, res_ids, res_dist = s["visited"], s["res_ids"], s["res_dist"]
    q, ef = buf_ids.shape
    key = torch.where(buf_exp, INF, buf_dist)
    if n_expand == 1:
        j = torch.argmin(key, dim=1, keepdim=True)               # first on ties
        sel = torch.gather(key, 1, j)
    elif live is not None:
        sel, j = torch.sort(key, dim=1, stable=True)
        sel, j = sel[:, :n_expand], j[:, :n_expand]
    else:
        sel, j = torch.topk(key, n_expand, dim=1, largest=False)
    step_ok = sel < INF                                          # [Q, T]
    if live is not None:
        step_ok = step_ok & live
    cur = torch.where(step_ok, torch.gather(buf_ids, 1, j), 0)
    buf_exp = buf_exp.scatter(1, j, torch.gather(buf_exp, 1, j) | step_ok)

    if expand is not None:
        nbrs, pre_dist = expand(cur, step_ok)                    # [Q, T, K]
    else:
        nbrs, pre_dist = gather_neighbors(cur), None
    k = nbrs.shape[2]
    nbrs = nbrs.reshape(q, -1)
    valid = (nbrs >= 0) & step_ok[:, :, None].expand(-1, -1, k).reshape(q, -1)
    if visited_mode == "bitmap":
        fresh = valid & ~test_visited(visited, nbrs, valid)
        if n_expand > 1:     # the same id under two parents in one hop
            fresh &= _first_occurrence_mask(torch.where(fresh, nbrs, -1))
        mark_visited(visited, nbrs, fresh)
    else:
        member = (nbrs[:, :, None] == buf_ids[:, None, :]).any(2)
        fresh = valid & ~member
    dist = torch.where(
        fresh, pre_dist if pre_dist is not None
        else distance_to(nbrs, fresh), INF)
    ndis = s["ndis"] + fresh.sum(1, dtype=torch.int32)

    all_d = torch.cat([buf_dist, dist.to(buf_dist.dtype)], 1)
    payload = torch.cat(
        [(buf_ids << 1) | buf_exp.to(torch.int32),
         (torch.where(fresh, nbrs, -1) << 1) | (~fresh).to(torch.int32)],
        1)
    sd, order = torch.sort(all_d, dim=1, stable=True)
    sp = torch.gather(payload, 1, order[:, :ef])
    buf_dist = sd[:, :ef]
    buf_ids = sp >> 1
    buf_exp = (sp & 1) == 1
    if ef_live is not None:
        dead = torch.arange(ef, device=buf_ids.device)[None, :] >= ef_live
        buf_dist = torch.where(dead, INF, buf_dist)
        buf_ids = torch.where(dead, -1, buf_ids)
        buf_exp = buf_exp | dead

    if allowed is not None:
        # dedup against the result buffer BEFORE the merge: a node
        # displaced from the beam can be re-encountered, and its copy
        # would evict a genuine rank-k entry
        res_ok = fresh & allowed[torch.where(fresh, nbrs, 0).long()]
        res_ok &= ~(nbrs[:, :, None] == res_ids[:, None, :]).any(2)
        if n_expand > 1:
            res_ok &= _first_occurrence_mask(
                torch.where(res_ok, nbrs, -1))
        rd = torch.cat([res_dist, torch.where(res_ok, dist, INF)], 1)
        ri = torch.cat([res_ids, torch.where(res_ok, nbrs, -1)], 1)
        rd, o = torch.sort(rd, dim=1, stable=True)
        kk = res_ids.shape[1]
        res_dist, res_ids = rd[:, :kk], torch.gather(ri, 1, o[:, :kk])
    hops = s["hops"] + (1 if live is None else live.to(torch.int32))
    return {"buf_ids": buf_ids, "buf_dist": buf_dist, "buf_exp": buf_exp,
            "hops": hops, "ndis": ndis, "visited": visited,
            "res_ids": res_ids, "res_dist": res_dist}


def beam_search(state: BeamState,
                gather_neighbors: Callable[[torch.Tensor], torch.Tensor],
                distance_to: Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor],
                max_hops: int, n_expand: int = 1, *,
                visited_mode: str = "buffer",
                allowed: torch.Tensor | None = None,
                ef_live=None, hop_limit=None,
                expand: Callable | None = None,
                early_exit: bool = False, bound: int | None = None,
                loop=None) -> BeamState:
    """Best-first hops until ``min(max_hops, hop_limit)``. With
    ``early_exit`` (the search) the loop also stops once every buffer is
    fully expanded: the condition is evaluated on the device and read by
    ``loop`` (``graphs.EagerLoop`` by default: once a chunk of hops), and
    ``bound`` is a static hop count that surely covers the loop (None:
    unknown). Without it (the build) every hop runs, with no host read.

    gather_neighbors: ids [Q, T] -> neighbor ids [Q, T, K] int32, -1-padded,
        duplicate-free per source node.
    distance_to: (ids [Q, T*K], fresh mask) -> f32 [Q, T*K] distances.
    n_expand: buffer entries expanded per hop per query (T). With
        ``early_exit`` ties among them break to the lower slot (a stable
        sort, as the reference's ``lax.top_k``); the build keeps
        ``torch.topk``.
    visited_mode: "buffer" (membership in the buffer) or "bitmap" (the
        exact visited set in ``state.visited``, updated in place; with
        n_expand > 1 only an id's first occurrence in a hop is fresh).
    allowed: bool [capacity]; fresh allowed candidates also merge into
        ``state.res_ids`` / ``res_dist`` (``attach_result_buffer``), each id
        once.
    ef_live: after each merge, slots >= ef_live are killed (None: none).
    expand: (cur [Q, T], step_ok [Q, T]) -> (nbrs [Q, T, K], dist [Q, T*K])
        replaces gather_neighbors + distance_to (packed rows: every
        candidate's distance comes from the expanded node's code row).
    The buffer keeps ``state.buf_dist``'s dtype (f32 or bf16 merge keys,
        a stable sort of buffer ++ candidates); the result buffer is f32.
    """
    s = dict(vars(state))
    limit = _limit(max_hops, hop_limit)
    kw = dict(n_expand=n_expand, visited_mode=visited_mode, allowed=allowed,
              ef_live=ef_live, expand=expand)
    if not early_exit:
        for _ in range(limit - s["hops"]):
            s = _legacy_hop(s, gather_neighbors, distance_to, live=None,
                            **kw)
    else:
        if not isinstance(s["hops"], torch.Tensor):
            # a fill, not a host-to-device copy (a capture has no copies)
            s["hops"] = torch.full((), s["hops"], dtype=torch.int32,
                                   device=state.buf_ids.device)

        def cond(s):
            return (~s["buf_exp"]).any() & (s["hops"] < limit)

        def step(s):
            return _legacy_hop(s, gather_neighbors, distance_to,
                               live=cond(s), **kw)

        s = (loop or EagerLoop()).run(cond, step, s, bound)
    return BeamState(**s)


def _device_int(v, device) -> torch.Tensor:
    """A host int or a 0-d tensor as a 0-d int64 tensor on ``device`` (a
    fill, not a host-to-device copy: a capture has no copies)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64).reshape(())
    return torch.full((), int(v), dtype=torch.int64, device=device)


def beam_search_fused(entry_ids: torch.Tensor, entry_dists: torch.Tensor,
                      neighbors0: torch.Tensor, dist: Callable, *, ef: int,
                      max_hops: int, ef_live=None, hop_limit=None,
                      bound: int | None = None, loop=None) -> BeamState:
    """Level-0 search, one expansion a hop, the reference's
    ``lax.while_loop`` run by ``loop`` (see ``beam_search``). A hop is
    ``dist(cur)`` and ``beam_hop``: on a CUDA device the distance kernel
    and K1's hop entry, which reads the expanded node's adjacency row
    ``neighbors0[cur]`` itself and updates the state in place; on the CPU
    their plain versions.

    dist(cur int32 [Q]) -> f32 [Q, K]: the distances of the K candidates
    of node ``cur[q]`` (its adjacency row's order); a cur of -1 marks a
    query that does not step, whose row is not read.
    Entries are [Q] or [Q, E] (E < ef), each row distance-sorted with -1 /
    inf for invalid seeds. Column 0 starts expanded with ``cur`` pointing at
    it; the other seeds wait unexpanded in the buffer. Seeds at columns >=
    ``ef_live`` are dropped, as the first hop's ef_live mask would.

    The condition is kept per query: a query steps while its cur is a node
    and its own hop count (``steps``) is below the limit. A query is live
    on a prefix of the batch's hops, so while it is live its steps equal
    the batch's hop count: the reference's condition holds exactly when
    some query steps, and the batch's ``hops`` is the largest ``steps``,
    read once after the loop. A hop past the condition changes nothing.
    ``ef_live`` (None: the whole buffer is live) and ``hop_limit`` may be
    host ints or 0-d device tensors (a captured search reads them at
    replay)."""
    if entry_ids.dim() == 1:
        entry_ids, entry_dists = entry_ids[:, None], entry_dists[:, None]
    q, e = entry_ids.shape
    if e >= ef:
        raise ValueError(f"{e} entry seeds do not fit an ef={ef} buffer")
    dev = entry_ids.device
    col = torch.arange(e, device=dev)[None, :]
    active = entry_ids >= 0
    if ef_live is not None:
        active = active & (col < ef_live)
    buf_d = torch.full((q, ef), INF, dtype=torch.float32, device=dev)
    buf_d[:, :e] = torch.where(active, entry_dists.float(), INF)
    buf_p = torch.full((q, ef), -1, dtype=torch.int32, device=dev)
    buf_p[:, :e] = torch.where(active, (entry_ids << 1) | (col == 0).int(), -1)
    s = {"buf_d": buf_d, "buf_p": buf_p,
         "cur": torch.where(active[:, 0], entry_ids[:, 0], -1).to(
             torch.int32),
         "ndis": torch.zeros(q, dtype=torch.int32, device=dev),
         "steps": torch.zeros(q, dtype=torch.int32, device=dev)}
    limit = _device_int(_limit(max_hops, hop_limit), dev)
    live = None if ef_live is None else _device_int(ef_live, dev)

    def cond(s):
        return ((s["cur"] >= 0) & (s["steps"] < limit)).any()

    def step(s):
        d, p, c, nd, st = beam_hop(s["buf_d"], s["buf_p"], s["cur"],
                                   s["ndis"], s["steps"], neighbors0,
                                   dist(s["cur"]), live, limit)
        return {"buf_d": d, "buf_p": p, "cur": c, "ndis": nd, "steps": st}

    s = (loop or EagerLoop()).run(cond, step, s, bound)
    buf_p, steps = s["buf_p"], s["steps"]
    hops = steps.max() if q else torch.zeros((), dtype=torch.int32,
                                              device=dev)
    return BeamState(buf_p >> 1, s["buf_d"], (buf_p & 1) == 1, hops,
                     s["ndis"])


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


def _first_occurrence_mask(ids: torch.Tensor) -> torch.Tensor:
    """bool [Q, K]: True at the first occurrence of each non-negative id in
    its row (an O(K^2) compare; K = n_expand * m0 is small)."""
    k = ids.shape[1]
    before = torch.ones((k, k), dtype=torch.bool, device=ids.device).tril(-1)
    earlier = ((ids[:, :, None] == ids[:, None, :]) & before).any(2)
    return (ids >= 0) & ~earlier
