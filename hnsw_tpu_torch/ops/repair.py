"""Batched back-link application (faiss ``add_with_locks`` back-links, with
no locks), ported from ``hnsw_tpu.ops.repair``.

For a whole insert batch of (destination t, source p) pairs at one level:

  1. sort the pairs by destination row (stable);
  2. the first pair of each destination owns the group;
  3. per owner: t's current row plus up to R windowed incoming sources,
     minus sources already in the row; append if that fits the row width W,
     else prune to W with the select-neighbors heuristic around t's vector
     (faiss shrink semantics: prune only on overflow);
  4. write the new rows back — one writer per destination.

Sources beyond the R-window of their group are dropped for this batch and
counted (``n_dropped``). Every shape is fixed by the pair count P, as in
the reference, so an insert batch can be captured as one CUDA graph: each
sorted pair computes its window row, the prune runs over all P rows in a
static number of chunks (rows that are not an overflowing owner prune an
empty candidate list, whose gathers all read row 0), and each pair writes
its group owner's row, so a row's writers all write the same values.
"""

from __future__ import annotations

import torch

from ..config import L2
from .prune import compact_append, select_neighbors
from .storage import Storage

_PRUNE_BYTES = 1 << 30  # candidate-vector bytes gathered per prune chunk


def apply_backlinks(adj: torch.Tensor, dst_rows: torch.Tensor,
                    dst_ids: torch.Tensor, src_ids: torch.Tensor,
                    valid: torch.Tensor, storage: Storage, *,
                    r_window: int = 16, metric: str = L2):
    """adj int32 [n_rows, W]: adjacency of ONE level, updated in place (a
    view into a larger table is fine). dst_rows/dst_ids/src_ids int32 [P]:
    per pair the row in ``adj``, the destination's node id (for distances)
    and the source to link back; valid bool [P]. ``storage``: the stored
    rows and their codec (the prune measures against x̂).

    Returns (adj, n_dropped) with n_dropped an int64 0-d tensor: valid pairs
    beyond the R-window of their destination (duplicates are not drops)."""
    p = dst_rows.shape[0]
    w = adj.shape[1]
    dev = adj.device
    if p == 0:
        return adj, torch.zeros((), dtype=torch.int64, device=dev)
    r = min(r_window, p)
    big = 2 ** 31 - 1
    key = torch.where(valid, dst_rows.long(), big)
    order = torch.argsort(key, stable=True)
    sdst_row = key[order]
    sdst_id = torch.where(valid, dst_ids, -1)[order]
    ssrc = torch.where(valid, src_ids, -1)[order]

    pos = torch.arange(p, device=dev)
    prev = torch.cat([torch.full((1,), -1, dtype=torch.int64, device=dev),
                      sdst_row[:-1]])
    svalid = sdst_row < big
    first = svalid & (sdst_row != prev)
    group_start = torch.cummax(torch.where(first, pos, -1), 0).values
    n_dropped = (svalid & (pos - group_start >= r)).sum()

    # every pair's window over the sorted pairs; only an owner's is written
    raw = pos[:, None] + torch.arange(r, device=dev)[None, :]    # [P, R]
    widx = raw.clamp(max=p - 1)  # mask before clipping: the tail group
    inc_src = ssrc[widx]         # would otherwise see its last source twice
    inc_ok = (raw < p) & (sdst_row[widx] == sdst_row[:, None]) & \
        svalid[:, None] & (inc_src >= 0)
    rows = adj[torch.where(svalid, sdst_row, 0)]                  # [P, W]
    dup = (inc_src[:, :, None] == rows[:, None, :]).any(2)
    inc_src = torch.where(inc_ok & ~dup, inc_src, -1)
    cand = torch.cat([rows, inc_src], 1)                         # [P, W+R]
    new_rows = compact_append(cand, w)

    # the heuristic prune of the owners that overflow, in static chunks
    over = first & ((cand >= 0).sum(1) > w)
    prune_ids = torch.where(over[:, None], cand, -1)
    prune_dst = torch.where(over, sdst_id, 0).long()
    chunk = max(256, _PRUNE_BYTES // max(cand.shape[1] * storage.dim * 4, 1))
    for c0 in range(0, p, chunk):
        ids_c = prune_ids[c0:c0 + chunk]
        dvec = storage.read(prune_dst[c0:c0 + chunk])            # [C, d]
        cvec = storage.read(ids_c.clamp(min=0).long())           # [C, W+R, d]
        dots = (cvec * dvec[:, None, :]).sum(-1)
        if metric == L2:
            cd = (dvec * dvec).sum(1, keepdim=True) + (cvec * cvec).sum(-1) \
                - 2.0 * dots
        else:
            cd = -dots
        pruned = select_neighbors(ids_c, cd, cvec, m=w, metric=metric)[0]
        new_rows[c0:c0 + chunk] = torch.where(
            over[c0:c0 + chunk, None], pruned, new_rows[c0:c0 + chunk])

    # each pair writes its group owner's row (invalid pairs, sorted last,
    # the last group's); with no valid pair every one writes row 0 back
    own = group_start.clamp(min=0)
    any_valid = group_start >= 0
    tgt = torch.where(any_valid, sdst_row[own], 0)
    adj[tgt] = torch.where(any_valid[:, None], new_rows[own], adj[0])
    return adj, n_dropped
