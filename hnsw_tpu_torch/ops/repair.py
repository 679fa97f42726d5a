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
counted (``n_dropped``). The work is done only for owner rows (and the
prune only for rows that overflow), which gives the reference's result
without computing rows it would throw away.
"""

from __future__ import annotations

import torch

from ..config import L2
from .distances import decode_rows
from .prune import compact_append, select_neighbors

_PRUNE_BYTES = 1 << 30  # candidate-vector bytes gathered per prune chunk


def apply_backlinks(adj: torch.Tensor, dst_rows: torch.Tensor,
                    dst_ids: torch.Tensor, src_ids: torch.Tensor,
                    valid: torch.Tensor, vectors: torch.Tensor,
                    dequant=None, pq_cb=None, *, r_window: int = 16,
                    metric: str = L2):
    """adj int32 [n_rows, W]: adjacency of ONE level, updated in place (a
    view into a larger table is fine). dst_rows/dst_ids/src_ids int32 [P]:
    per pair the row in ``adj``, the destination's node id (for distances)
    and the source to link back; valid bool [P]. vectors [capacity, d]
    (sq8 codes with ``dequant`` = (offset, scale), PQ codes with ``pq_cb``
    = codebooks: the prune then measures against x̂).

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

    own = torch.nonzero(first).squeeze(1)                    # [F] owners
    row_idx = sdst_row[own]
    raw = own[:, None] + torch.arange(r, device=dev)[None, :]  # [F, R]
    widx = raw.clamp(max=p - 1)  # mask before clipping: the tail group
    inc_src = ssrc[widx]         # would otherwise see its last source twice
    inc_ok = (raw < p) & (sdst_row[widx] == row_idx[:, None]) & (inc_src >= 0)
    rows = adj[row_idx]                                          # [F, W]
    dup = (inc_src[:, :, None] == rows[:, None, :]).any(2)
    inc_src = torch.where(inc_ok & ~dup, inc_src, -1)
    cand = torch.cat([rows, inc_src], 1)                         # [F, W+R]
    new_rows = compact_append(cand, w)

    over = torch.nonzero((cand >= 0).sum(1) > w).squeeze(1)
    d_model = vectors.shape[1] if pq_cb is None else \
        pq_cb.shape[0] * pq_cb.shape[2]
    chunk = max(256, _PRUNE_BYTES // max(cand.shape[1] * d_model * 4, 1))
    for c0 in range(0, over.shape[0], chunk):
        sel = over[c0:c0 + chunk]
        ids_c = cand[sel]
        dvec = decode_rows(vectors[sdst_id[own[sel]].long()], dequant,
                           pq_cb)                                # [C, d]
        cvec = decode_rows(vectors[ids_c.clamp(min=0).long()], dequant,
                           pq_cb)                                # [C, W+R, d]
        dots = (cvec * dvec[:, None, :]).sum(-1)
        if metric == L2:
            cd = (dvec * dvec).sum(1, keepdim=True) + (cvec * cvec).sum(-1) \
                - 2.0 * dots
        else:
            cd = -dots
        new_rows[sel] = select_neighbors(ids_c, cd, cvec, m=w,
                                         metric=metric)[0]
    adj[row_idx] = new_rows
    return adj, n_dropped
