"""Select-neighbors heuristic (HNSW paper Alg. 4 / faiss
``shrink_neighbor_list``), ported from ``hnsw_tpu.ops.prune``.

Scanning candidates by increasing distance to the query, candidate c is
kept only if it is closer to the query than to every neighbor already kept,
until m are kept. The scan is sequential in the candidate position and
parallel over the batch. The scan order is a stable ascending sort of the
distances: ties go by candidate position, as ``counting_rank`` orders them
in the reference.
"""

from __future__ import annotations

import torch

from ..config import IP, L2

BIG = 1e30  # sort key of an invalid slot


def pairwise_candidate_distances(vecs: torch.Tensor,
                                 metric: str) -> torch.Tensor:
    """[B, C, d] -> [B, C, C] true metric distances between candidates."""
    v = vecs.float()
    dots = v @ v.transpose(1, 2)
    if metric == IP:
        return -dots
    sq = (v * v).sum(-1)
    return sq[:, :, None] + sq[:, None, :] - 2.0 * dots


def select_neighbors(cand_ids: torch.Tensor, cand_dists: torch.Tensor,
                     cand_vecs: torch.Tensor, *, m: int, metric: str = L2):
    """Prune candidate sets to <= m diversified neighbors.

    cand_ids int32 [B, C] (-1 = invalid, no duplicates within a row),
    cand_dists f32 [B, C] true metric distances to the query, cand_vecs
    [B, C, d]. Returns (kept_ids int32 [B, m] -1-padded in scan order,
    kept_mask bool [B, C] in the caller's candidate order)."""
    b, c = cand_ids.shape
    key = torch.where(cand_ids >= 0, torch.clamp(cand_dists, max=BIG / 2), BIG)
    order = torch.argsort(key, dim=1, stable=True)
    ids_s = torch.gather(cand_ids, 1, order)
    dist_s = torch.gather(key, 1, order)
    vecs_s = torch.gather(cand_vecs.float(), 1,
                          order[:, :, None].expand(-1, -1, cand_vecs.shape[2]))
    pair = pairwise_candidate_distances(vecs_s, metric)      # [B, C, C]
    valid_s = dist_s < BIG / 2

    kept = torch.zeros((b, c), dtype=torch.bool, device=cand_ids.device)
    count = torch.zeros(b, dtype=torch.int32, device=cand_ids.device)
    for j in range(c):
        # conflict: some kept i has dist(c_j, c_i) < dist(c_j, q)
        conflict = (kept & (pair[:, j, :] < dist_s[:, j, None])).any(1)
        take = valid_s[:, j] & ~conflict & (count < m)
        kept[:, j] = take
        count += take.to(torch.int32)

    # kept ids in scan order into m slots (surplus slots land in column m)
    slot = torch.where(kept, torch.cumsum(kept, 1) - 1, m)
    out = torch.full((b, m + 1), -1, dtype=torch.int32, device=cand_ids.device)
    out.scatter_(1, slot, torch.where(kept, ids_s, -1))
    kept_orig = torch.zeros_like(kept).scatter_(1, order, kept)
    return out[:, :m], kept_orig


def compact_append(cand_ids: torch.Tensor, width: int) -> torch.Tensor:
    """Move each row's valid (>= 0) ids to its first slots, in order; rows
    longer than ``width`` are truncated. [B, C] -> [B, width]."""
    cv = cand_ids >= 0
    rank = torch.cumsum(cv, 1) - 1
    slot = torch.where(cv & (rank < width), rank, width)
    out = torch.full((cand_ids.shape[0], width + 1), -1,
                     dtype=cand_ids.dtype, device=cand_ids.device)
    out.scatter_(1, slot, torch.where(cv, cand_ids, -1))
    return out[:, :width]
