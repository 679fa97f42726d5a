"""Batched distances and the exact brute-force top-k (the recall oracle).

Distance conventions (smaller == closer, everywhere in this package):
  * l2: squared L2  ||q - x||^2
  * ip: negated inner product  -<q, x>   (so argmin == max inner product)

The q·x term is one float32 matrix product; the package turns TF32 off at
import, so on the card it runs in full float32 like the reference's
``Precision.HIGHEST``.
"""

from __future__ import annotations

import torch

from ..config import IP, L2


def pairwise_distances(queries: torch.Tensor, base: torch.Tensor, metric: str,
                       base_sqnorms: torch.Tensor | None = None) -> torch.Tensor:
    """[Q, d] x [N, d] -> [Q, N] distances. For L2 the ||q||^2 term is left
    out (constant per query: rankings are unchanged; ``true_l2`` adds it)."""
    dots = queries.float() @ base.float().T
    if metric == IP:
        return -dots
    if base_sqnorms is None:
        base_sqnorms = (base.float() ** 2).sum(-1)
    return base_sqnorms[None, :] - 2.0 * dots


def decode_rows(rows: torch.Tensor, dequant=None, pq=None) -> torch.Tensor:
    """Stored rows -> f32 vectors: PQ codes decoded with the codebooks
    ``pq``, sq8 codes through the affine ``dequant`` = (offset, scale) (x̂
    for a codec), f32 and bf16 rows as f32."""
    if pq is not None:
        from .pq import decode_pq
        return decode_pq(rows, pq)
    v = rows.float()
    return v if dequant is None else dequant[0] + dequant[1] * v


def true_l2(ranked_dist: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Surrogate ||x||^2 - 2 q·x back to squared L2 by adding ||q||^2."""
    return ranked_dist + (queries.float() ** 2).sum(-1, keepdim=True)


def brute_force_topk(queries: torch.Tensor, base: torch.Tensor, k: int,
                     metric: str = L2, *, tile_n: int = 65536,
                     tile_q: int = 4096,
                     n_valid: int | None = None, dequant=None, pq=None):
    """Exact k-NN: (dists [Q, k], ids [Q, k] int64), ascending, true squared
    L2 for l2. Rows >= ``n_valid`` are excluded. The base is streamed in
    ``tile_n``-row tiles with a running top-k merge, and the queries in
    ``tile_q``-row tiles, so the [tile_q, tile_n] distance block bounds the
    memory. Slots that never saw a valid row return (inf, -1).

    ``dequant`` = (offset [d], scale [d]) when ``base`` holds sq8 codes,
    ``pq`` = codebooks [m_sub, ksub, dsub] when it holds PQ codes: each
    tile is decoded to x̂ when it is read (never an f32 copy of the table),
    which makes this the exact oracle over x̂ of a codec index."""
    from .pq import pq_sqnorms

    n = base.shape[0] if n_valid is None else min(int(n_valid), base.shape[0])
    queries = queries.float()

    def read_tile(n0):
        """(x̂ [t, d], ||x̂||² [t]) of base rows n0 .. n0 + tile_n."""
        t = base[n0:min(n0 + tile_n, n)]
        x = decode_rows(t, dequant, pq)
        return x, pq_sqnorms(t, pq) if pq is not None else (x * x).sum(-1)

    out_d, out_i = [], []
    for q0 in range(0, queries.shape[0], tile_q):
        qt = queries[q0:q0 + tile_q]
        best_d = torch.full((qt.shape[0], k), float("inf"), device=qt.device)
        best_i = torch.full((qt.shape[0], k), -1, dtype=torch.int64,
                            device=qt.device)
        for n0 in range(0, n, tile_n):
            tile, tile_sq = read_tile(n0)
            dm = pairwise_distances(qt, tile, metric, tile_sq)
            kk = min(k, dm.shape[1])
            td, ti = torch.topk(dm, kk, dim=1, largest=False, sorted=True)
            d = torch.cat([best_d, td], 1)
            i = torch.cat([best_i, ti + n0], 1)
            sd, order = torch.sort(d, dim=1, stable=True)
            best_d, best_i = sd[:, :k], torch.gather(i, 1, order[:, :k])
        best_i = torch.where(torch.isposinf(best_d), -1, best_i)
        if metric == L2:
            best_d = torch.where(best_i >= 0, true_l2(best_d, qt), best_d)
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)
