"""Product quantization (faiss ``ProductQuantizer`` / ``IndexHNSWPQ``),
ported from ``hnsw_tpu.ops.pq``.

The d-dim space is split into ``m_sub`` contiguous subspaces of ``dsub = d /
m_sub`` dims; each has a k-means codebook of ``ksub`` centroids (256 for
8-bit codes, the faiss default; 16 for 4-bit), and a vector is stored as
``m_sub`` uint8 codes. Every distance is the ADC value, exact between the
raw query and the reconstruction x̂, so the engine is exact over x̂.

Distances carry the package's surrogate: a LUT entry is ``||c||² − 2 q_m·c``
(IP: ``−q_m·c``), and its sum over the subspaces is ``||x̂||² − 2 q·x̂``.

The reference computes everything here through XLA (no Pallas kernel), so
the port runs it as PyTorch ops on the tensors' device. Three choices
differ:

  * the search and the build take ADC distances as table lookups
    (``pq_lut`` once per query batch, then ``adc_distance`` per hop), not
    the reference's one-hot decode and contraction (a TPU choice that
    would materialise [Q, K, m, ksub] f32, 6.4 GB at Q=8192, K=64, m=12):
    on an H100 the lookups with the table made in the same call ran 11.6x
    faster than decode + contract at that shape (PERF.md). Both are
    the exact ADC value in f32, summed in another order;
  * ``decode_pq`` is an index gather of codebook rows (exact), so
    ``adc_decode_distance`` gives the reference's ``exact=True`` values for
    either ``exact``;
  * ``train_pq`` runs its Lloyd steps on the given device; the sample, the
    initial codebooks and the empty-cluster restarts come from the same
    numpy generator as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import IP
from ._cuda import default_device
from .distances import decode_rows

KSUB = 256  # 8 bits per sub-code (faiss default); 16 (4 bits) works
# everywhere too: every consumer takes ksub from the codebook shape


def split_sub(x: torch.Tensor, m_sub: int) -> torch.Tensor:
    """[..., d] -> [..., m_sub, dsub], the contiguous subspace view."""
    return x.reshape(*x.shape[:-1], m_sub, x.shape[-1] // m_sub)


def _assign_update(xs: torch.Tensor, cb: torch.Tensor, *, chunk: int):
    """One Lloyd step over every subspace at once, over ``chunk`` rows at a
    time. xs f32 [n, m, dsub], cb f32 [m, ksub, dsub]. Returns (sums [m,
    ksub, dsub], counts [m, ksub], sse []); the caller divides and handles
    empty clusters. Sums are a one-hot product (deterministic on the card,
    where an atomic scatter would not be)."""
    n, m, dsub = xs.shape
    ksub = cb.shape[1]
    cb_sq = (cb * cb).sum(-1)                                    # [m, ksub]
    sums = torch.zeros((m, ksub, dsub), dtype=torch.float32, device=xs.device)
    counts = torch.zeros((m, ksub), dtype=torch.float32, device=xs.device)
    sse = torch.zeros((), dtype=torch.float32, device=xs.device)
    for c0 in range(0, n, chunk):
        xt = xs[c0:c0 + chunk]
        dist = cb_sq[None] - 2.0 * torch.einsum("nmd,mkd->nmk", xt, cb)
        code = torch.argmin(dist, dim=-1)                        # [c, m]
        best = torch.gather(dist, -1, code[..., None])[..., 0]
        oh = F.one_hot(code, ksub).float()                       # [c, m, ksub]
        sums += torch.einsum("nmk,nmd->mkd", oh, xt)
        counts += oh.sum(0)
        sse += (best + (xt * xt).sum(-1)).sum()  # ||x-c||² = ||x||² + (...)
    return sums, counts, sse


def train_pq(x: np.ndarray, m_sub: int, *, ksub: int = KSUB, iters: int = 25,
             seed: int = 42, max_points: int = 65536, chunk: int = 8192,
             init_cb: np.ndarray | None = None, device=None) -> np.ndarray:
    """Per-subspace k-means (faiss ``ProductQuantizer::train``): ``iters``
    Lloyd steps, ``ksub`` centroids, training subsampled to ``max_points``.
    Deterministic given ``seed``. Returns f32 codebooks [m_sub, ksub, dsub]
    as numpy. ``init_cb`` warm-starts the codebooks. The steps run on
    ``device`` (the card by default)."""
    x = np.asarray(x, np.float32)
    n, d = x.shape
    if d % m_sub:
        raise ValueError(f"pq_m={m_sub} must divide d={d}")
    if n < ksub:
        raise ValueError(f"PQ training needs >= {ksub} points, got {n} "
                         "(faiss ProductQuantizer has the same floor)")
    dev = torch.device(device) if device is not None else default_device()
    rng = np.random.default_rng(seed)
    if n > max_points:
        x = x[rng.choice(n, max_points, replace=False)]
        n = max_points
    dsub = d // m_sub
    xs_np = x.reshape(n, m_sub, dsub)
    if init_cb is not None:
        if init_cb.shape != (m_sub, ksub, dsub):
            raise ValueError(f"init_cb shape {init_cb.shape} != "
                             f"{(m_sub, ksub, dsub)}")
        cb = np.array(init_cb, np.float32)      # a copy the steps may own
    else:
        # a shared random sample of training points seeds every subspace
        cb = np.ascontiguousarray(
            xs_np[rng.choice(n, ksub, replace=False)].transpose(1, 0, 2))
    xs = torch.from_numpy(np.ascontiguousarray(xs_np)).to(dev)
    for _ in range(iters):
        sums, counts, _ = _assign_update(xs, torch.from_numpy(cb).to(dev),
                                         chunk=min(chunk, n))
        sums, counts = sums.cpu().numpy(), counts.cpu().numpy()
        new_cb = np.where(counts[..., None] > 0,
                          sums / np.maximum(counts[..., None], 1), cb)
        # empty clusters restart from random training points (seeded)
        empty_m, empty_k = np.nonzero(counts <= 0)
        if len(empty_m):
            steal = rng.integers(0, n, size=len(empty_m))
            new_cb[empty_m, empty_k] = xs_np[steal, empty_m]
        cb = np.ascontiguousarray(new_cb, np.float32)
    return cb


def encode_pq(x: torch.Tensor, cb: torch.Tensor, *, chunk: int = 1 << 16,
              dequant=None) -> torch.Tensor:
    """[n, d] -> uint8 codes [n, m_sub], the nearest centroid per subspace
    (the first on ties), ``chunk`` rows at a time so the [n, m, ksub]
    distance tensor never exists whole. ``dequant`` = (offset [d], scale
    [d]) when ``x`` holds sq8 codes: each chunk is dequantized to x̂
    first."""
    n = x.shape[0]
    m_sub = cb.shape[0]
    cb_sq = (cb * cb).sum(-1)
    out = torch.empty((n, m_sub), dtype=torch.uint8, device=x.device)
    for c0 in range(0, n, chunk):
        xt = decode_rows(x[c0:c0 + chunk], dequant)
        dots = torch.einsum("nmd,mkd->nmk", split_sub(xt, m_sub), cb)
        out[c0:c0 + chunk] = torch.argmin(cb_sq[None] - 2.0 * dots,
                                          dim=-1).to(torch.uint8)
    return out


def _flat_index(codes: torch.Tensor, m_sub: int, ksub: int) -> torch.Tensor:
    """codes [..., m_sub] -> rows of the flattened [m_sub * ksub] codebook."""
    return codes.long() + torch.arange(m_sub, device=codes.device) * ksub


def decode_pq(codes: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """uint8 codes [..., m_sub] -> the reconstruction x̂ f32 [..., d]: one
    gather of m_sub dsub-wide codebook rows per vector."""
    m_sub, ksub, dsub = cb.shape
    flat = cb.reshape(m_sub * ksub, dsub)
    return flat[_flat_index(codes, m_sub, ksub)].reshape(
        *codes.shape[:-1], m_sub * dsub)


def pq_lut(queries: torch.Tensor, cb: torch.Tensor,
           metric: str) -> torch.Tensor:
    """Per-query ADC tables [Q, m_sub, ksub] of the per-subspace surrogate
    ``||c||² − 2 q_m·c`` (IP: ``−q_m·c``)."""
    dots = torch.einsum("qmd,mkd->qmk",
                        split_sub(queries.float(), cb.shape[0]), cb)
    if metric == IP:
        return -dots
    return (cb * cb).sum(-1)[None] - 2.0 * dots


def adc_distance(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut [Q, m_sub, ksub] x codes [Q, K, m_sub] -> surrogate distances
    [Q, K], one table lookup per (candidate, subspace)."""
    idx = codes.long().transpose(-1, -2)                         # [Q, m, K]
    return torch.gather(lut, -1, idx).sum(-2)


def adc_decode_distance(cb: torch.Tensor, queries: torch.Tensor,
                        codes: torch.Tensor, metric: str, *,
                        exact: bool = False) -> torch.Tensor:
    """The reference form of ADC, on no search or build path (those use
    ``pq_lut`` + ``adc_distance``): surrogate distances [Q, K] from cb
    [m, ksub, dsub], queries [Q, d] and codes [Q, K, m], x̂ decoded by a
    gather and contracted with the query in f32. The decode is exact, so
    both values of ``exact`` (the reference's routing / rerank switch) give
    the same result."""
    xh = decode_pq(codes, cb)                                    # [Q, K, d]
    dots = torch.einsum("qkd,qd->qk", xh, queries.float())
    return -dots if metric == IP else (xh * xh).sum(-1) - 2.0 * dots


def pq_sqnorms(codes: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """||x̂||² per row from the codes alone: the sum of the per-centroid
    norms (subspaces are orthogonal blocks of coordinates)."""
    m_sub, ksub, _ = cb.shape
    norms = (cb * cb).sum(-1).reshape(-1)
    return norms[_flat_index(codes, m_sub, ksub)].sum(-1)
