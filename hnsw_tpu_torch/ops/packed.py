"""Packed neighbor-code rows ("bytes" layout), ported from
``hnsw_tpu.ops.packed``.

For every node the quantized vectors of ALL its level-0 neighbors sit
contiguously in one row, so a hop reads one adjacency row, one code row
(m0 · d · bits/8 bytes) and one norm row per expanded node instead of one
vector row per candidate. K2 (``ops/dist_kernel.py``) reads the code row by
node id and computes all m0 routing distances from it.

Distance algebra, with the per-dim affine x̂ = offset + scale · u:

    L2 surrogate:  ||x̂||² − 2 q·x̂ = sq_hat − 2 (q·scale)·u − 2 q·offset
    IP surrogate:  −q·x̂            =        − (q·scale)·u −   q·offset

The q·offset term is constant per query, so the beam routes on
``sq_hat − 2 (q·scale)·u`` (resp. ``−(q·scale)·u``) and the one exactly
scored distance that enters the beam (the entry point) is shifted by the
same constant. The final buffer is re-ranked with exact f32 distances.

Memory: ntotal · m0 · d · bits/8 bytes of codes plus ntotal · m0 · 4 bytes
of norms. Not ported yet: the "words" layout (int32 rows, K4), PQ-coded
rows, and incremental row maintenance after ``add()``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import IP
from .dist_kernel import packed_row_dist_ids


@dataclasses.dataclass
class PackedNeighbors:
    nbr_codes: torch.Tensor  # uint8 [n_rows, row_w]
    nbr_sq: torch.Tensor     # f32   [n_rows, m0]  ||x̂||² of each neighbor
    scale: torch.Tensor      # f32   [d]  per-dim dequant scale
    offset: torch.Tensor     # f32   [d]  per-dim dequant offset

    @property
    def row_w(self) -> int:
        return self.nbr_codes.shape[1]

    def bits_for(self, d: int, m0: int) -> int:
        w = self.row_w
        if w == m0 * d:
            return 8
        if w == m0 * ((d + 1) // 2):
            return 4
        raise ValueError(f"packed row width {w} matches neither 8-bit "
                         f"({m0 * d}) nor 4-bit ({m0 * ((d + 1) // 2)})")

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.nbr_codes, self.nbr_sq, self.scale, self.offset))


def quantization_params(vectors: torch.Tensor, live: torch.Tensor, bits: int):
    """Per-dim affine (offset, scale) from the min/max over live rows (faiss
    ScalarQuantizer training); scale is floored so a constant dim does not
    divide by zero."""
    v = vectors.float()
    vmin = torch.where(live[:, None], v, float("inf")).amin(0)
    vmax = torch.where(live[:, None], v, float("-inf")).amax(0)
    vmin = torch.where(torch.isfinite(vmin), vmin, 0.0)
    vmax = torch.where(torch.isfinite(vmax), vmax, 0.0)
    scale = torch.clamp(vmax - vmin, min=1e-20) / float((1 << bits) - 1)
    return vmin, scale


def quantize_codes(vectors: torch.Tensor, offset: torch.Tensor,
                   scale: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 codes [n, d], values 0..2^bits-1 (one byte per dim; 4-bit
    packing happens at row assembly). Rounds half to even like jnp.round."""
    u = torch.round((vectors.float() - offset) / scale)
    return u.clamp_(0, (1 << bits) - 1).to(torch.uint8)


def _pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """[..., d] 4-bit values -> [..., ceil(d/2)] bytes (low nibble first)."""
    if codes.shape[-1] % 2:
        codes = torch.cat([codes, torch.zeros_like(codes[..., :1])], -1)
    return codes[..., 0::2] | (codes[..., 1::2] << 4)


def pack_neighbors(neighbors0: torch.Tensor, vectors: torch.Tensor,
                   levels: torch.Tensor, *, bits: int = 8,
                   max_bytes: int | None = None, n_rows: int | None = None,
                   layout: str = "bytes") -> PackedNeighbors:
    """Build the packed serving tables from a finished graph.

    bits: 8 (one byte per dim) or 4 (two dims per byte). max_bytes: refuse
    (ValueError) a table larger than this. n_rows: rows only for ids <
    n_rows (pass ntotal: only inserted nodes are ever expanded)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if layout == "words":
        raise NotImplementedError(
            "packed layout 'words' (int32 rows, kernel K4) is not ported "
            "yet: ROADMAP.md Queue B, B4")
    if layout != "bytes":
        raise ValueError(f"layout must be 'bytes' or 'words', got {layout!r}")
    cap, m0 = neighbors0.shape
    d = vectors.shape[1]
    n_rows = cap if n_rows is None else max(1, min(int(n_rows), cap))
    row_bytes = m0 * d if bits == 8 else m0 * ((d + 1) // 2)
    total = n_rows * row_bytes + n_rows * m0 * 4
    if max_bytes is not None and total > max_bytes:
        raise ValueError(
            f"packed table needs {total / 1e9:.1f} GB "
            f"(> budget {max_bytes / 1e9:.1f} GB); use bits=4 or skip "
            f"packing for this capacity")
    from ..search import compute_sqnorms

    offset, scale = quantization_params(vectors, levels >= 0, bits)
    codes_all = quantize_codes(vectors, offset, scale, bits)     # [cap, d]
    xhat_sq = compute_sqnorms(codes_all, (offset, scale))
    payload = _pack_nibbles(codes_all) if bits == 4 else codes_all
    safe = neighbors0[:n_rows].clamp(min=0).long()               # [n_rows, m0]
    nbr_codes = payload[safe].view(n_rows, m0 * payload.shape[1])
    return PackedNeighbors(nbr_codes, xhat_sq[safe], scale=scale,
                           offset=offset)


def make_packed_expand(packed: PackedNeighbors, neighbors0: torch.Tensor,
                       queries: torch.Tensor, metric: str):
    """Returns (expand, shift). expand(cur [Q], step_ok [Q]) -> (nbrs int32
    [Q, m0], dist f32 [Q, m0]) computes every candidate distance of the
    expanded node from its one packed code row (K2). shift [Q] is added to
    exactly computed distances (the entry point) to put them on the same
    scale: 2 q·offset for L2, q·offset for IP."""
    qf = queries.float()
    qs = (qf * packed.scale).contiguous()                        # [Q, d]
    qoff = qf @ packed.offset                                    # [Q]
    shift = qoff if metric == IP else 2.0 * qoff
    bits = packed.bits_for(qf.shape[1], neighbors0.shape[1])

    def expand(cur: torch.Tensor, step_ok: torch.Tensor):
        nbrs = neighbors0[cur]
        dist = packed_row_dist_ids(packed.nbr_codes, packed.nbr_sq, cur, qs,
                                   bits=bits, metric=metric)
        return nbrs, dist

    return expand, shift
