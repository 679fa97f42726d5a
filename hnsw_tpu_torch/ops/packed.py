"""Packed neighbor-code rows, ported from ``hnsw_tpu.ops.packed``.

For every node the quantized vectors of ALL its level-0 neighbors sit
contiguously in one row, so a hop reads one adjacency row, one code row
(m0 · d · bits/8 bytes) and one norm row per expanded node instead of one
vector row per candidate. Two layouts hold the same bits:

  * "bytes": uint8 rows, one byte per dim (8-bit) or two dims per byte
    (4-bit, low nibble first). K2 (``ops/dist_kernel.py``) reads the code
    row by node id and computes all m0 routing distances from it;
  * "words": int32 rows, 32/bits values per word, little-endian, each
    candidate's segment zero-padded to ``word_width(d, bits)`` words. With
    no pad (d = 128) the words table is the bytes table seen as int32. K4
    reads the word row by node id and returns the m0 dot products.

Distance algebra, with the per-dim affine x̂ = offset + scale · u:

    L2 surrogate:  ||x̂||² − 2 q·x̂ = sq_hat − 2 (q·scale)·u − 2 q·offset
    IP surrogate:  −q·x̂            =        − (q·scale)·u −   q·offset

The q·offset term is constant per query, so the beam routes on
``sq_hat − 2 (q·scale)·u`` (resp. ``−(q·scale)·u``) and the one exactly
scored distance that enters the beam (the entry point) is shifted by the
same constant. The final buffer is re-ranked with exact f32 distances.

Memory: ntotal · m0 · d · bits/8 bytes of codes (bytes layout; words:
ntotal · m0 · word_width · 4) plus ntotal · m0 · 4 bytes of norms.

PQ-coded rows (``PackedPQ``) hold each neighbor's ``pq_m`` routing codes
instead, ntotal · m0 · pq_m · pq_bits/8 bytes, and route on ADC distances
(table lookups), which need no shift. Not ported yet: incremental row
maintenance after ``add()``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import IP
from .dist_kernel import packed_row_dist_ids, packed_row_dist_words_ids
from .distances import decode_rows


@dataclasses.dataclass
class PackedNeighbors:
    nbr_codes: torch.Tensor  # uint8 [n_rows, row_w] (bytes layout) or int32
    #                          [n_rows, m0 * word_width(d, bits)] (words)
    nbr_sq: torch.Tensor     # f32   [n_rows, m0]  ||x̂||² of each neighbor
    scale: torch.Tensor      # f32   [d]  per-dim dequant scale
    offset: torch.Tensor     # f32   [d]  per-dim dequant offset

    @property
    def row_w(self) -> int:
        return self.nbr_codes.shape[1]

    @property
    def layout(self) -> str:
        return "words" if self.nbr_codes.dtype == torch.int32 else "bytes"

    def bits_for(self, d: int, m0: int) -> int:
        w = self.row_w
        if self.layout == "words":
            w8, w4 = word_width(d, 8), word_width(d, 4)
            if w8 and w8 == w4 and w == m0 * w8:
                raise ValueError(
                    f"word-packed row width {w} is ambiguous at d={d} "
                    f"(8- and 4-bit segments both pad to {w8} words)")
            if w8 and w == m0 * w8:
                return 8
            if w4 and w == m0 * w4:
                return 4
            raise ValueError(
                f"word-packed row width {w} matches neither 8-bit "
                f"({m0 * w8}) nor 4-bit ({m0 * w4}) at d={d}")
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


def unpack_nibbles(rows: torch.Tensor, d: int) -> torch.Tensor:
    """[..., ceil(d/2)] bytes -> [..., d] 4-bit values (uint8)."""
    out = torch.stack([rows & 0x0F, (rows >> 4) & 0x0F], dim=-1)
    return out.reshape(*rows.shape[:-1], -1)[..., :d]


def word_width(d: int, bits: int) -> int:
    """int32 words per candidate segment in the "words" layout: ceil(d /
    (32/bits)) padded up to a divisor of 128 (the reference's kernel tiling;
    kept so both packages build the same table). 0 when a segment would
    exceed 128 words (use the bytes layout)."""
    w = -(-d // (32 // bits))
    for wp in (1, 2, 4, 8, 16, 32, 64, 128):
        if wp >= w:
            return wp
    return 0


def pack_words(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """[..., d] code values (< 2^bits) -> int32 [..., word_width(d, bits)],
    value j at bits [bits*(j % vpw), bits*(j % vpw + 1)) of word j // vpw
    (vpw = 32/bits): the little-endian byte / nibble order of the bytes
    layout, so the words hold its exact bit pattern. Words are assembled in
    int64 and wrapped to int32 at the end (no int32 overflow)."""
    d = codes.shape[-1]
    vpw = 32 // bits
    wp = word_width(d, bits)
    if not wp:
        raise ValueError(f"word layout unsupported at d={d}, bits={bits} "
                         f"(candidate segment exceeds 128 words)")
    c = codes.to(torch.int64)
    pad = wp * vpw - d
    if pad:
        c = torch.cat([c, c.new_zeros(c.shape[:-1] + (pad,))], -1)
    c = c.view(*c.shape[:-1], wp, vpw)
    w = torch.zeros(c.shape[:-1], dtype=torch.int64, device=c.device)
    for j in range(vpw):
        w |= c[..., j] << (bits * j)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def unpack_words(words: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """int32 [..., wp] -> [..., d] code values (uint8); the inverse of
    ``pack_words`` (the arithmetic shift's sign bits are masked off)."""
    mask = (1 << bits) - 1
    planes = [(words >> (bits * j)) & mask for j in range(32 // bits)]
    out = torch.stack(planes, dim=-1).reshape(*words.shape[:-1], -1)
    return out[..., :d].to(torch.uint8)


def pack_neighbors(neighbors0: torch.Tensor, vectors: torch.Tensor,
                   levels: torch.Tensor, *, bits: int = 8,
                   max_bytes: int | None = None, n_rows: int | None = None,
                   dequant=None, layout: str = "bytes") -> PackedNeighbors:
    """Build the packed serving tables from a finished graph.

    bits: 8 (one byte per dim) or 4 (two dims per byte). max_bytes: refuse
    (ValueError) a table larger than this. n_rows: rows only for ids <
    n_rows (pass ntotal: only inserted nodes are ever expanded). dequant:
    (offset, scale) when ``vectors`` holds sq8 storage codes; at 8 bits the
    stored codes are the routing codes (the same affine), at 4 bits x̂ is
    quantized anew. layout: "bytes" (uint8 rows) or "words" (int32 rows,
    the same bits; module docstring). The reference pads the row count to
    its assembly chunk; the port holds exactly n_rows rows, and
    ``max_bytes`` counts those."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if layout not in ("bytes", "words"):
        raise ValueError(f"layout must be 'bytes' or 'words', got {layout!r}")
    cap, m0 = neighbors0.shape
    d = vectors.shape[1]
    n_rows = cap if n_rows is None else max(1, min(int(n_rows), cap))
    if layout == "words":
        wp = word_width(d, bits)
        if not wp:
            raise ValueError(f"layout='words' unsupported at d={d}, "
                             f"bits={bits} (segment > 128 words); "
                             f"use layout='bytes'")
        row_bytes = m0 * wp * 4
    else:
        row_bytes = m0 * d if bits == 8 else m0 * ((d + 1) // 2)
    total = n_rows * row_bytes + n_rows * m0 * 4
    if max_bytes is not None and total > max_bytes:
        raise ValueError(
            f"packed table needs {total / 1e9:.1f} GB "
            f"(> budget {max_bytes / 1e9:.1f} GB); use bits=4 or skip "
            f"packing for this capacity")
    from ..search import compute_sqnorms

    live = levels >= 0
    if dequant is not None and bits == 8:
        offset, scale = dequant
        codes_all = vectors                                      # [cap, d] u8
    else:
        if dequant is not None:
            vectors = decode_rows(vectors, dequant)
        offset, scale = quantization_params(vectors, live, bits)
        codes_all = quantize_codes(vectors, offset, scale, bits)  # [cap, d]
    xhat_sq = compute_sqnorms(codes_all, (offset, scale))
    if layout == "words":
        payload = pack_words(codes_all, bits)
    elif bits == 4:
        payload = _pack_nibbles(codes_all)
    else:
        payload = codes_all
    safe = neighbors0[:n_rows].clamp(min=0).long()               # [n_rows, m0]
    nbr_codes = payload[safe].view(n_rows, m0 * payload.shape[1])
    return PackedNeighbors(nbr_codes, xhat_sq[safe], scale=scale,
                           offset=offset)


def make_packed_expand(packed: PackedNeighbors, neighbors0: torch.Tensor,
                       queries: torch.Tensor, metric: str):
    """Returns (expand, shift). expand(cur [Q, T], step_ok [Q, T]) -> (nbrs
    int32 [Q, T, m0], dist f32 [Q, T*m0]) computes every candidate distance
    of the T expanded nodes from their packed code rows: K2 for the bytes
    layout, K4 (dots; the metric is applied here) for words. The kernels
    index the query of flattened row b as b // T, so the query rows are
    never repeated. ``step_ok`` is not read: rows of masked slots are read
    and their candidates masked by the caller. shift [Q] is added to
    exactly computed distances (the entry point) to put them on the same
    scale: 2 q·offset for L2, q·offset for IP."""
    qf = queries.float()
    qs = (qf * packed.scale).contiguous()                        # [Q, d]
    qoff = qf @ packed.offset                                    # [Q]
    shift = qoff if metric == IP else 2.0 * qoff
    m0 = neighbors0.shape[1]
    bits = packed.bits_for(qf.shape[1], m0)
    words = packed.layout == "words"

    def expand(cur: torch.Tensor, step_ok: torch.Tensor):
        nbrs = neighbors0[cur]                                   # [Q, T, m0]
        cur = cur.contiguous()
        if not words:
            return nbrs, packed_row_dist_ids(packed.nbr_codes, packed.nbr_sq,
                                             cur, qs, bits=bits,
                                             metric=metric)
        dots = packed_row_dist_words_ids(packed.nbr_codes, cur, qs,
                                         wp=packed.row_w // m0, bits=bits)
        if metric == IP:
            return nbrs, -dots
        return nbrs, packed.nbr_sq[cur].reshape(dots.shape) - 2.0 * dots

    return expand, shift


# ---------------------------------------------------------------------------
# PQ-coded packed rows (PackedPQ)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedPQ:
    """Packed rows of PQ ROUTING codes, the low-memory packed variant: each
    neighbor contributes its ``pq_m`` codes (a byte each at 8 bits, a nibble
    at 4) instead of d scalar-quantized dims. Routing distances are ADC
    against the routing reconstruction (``ops/pq.py``), on the full
    ``||x̂||² − 2 q·x̂`` scale, so exactly scored entries need no shift. The
    codebooks ``cb`` ride along: pq storage packs its own; flat or sq8
    storage trains routing-only codebooks."""

    nbr_codes: torch.Tensor  # uint8 [n_rows, m0 * bpn]
    cb: torch.Tensor         # f32 [pq_m, ksub, dsub] routing codebooks
    pq_bits: int             # 8 (a byte a code) or 4 (a nibble a code)

    def bpn(self, m0: int) -> int:
        """Bytes per neighbor in a row."""
        return self.nbr_codes.shape[1] // m0

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.nbr_codes, self.cb))


def pack_pq_neighbors(neighbors0: torch.Tensor, codes_all: torch.Tensor,
                      cb: torch.Tensor, *, pq_bits: int = 8,
                      max_bytes: int | None = None,
                      n_rows: int | None = None) -> PackedPQ:
    """Build PQ-coded packed rows from a finished graph. codes_all: uint8
    [capacity, pq_m] routing codes of every vector under ``cb`` (pq
    storage: the stored codes). pq_bits: 8 (a byte a code) or 4 (two codes
    a byte, low nibble first; needs ksub <= 16). Like ``pack_neighbors``,
    the table holds exactly ``n_rows`` rows and ``max_bytes`` counts
    those."""
    if pq_bits not in (4, 8):
        raise ValueError(f"pq_bits must be 4 or 8, got {pq_bits}")
    if pq_bits == 4 and cb.shape[1] > 16:
        raise ValueError("pq_bits=4 requires ksub<=16 routing codebooks "
                         f"(got ksub={cb.shape[1]})")
    cap, m0 = neighbors0.shape
    pm = codes_all.shape[1]
    if pm != cb.shape[0]:
        raise ValueError(f"codes have {pm} sub-codes but codebooks have "
                         f"{cb.shape[0]} subspaces")
    n_rows = cap if n_rows is None else max(1, min(int(n_rows), cap))
    bpn = pm if pq_bits == 8 else (pm + 1) // 2
    total = n_rows * m0 * bpn
    if max_bytes is not None and total > max_bytes:
        raise ValueError(
            f"packed-pq table needs {total / 1e9:.1f} GB "
            f"(> budget {max_bytes / 1e9:.1f} GB); lower pq_m / use "
            f"pq_bits=4 or skip packing for this capacity")
    payload = _pack_nibbles(codes_all) if pq_bits == 4 else codes_all
    safe = neighbors0[:n_rows].clamp(min=0).long()
    return PackedPQ(payload[safe].view(n_rows, m0 * bpn), cb.float(),
                    pq_bits)


def make_packed_pq_expand(packed: PackedPQ, neighbors0: torch.Tensor,
                          queries: torch.Tensor, metric: str):
    """Returns (expand, shift) like ``make_packed_expand``, with ADC routing
    distances from the PQ code row of each expanded node: lookups in the
    per-query tables built once here (``ops/pq.py`` ``pq_lut`` /
    ``adc_distance``). shift is 0: ADC carries the whole surrogate."""
    from .pq import adc_distance, pq_lut

    qf = queries.float()
    lut = pq_lut(qf, packed.cb, metric)                          # [Q, m, ksub]
    m0 = neighbors0.shape[1]
    pm = packed.cb.shape[0]
    four_bit = packed.pq_bits == 4
    bpn = packed.bpn(m0)

    def expand(cur: torch.Tensor, step_ok: torch.Tensor):
        nbrs = neighbors0[cur]                                   # [Q, T, m0]
        qn, t = cur.shape
        rows = packed.nbr_codes[cur.reshape(-1)].view(qn, t * m0, bpn)
        codes = unpack_nibbles(rows, pm) if four_bit else rows
        return nbrs, adc_distance(lut, codes)

    return expand, qf.new_zeros(qf.shape[0])
