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
(table lookups), which need no shift.

Row count: as in the reference, a table holds its rows padded up to a
whole number of assembly chunks (``chunk``, 65,536 by default), so an
index of n rows has up to chunk − 1 rows of headroom; pad rows hold the
rows of a node whose neighbors are all id 0 and are never gathered.
``update_packed_rows`` / ``update_packed_pq_rows`` rewrite given rows in
place after an ``add()`` (``row_fingerprints`` finds which), so a served
index takes inserts without a full re-pack while the new total fits the
headroom.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch

from ..config import IP
from .dist_kernel import packed_row_dist_ids, packed_row_dist_words_ids
from .distances import decode_rows

if TYPE_CHECKING:
    from .storage import Storage


@dataclasses.dataclass
class PackedNeighbors:
    nbr_codes: torch.Tensor  # uint8 [n_rows, row_w] (bytes layout) or int32
    #                          [n_rows, m0 * word_width(d, bits)] (words)
    nbr_sq: torch.Tensor     # f32   [n_rows, m0]  ||x̂||² of each neighbor
    scale: torch.Tensor      # f32   [d]  per-dim affine scale
    offset: torch.Tensor     # f32   [d]  per-dim affine offset

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


def padded_rows(n_rows: int, chunk: int) -> int:
    """Rows of a table for ids < n_rows: n_rows rounded up to a whole
    number of min(chunk, n_rows)-row chunks (the reference's assembly
    chunk), so up to chunk − 1 rows of headroom for later adds."""
    eff = min(chunk, n_rows)
    return -(-n_rows // eff) * eff


def _gather_rows(neighbors0: torch.Tensor, n_rows: int, pad_cap: int):
    """int64 [pad_cap, m0] gather index of each row's neighbors (−1 read as
    id 0), pad rows all id 0, as the reference's zero-padded adjacency."""
    safe = neighbors0[:n_rows].clamp(min=0).long()
    if pad_cap > n_rows:
        safe = torch.cat([safe, safe.new_zeros(pad_cap - n_rows,
                                               safe.shape[1])])
    return safe


def pack_neighbors(neighbors0: torch.Tensor, storage: "Storage",
                   levels: torch.Tensor, *, bits: int = 8,
                   max_bytes: int | None = None, n_rows: int | None = None,
                   chunk: int = 1 << 16,
                   layout: str = "bytes") -> PackedNeighbors:
    """Build the packed serving tables from a finished graph.

    bits: 8 (one byte per dim) or 4 (two dims per byte). max_bytes: refuse
    (ValueError) a table larger than this. n_rows: rows only for ids <
    n_rows (pass ntotal: only inserted nodes are ever expanded); the table
    holds ``padded_rows(n_rows, chunk)`` rows, and ``max_bytes`` counts
    those. storage: the stored rows (``ops/storage.py``); of sq8 storage
    at 8 bits the stored codes are the routing codes (the same affine),
    otherwise x̂ is quantized anew. layout: "bytes" (uint8 rows) or
    "words" (int32 rows, the same bits; module docstring)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if layout not in ("bytes", "words"):
        raise ValueError(f"layout must be 'bytes' or 'words', got {layout!r}")
    cap, m0 = neighbors0.shape
    d = storage.rows.shape[1]
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
    pad_cap = padded_rows(n_rows, chunk)
    total = pad_cap * row_bytes + pad_cap * m0 * 4
    if max_bytes is not None and total > max_bytes:
        raise ValueError(
            f"packed table needs {total / 1e9:.1f} GB "
            f"(> budget {max_bytes / 1e9:.1f} GB); use bits=4 or skip "
            f"packing for this capacity")
    live = levels >= 0
    if storage.sq is not None and bits == 8:
        offset, scale = storage.sq
        codes_all = storage.rows                                 # [cap, d] u8
    else:
        vectors = storage.rows if storage.sq is None else \
            storage.decode(storage.rows)
        offset, scale = quantization_params(vectors, live, bits)
        codes_all = quantize_codes(vectors, offset, scale, bits)  # [cap, d]
    xhat_sq = _sqnorms(codes_all, offset, scale)
    payload = _encode_payload(codes_all, bits, layout == "words")
    safe = _gather_rows(neighbors0, n_rows, pad_cap)            # [rows, m0]
    nbr_codes = payload[safe].view(pad_cap, m0 * payload.shape[1])
    return PackedNeighbors(nbr_codes, xhat_sq[safe], scale=scale,
                           offset=offset)


def _sqnorms(codes: torch.Tensor, offset: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """||x̂||² of code rows under the table's affine."""
    v = decode_rows(codes, (offset, scale))
    return (v * v).sum(-1)


def _encode_payload(codes: torch.Tensor, bits: int, words: bool):
    """[..., d] code values -> the row segment the layout stores."""
    if words:
        return pack_words(codes, bits)
    return _pack_nibbles(codes) if bits == 4 else codes


def _valid_ids(ids: torch.Tensor) -> torch.Tensor:
    """int64 ids of ``ids`` (int [U], −1 = pad) that are not pads."""
    ids = ids.reshape(-1).long()
    return ids[ids >= 0]


def update_packed_rows(nbr_codes: torch.Tensor, nbr_sq: torch.Tensor,
                       neighbors0: torch.Tensor, storage: "Storage",
                       offset: torch.Tensor, scale: torch.Tensor,
                       ids: torch.Tensor, *, bits: int):
    """Rewrite, in place, the packed rows of ``ids`` (int [U], −1 = a pad,
    skipped) from the CURRENT adjacency and stored rows (decoded to x̂)
    under the table's retained ``offset`` / ``scale`` (no retraining: a
    later vector outside the trained range has its routing codes clipped;
    the exact rerank is unaffected). Bytes (8- or 4-bit) and words
    layouts. Returns (nbr_codes, nbr_sq)."""
    rows = _valid_ids(ids)
    if rows.numel() == 0:
        return nbr_codes, nbr_sq
    nv = storage.read(neighbors0[rows].clamp(min=0).long())     # [U, m0, d]
    nc = quantize_codes(nv, offset, scale, bits)
    nsq = _sqnorms(nc, offset, scale)                            # [U, m0]
    upd = _encode_payload(nc, bits, nbr_codes.dtype == torch.int32)
    nbr_codes.index_copy_(0, rows, upd.reshape(rows.numel(), -1))
    nbr_sq.index_copy_(0, rows, nsq)
    return nbr_codes, nbr_sq


_M32 = 0xFFFFFFFF
_FP_CHUNK = 1 << 16   # rows a row_fingerprints step hashes at a time


def _mul32(v: torch.Tensor, m: int) -> torch.Tensor:
    """(v · m) mod 2^32 for int64 v in [0, 2^32): two 16-bit halves of m,
    so no product reaches 2^63 (CUDA torch has no uint32 multiply)."""
    lo = v * (m & 0xFFFF)
    hi = ((v * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(v: torch.Tensor, m1: int, m2: int) -> torch.Tensor:
    v = v ^ (v >> 16)
    v = _mul32(v, m1)
    v = v ^ (v >> 15)
    v = _mul32(v, m2)
    return v ^ (v >> 16)


def row_fingerprints(neighbors0: torch.Tensor) -> torch.Tensor:
    """Two position-salted 32-bit hashes per adjacency row, int64
    [capacity, 2] holding the reference's uint32 values bit for bit: each
    entry is mixed as a uint32 and the row's values are summed modulo 2^32.
    Comparing them before and after an ``add()`` finds the rows it changed
    without a second copy of the adjacency. Runs in ``_FP_CHUNK``-row
    pieces so the int64 temporaries stay small."""
    m0 = neighbors0.shape[1]
    pos = torch.arange(m0, dtype=torch.int64, device=neighbors0.device)
    salt1, salt2 = _mul32(pos, 0x9E3779B9), _mul32(pos, 0x85EBCA6B)
    out = torch.empty((neighbors0.shape[0], 2), dtype=torch.int64,
                      device=neighbors0.device)
    for r in range(0, neighbors0.shape[0], _FP_CHUNK):
        x = neighbors0[r:r + _FP_CHUNK].long() & _M32
        out[r:r + _FP_CHUNK, 0] = _mix(x ^ salt1, 0x7FEB352D,
                                       0x846CA68B).sum(1) & _M32
        out[r:r + _FP_CHUNK, 1] = _mix(x ^ salt2, 0xC2B2AE35,
                                       0x27D4EB2F).sum(1) & _M32
    return out


def make_packed_dist(packed: PackedNeighbors, m0: int, queries: torch.Tensor,
                     metric: str):
    """Returns (dist, shift). dist(cur [Q] or [Q, T]) -> f32 [Q, T*m0]
    computes every candidate distance of the expanded nodes from their
    packed code rows: K2 for the bytes layout, K4 (dots; the metric is
    applied here) for words. The kernels index the query of flattened row
    b as b // T, so the query rows are never repeated. A cur of -1 (a
    converged query of the fused beam) reads no code row; its distances
    are +inf (bytes) or not to be read (words). shift [Q] is added to
    exactly computed distances (the entry point) to put them on the same
    scale: 2 q·offset for L2, q·offset for IP."""
    qf = queries.float()
    qs = (qf * packed.scale).contiguous()                        # [Q, d]
    qoff = qf @ packed.offset                                    # [Q]
    shift = qoff if metric == IP else 2.0 * qoff
    bits = packed.bits_for(qf.shape[1], m0)
    words = packed.layout == "words"

    def dist(cur: torch.Tensor) -> torch.Tensor:
        cur = cur.contiguous()
        if not words:
            return packed_row_dist_ids(packed.nbr_codes, packed.nbr_sq, cur,
                                       qs, bits=bits, metric=metric)
        dots = packed_row_dist_words_ids(packed.nbr_codes, cur, qs,
                                         wp=packed.row_w // m0, bits=bits)
        if metric == IP:
            return -dots
        return packed.nbr_sq[cur].reshape(dots.shape) - 2.0 * dots

    return dist, shift


def make_packed_expand(packed: PackedNeighbors, neighbors0: torch.Tensor,
                       queries: torch.Tensor, metric: str):
    """Returns (expand, shift): ``make_packed_dist``'s distances with the
    neighbor ids, the legacy beam's contract. expand(cur [Q, T], step_ok
    [Q, T]) -> (nbrs int32 [Q, T, m0], dist f32 [Q, T*m0]). ``step_ok`` is
    not read: rows of masked slots are read and their candidates masked by
    the caller."""
    dist, shift = make_packed_dist(packed, neighbors0.shape[1], queries,
                                   metric)

    def expand(cur: torch.Tensor, step_ok: torch.Tensor):
        return neighbors0[cur], dist(cur)

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
                      n_rows: int | None = None,
                      chunk: int = 1 << 16) -> PackedPQ:
    """Build PQ-coded packed rows from a finished graph. codes_all: uint8
    [capacity, pq_m] routing codes of every vector under ``cb`` (pq
    storage: the stored codes). pq_bits: 8 (a byte a code) or 4 (two codes
    a byte, low nibble first; needs ksub <= 16). Like ``pack_neighbors``,
    the table holds ``padded_rows(n_rows, chunk)`` rows and ``max_bytes``
    counts those."""
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
    pad_cap = padded_rows(n_rows, chunk)
    total = pad_cap * m0 * bpn
    if max_bytes is not None and total > max_bytes:
        raise ValueError(
            f"packed-pq table needs {total / 1e9:.1f} GB "
            f"(> budget {max_bytes / 1e9:.1f} GB); lower pq_m / use "
            f"pq_bits=4 or skip packing for this capacity")
    payload = _pack_nibbles(codes_all) if pq_bits == 4 else codes_all
    safe = _gather_rows(neighbors0, n_rows, pad_cap)
    return PackedPQ(payload[safe].view(pad_cap, m0 * bpn), cb.float(),
                    pq_bits)


def update_packed_pq_rows(nbr_codes: torch.Tensor, neighbors0: torch.Tensor,
                          codes_all: torch.Tensor, ids: torch.Tensor, *,
                          pq_bits: int) -> torch.Tensor:
    """Rewrite, in place, the PQ-coded rows of ``ids`` (int [U], −1 = a
    pad) from the CURRENT adjacency and routing codes, as
    ``update_packed_rows`` does for sq rows. Returns ``nbr_codes``."""
    rows = _valid_ids(ids)
    if rows.numel() == 0:
        return nbr_codes
    nc = codes_all[neighbors0[rows].clamp(min=0).long()]        # [U, m0, pm]
    if pq_bits == 4:
        nc = _pack_nibbles(nc)
    nbr_codes.index_copy_(0, rows, nc.reshape(rows.numel(), -1))
    return nbr_codes


def make_packed_pq_dist(packed: PackedPQ, m0: int, queries: torch.Tensor,
                        metric: str):
    """Returns (dist, shift) like ``make_packed_dist``, with ADC routing
    distances from the PQ code row of each expanded node: lookups in the
    per-query tables built once here (``ops/pq.py`` ``pq_lut`` /
    ``adc_distance``). A cur of -1 reads the last row (not to be read).
    shift is 0: ADC carries the whole surrogate."""
    from .pq import adc_distance, pq_lut

    qf = queries.float()
    lut = pq_lut(qf, packed.cb, metric)                          # [Q, m, ksub]
    pm = packed.cb.shape[0]
    four_bit = packed.pq_bits == 4
    bpn = packed.bpn(m0)

    def dist(cur: torch.Tensor) -> torch.Tensor:
        qn = cur.shape[0]
        t = cur.numel() // qn
        rows = packed.nbr_codes[cur.reshape(-1)].view(qn, t * m0, bpn)
        codes = unpack_nibbles(rows, pm) if four_bit else rows
        return adc_distance(lut, codes)

    return dist, qf.new_zeros(qf.shape[0])


def make_packed_pq_expand(packed: PackedPQ, neighbors0: torch.Tensor,
                          queries: torch.Tensor, metric: str):
    """Returns (expand, shift) like ``make_packed_expand`` over
    ``make_packed_pq_dist``."""
    dist, shift = make_packed_pq_dist(packed, neighbors0.shape[1], queries,
                                      metric)

    def expand(cur: torch.Tensor, step_ok: torch.Tensor):
        return neighbors0[cur], dist(cur)

    return expand, shift
