"""Routing and rerank distances: K3 ``gathered_vec_dist``, K2
``packed_row_dist`` and K4 ``packed_row_dist_words``, CUDA kernels in
``csrc/dist_kernel.cu``.

Each function has a plain PyTorch version beside it (``*_plain``). A wrapper
runs the plain version when its tensors are on the CPU and launches the
kernel when they are on a CUDA device; there is no fallback between the two.

  * ``gathered_vec_dist_ids(table, ids, qs, dequant, metric=)`` — exact f32
    surrogate distances ``Σv² − 2Σq·v`` (L2) or ``−Σq·v`` (IP) to the rows
    ``table[ids]``, gathered inside the kernel. f32, bf16 or uint8 rows
    (uint8 with the affine dequant ``v = offset + scale·u``), any d and K
    (the kernel uses no shared memory); launches are also counted by row
    dtype ("float32", "bfloat16", "uint8"). The search path calls this;
    ``gathered_vec_dist`` keeps the reference's pre-gathered signature for
    the parity tests.
  * ``packed_row_dist_ids(codes, nbr_sq, cur, qs, bits=, metric=)`` —
    routing distances ``nbr_sq − 2Σ qs·u`` (L2) or ``−Σ qs·u`` (IP) from
    packed code row ``cur[q]`` (8-bit: one byte per dim; 4-bit: even dim in
    the low nibble, odd dim in the high one). ``packed_row_dist`` keeps the
    reference's signature. Where a candidate's segment is a whole number of
    4-byte words, the kernel is K4's engine with a metric epilogue, and its
    L2 output equals ``nbr_sq[cur] − 2·packed_row_dist_words_ids(...)`` bit
    for bit on the same bits.
  * ``packed_row_dist_words_ids(words, cur, qs, wp=, bits=)`` — the dots
    ``Σ qs·u`` alone (the caller applies the metric) from int32 word row
    ``cur[q]``: ``wp`` words per candidate, 32/bits values per word,
    little-endian (``ops/packed.py`` ``pack_words``). ``packed_row_dist_words``
    keeps the reference's signature, with the query ``qs`` in place of its
    MXU query planes.

The two packed-row kernels take ``cur`` as [Q] or [Q, T] (T expanded nodes
per query, the legacy beam's ``n_expand``) and return [Q, T·k]: flattened
row b reads code row ``cur.flat[b]`` against query b // T.
"""

from __future__ import annotations

import torch

from ..config import IP, L2
from ._cuda import SMEM_LIMIT, CudaKernel, check, on_cpu

_VEC_DIST = CudaKernel("gathered_vec_dist", "hnsw_vec_dist")
_PACKED_DIST = CudaKernel("packed_row_dist", "hnsw_packed_dist")
_WORDS_DIST = CudaKernel("packed_row_dist_words", "hnsw_words_dist")
_ROW_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


def _check_metric(metric: str) -> None:
    if metric not in (L2, IP):
        raise ValueError(f"metric must be {L2!r} or {IP!r}, got {metric!r}")


def gathered_vec_dist_plain(table, ids, qs, dequant=None, *, metric):
    v = table[ids.long().clamp(0, table.shape[0] - 1)].float()   # [Q, K, d]
    if dequant is not None:
        v = dequant[0] + dequant[1] * v
    dots = (v * qs[:, None, :]).sum(-1)
    if metric == IP:
        return -dots
    return (v * v).sum(-1) - 2.0 * dots


def gathered_vec_dist_ids(table: torch.Tensor, ids: torch.Tensor,
                          qs: torch.Tensor, dequant=None, *,
                          metric: str) -> torch.Tensor:
    """table [N, d] (f32/bf16/u8), ids int32 [Q, K] (row ids, already made
    safe by the caller), qs f32 [Q, d], dequant None or (offset [d],
    scale [d]) f32. Returns f32 [Q, K]."""
    _check_metric(metric)
    if table.dtype not in _ROW_DTYPES:
        raise ValueError(f"table: unsupported dtype {table.dtype}")
    check(table, "table", table.dtype, (None, None))
    n, d = table.shape
    check(ids, "ids", torch.int32, (None, None))
    q, k = ids.shape
    check(qs, "qs", torch.float32, (q, d))
    tensors = [table, ids, qs]
    if dequant is not None:
        for t, name in zip(dequant, ("offset", "scale")):
            check(t, name, torch.float32, (d,))
        tensors += list(dequant)
    if n == 0:
        raise ValueError("gathered_vec_dist: empty table")
    if on_cpu(*tensors):
        return gathered_vec_dist_plain(table, ids, qs, dequant, metric=metric)
    out = torch.empty((q, k), dtype=torch.float32, device=table.device)
    if q == 0 or k == 0:
        return out
    off, sc = (dequant[0].data_ptr(), dequant[1].data_ptr()) \
        if dequant is not None else (None, None)
    _VEC_DIST.launch(table.data_ptr(), _ROW_DTYPES[table.dtype], n, d,
                     ids.data_ptr(), q, k, qs.data_ptr(), off, sc,
                     int(metric == IP), out.data_ptr())
    _VEC_DIST.count_tag(str(table.dtype).removeprefix("torch."))
    return out


def gathered_vec_dist(vecs: torch.Tensor, qs: torch.Tensor, dequant=None, *,
                      metric: str) -> torch.Tensor:
    """The reference's signature: pre-gathered vecs [Q, K, d]. Runs the same
    kernel on ``vecs.view(Q*K, d)`` with ids = arange."""
    if vecs.dim() != 3:
        raise ValueError(f"vecs: expected [Q, K, d], got {tuple(vecs.shape)}")
    q, k, d = vecs.shape
    if not vecs.is_contiguous():
        raise ValueError("vecs: must be contiguous")
    ids = torch.arange(q * k, dtype=torch.int32,
                       device=vecs.device).view(q, k)
    return gathered_vec_dist_ids(vecs.view(q * k, d), ids, qs, dequant,
                                 metric=metric)


def _code_bytes(d: int, bits: int) -> int:
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    return d if bits == 8 else (d + 1) // 2


def unpack_codes(rows: torch.Tensor, k: int, d: int, bits: int):
    """uint8 code rows [Q, k*db] -> code values [Q, k, d] (uint8)."""
    q = rows.shape[0]
    db = _code_bytes(d, bits)
    seg = rows.view(q, k, db)
    if bits == 8:
        return seg
    u = torch.stack([seg & 0x0F, seg >> 4], dim=-1).view(q, k, 2 * db)
    return u[..., :d]


def _check_cur(cur: torch.Tensor, q: int) -> int:
    """cur int32 [Q] or [Q, T]; returns T."""
    check(cur, "cur", torch.int32, (q,) if cur.dim() == 1 else (q, None))
    return 1 if cur.dim() == 1 else cur.shape[1]


def packed_row_dist_plain(codes, nbr_sq, cur, qs, *, bits, metric):
    k = nbr_sq.shape[1]
    q, d = qs.shape
    row = cur.reshape(q, -1).long().clamp(0, codes.shape[0] - 1)  # [Q, T]
    u = unpack_codes(codes[row.reshape(-1)], k, d, bits).float()
    dots = (u.view(q, -1, k, d) * qs[:, None, None, :]).sum(-1).view(q, -1)
    if metric == IP:
        return -dots
    return nbr_sq[row].view(q, -1) - 2.0 * dots


def packed_row_dist_ids(codes: torch.Tensor, nbr_sq: torch.Tensor,
                        cur: torch.Tensor, qs: torch.Tensor, *, bits: int,
                        metric: str) -> torch.Tensor:
    """codes uint8 [R, k*db], nbr_sq f32 [R, k], cur int32 [Q] or [Q, T]
    (rows of the expanded nodes, already made safe), qs f32 [Q, d]
    (= q·scale). Returns f32 [Q, T*k]."""
    _check_metric(metric)
    check(codes, "codes", torch.uint8, (None, None))
    check(nbr_sq, "nbr_sq", torch.float32, (codes.shape[0], None))
    check(qs, "qs", torch.float32, (None, None))
    t = _check_cur(cur, qs.shape[0])
    (n, row_w), k, (q, d) = codes.shape, nbr_sq.shape[1], qs.shape
    if row_w != k * _code_bytes(d, bits):
        raise ValueError(f"codes: row width {row_w} != k*db = "
                         f"{k} * {_code_bytes(d, bits)} ({bits}-bit, d={d})")
    if n == 0:
        raise ValueError("packed_row_dist: empty code table")
    if on_cpu(codes, nbr_sq, cur, qs):
        return packed_row_dist_plain(codes, nbr_sq, cur, qs, bits=bits,
                                     metric=metric)
    # a block stages the query's code-row values (dims past d as 0) without
    # opting in to more than SMEM_LIMIT (the kernel's paths other than the
    # bulk ring)
    if _code_bytes(d, bits) * (8 // bits) * 4 > SMEM_LIMIT:
        raise ValueError(f"packed_row_dist: d={d} too wide for one block")
    out = torch.empty((q, t * k), dtype=torch.float32, device=codes.device)
    if q == 0 or k == 0 or t == 0:
        return out
    _PACKED_DIST.launch(codes.data_ptr(), n, row_w, nbr_sq.data_ptr(), k, d,
                        bits, cur.data_ptr(), q, t, qs.data_ptr(),
                        int(metric == IP), out.data_ptr())
    return out


def packed_row_dist(rows: torch.Tensor, qs: torch.Tensor,
                    nbr_sq: torch.Tensor, *, k: int, bits: int,
                    metric: str) -> torch.Tensor:
    """The reference's signature: rows uint8 [Q, k*db] already gathered,
    nbr_sq f32 [Q, k]. Runs the same kernel with cur = arange(Q)."""
    if nbr_sq.dim() != 2 or nbr_sq.shape[1] != k:
        raise ValueError(f"nbr_sq: expected [Q, {k}], got "
                         f"{tuple(nbr_sq.shape)}")
    cur = torch.arange(rows.shape[0], dtype=torch.int32, device=rows.device)
    return packed_row_dist_ids(rows, nbr_sq, cur, qs, bits=bits,
                               metric=metric)


def packed_row_dist_words_plain(words, cur, qs, *, wp, bits):
    from .packed import unpack_words

    q, d = qs.shape
    k = words.shape[1] // wp
    row = cur.reshape(-1).long().clamp(0, words.shape[0] - 1)
    u = unpack_words(words[row].view(-1, k, wp), bits, d).float()
    return (u.view(q, -1, k, d) * qs[:, None, None, :]).sum(-1).view(q, -1)


def packed_row_dist_words_ids(words: torch.Tensor, cur: torch.Tensor,
                              qs: torch.Tensor, *, wp: int,
                              bits: int) -> torch.Tensor:
    """words int32 [R, k*wp] (``wp`` words per candidate, of which the
    first ceil(d*bits/32) carry values), cur int32 [Q] or [Q, T] (rows of
    the expanded nodes, already made safe), qs f32 [Q, d]. Returns the dots
    f32 [Q, T*k]; dims >= d are never read."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    check(words, "words", torch.int32, (None, None))
    check(qs, "qs", torch.float32, (None, None))
    t = _check_cur(cur, qs.shape[0])
    (n, row_w), (q, d) = words.shape, qs.shape
    if wp <= 0 or row_w % wp:
        raise ValueError(f"words: row width {row_w} is not k * wp "
                         f"(wp={wp})")
    if wp * (32 // bits) < d:
        raise ValueError(f"words: {wp} words of {bits}-bit values hold "
                         f"fewer than d={d} dims")
    if n == 0:
        raise ValueError("packed_row_dist_words: empty word table")
    k = row_w // wp
    if on_cpu(words, cur, qs):
        return packed_row_dist_words_plain(words, cur, qs, wp=wp, bits=bits)
    out = torch.empty((q, t * k), dtype=torch.float32, device=words.device)
    if q == 0 or k == 0 or t == 0:
        return out
    _WORDS_DIST.launch(words.data_ptr(), n, row_w, k, wp, d, bits,
                       cur.data_ptr(), q, t, qs.data_ptr(), out.data_ptr())
    return out


def packed_row_dist_words(rows: torch.Tensor, qs: torch.Tensor, *, k: int,
                          wp: int, bits: int) -> torch.Tensor:
    """The reference's signature: rows int32 [Q, k*wp] already gathered.
    Runs the same kernel with cur = arange(Q). Returns f32 [Q, k] dots."""
    if rows.dim() != 2 or rows.shape[1] != k * wp:
        raise ValueError(f"rows: expected [Q, {k * wp}], got "
                         f"{tuple(rows.shape)}")
    cur = torch.arange(rows.shape[0], dtype=torch.int32, device=rows.device)
    return packed_row_dist_words_ids(rows, cur, qs, wp=wp, bits=bits)
