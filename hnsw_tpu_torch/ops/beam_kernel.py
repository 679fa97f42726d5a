"""K1 ``beam_update``: one level-0 beam hop per query, CUDA kernel in
``csrc/beam_kernel.cu``.

The state keeps the natural [Q, ef] layout (the reference transposes to
[ef, Q] for the TPU's lanes). Per query:

  1. drop candidates whose id is already in the buffer; ``ndis`` = the count
     of fresh ones;
  2. merge the fresh ones into the ascending top-ef buffer;
  3. kill slots >= ``ef_live`` with (+inf, -1);
  4. pick the nearest unexpanded slot (first index on a tie), set its
     expanded bit and return its id as ``cur`` (-1 once converged).

Payload ``(id << 1) | expanded``; -1 is "empty and expanded". The merge is a
stable sort of (buffer ++ fresh candidates), in the kernel and in the plain
version alike, so the two agree exactly, tie order included.
"""

from __future__ import annotations

import torch

from ._cuda import SMEM_LIMIT, CudaKernel, check, on_cpu

_BEAM_UPDATE = CudaKernel("beam_update", "hnsw_beam_update")


def beam_update_plain(buf_d, buf_p, cand_i, cand_d, ef_live: int):
    q, ef = buf_d.shape
    member = (cand_i[:, :, None] == (buf_p >> 1)[:, None, :]).any(2)
    fresh = (cand_i >= 0) & ~member
    ndis = fresh.sum(1, dtype=torch.int32)
    all_d = torch.cat([buf_d, torch.where(fresh, cand_d, float("inf"))], 1)
    all_p = torch.cat([buf_p, torch.where(fresh, cand_i << 1, -1)], 1)
    d, order = torch.sort(all_d, dim=1, stable=True)
    d = d[:, :ef]
    p = torch.gather(all_p, 1, order[:, :ef])
    dead = torch.arange(ef, device=buf_d.device)[None, :] >= ef_live
    d = torch.where(dead, float("inf"), d)
    p = torch.where(dead, -1, p)
    key = torch.where((p & 1) == 1, float("inf"), d)
    j = torch.argmin(key, dim=1, keepdim=True)               # first on ties
    ok = torch.gather(key, 1, j)[:, 0] < float("inf")
    hit = (torch.arange(ef, device=buf_d.device)[None, :] == j) & ok[:, None]
    cur = torch.where(ok, torch.gather(p, 1, j)[:, 0] >> 1, -1)
    return d, p | hit.to(torch.int32), cur.to(torch.int32), ndis


def beam_update(buf_d: torch.Tensor, buf_p: torch.Tensor,
                cand_i: torch.Tensor, cand_d: torch.Tensor, ef_live: int):
    """buf_d f32 [Q, ef] ascending per row; buf_p int32 [Q, ef]; cand_i
    int32 [Q, K] (-1 = invalid); cand_d f32 [Q, K]; ef_live: host int.
    Returns (buf_d', buf_p', cur int32 [Q], ndis int32 [Q])."""
    check(buf_d, "buf_d", torch.float32, (None, None))
    q, ef = buf_d.shape
    check(buf_p, "buf_p", torch.int32, (q, ef))
    check(cand_i, "cand_i", torch.int32, (q, None))
    check(cand_d, "cand_d", torch.float32, tuple(cand_i.shape))
    k = cand_i.shape[1]
    ef_live = int(ef_live)
    if on_cpu(buf_d, buf_p, cand_i, cand_d):
        return beam_update_plain(buf_d, buf_p, cand_i, cand_d, ef_live)
    if (4 * ef + 5 * k) * 4 > SMEM_LIMIT:
        raise ValueError(f"beam_update: ef={ef}, K={k} exceed one block's "
                         f"shared memory")
    out_d = torch.empty_like(buf_d)
    out_p = torch.empty_like(buf_p)
    cur = torch.empty((q,), dtype=torch.int32, device=buf_d.device)
    ndis = torch.empty((q,), dtype=torch.int32, device=buf_d.device)
    if q:
        _BEAM_UPDATE.launch(buf_d.data_ptr(), buf_p.data_ptr(),
                            cand_i.data_ptr(), cand_d.data_ptr(), q, ef, k,
                            ef_live, out_d.data_ptr(), out_p.data_ptr(),
                            cur.data_ptr(), ndis.data_ptr())
    return out_d, out_p, cur, ndis
