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

``beam_hop`` is the fused beam's whole hop on the same kernel, in place:
it reads each query's ``cur`` and, where the query steps, the adjacency
row ``nbrs[cur]`` for its candidates, then merges, selects, adds the fresh
count to ``ndis`` and one to ``steps``. Its plain version is the hop as
plain PyTorch composes it around ``beam_update_plain``.
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


def beam_hop_plain(buf_d, buf_p, cur, ndis, steps, nbrs, cand_d, ef_live,
                   limit):
    """The hop composed of plain PyTorch ops: a query steps where its cur
    is a node and its steps are below ``limit``; it expands cur's
    adjacency row (-1 entries and the rows of queries that do not step
    masked to -1) through ``beam_update_plain`` at the full width, the
    slots past ``ef_live`` killed after it (a cur that sat there dropped),
    and every query that does not step keeps its state."""
    ef = buf_d.shape[1]
    go = (cur >= 0) & (steps < limit)                            # [Q]
    cand_i = nbrs[torch.where(go, cur, 0).long()]                # [Q, K]
    cand_i = torch.where((cand_i >= 0) & go[:, None], cand_i, -1)
    d, p, c, nd = beam_update_plain(buf_d, buf_p, cand_i, cand_d, ef)
    if ef_live is not None:
        dead = torch.arange(ef, device=buf_d.device)[None, :] >= ef_live
        d = torch.where(dead, float("inf"), d)
        p = torch.where(dead, -1, p)
        c = torch.where(((p >> 1) == c[:, None]).any(1), c, -1)
    g = go[:, None]
    return (torch.where(g, d, buf_d), torch.where(g, p, buf_p),
            torch.where(go, c, cur), ndis + torch.where(go, nd, 0),
            steps + go.to(torch.int32))


def _scalar(t, name: str, device) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int64 \
            or t.numel() != 1 or t.device != device:
        raise ValueError(f"{name}: expected a one-element int64 tensor on "
                         f"{device}")


def beam_hop(buf_d: torch.Tensor, buf_p: torch.Tensor, cur: torch.Tensor,
             ndis: torch.Tensor, steps: torch.Tensor, nbrs: torch.Tensor,
             cand_d: torch.Tensor, ef_live, limit: torch.Tensor):
    """One hop of the fused beam for every query whose ``cur`` is a node
    (not -1) and whose ``steps`` are below ``limit``; every other query's
    state is left exactly as it is. buf_d f32 [Q, ef] ascending per row,
    buf_p int32 [Q, ef], cur / ndis / steps int32 [Q], nbrs int32 [N, K]
    (the adjacency: query q's candidates are ``nbrs[cur[q]]``, -1 = none),
    cand_d f32 [Q, K] (their distances, read only where the query steps),
    ef_live None (the whole buffer) or, like limit, a one-element int64
    tensor. Returns (buf_d, buf_p, cur, ndis, steps): on a CUDA device the
    same tensors, updated in place by one launch (counted as K1's, and by
    the tag "hop"); on the CPU the plain version's new ones."""
    check(buf_d, "buf_d", torch.float32, (None, None))
    q, ef = buf_d.shape
    check(buf_p, "buf_p", torch.int32, (q, ef))
    for t, name in ((cur, "cur"), (ndis, "ndis"), (steps, "steps")):
        check(t, name, torch.int32, (q,))
    check(nbrs, "nbrs", torch.int32, (None, None))
    k = nbrs.shape[1]
    check(cand_d, "cand_d", torch.float32, (q, k))
    dev = buf_d.device
    _scalar(limit, "limit", dev)
    if ef_live is not None:
        _scalar(ef_live, "ef_live", dev)
    if on_cpu(buf_d, buf_p, cur, ndis, steps, nbrs, cand_d):
        return beam_hop_plain(buf_d, buf_p, cur, ndis, steps, nbrs, cand_d,
                              ef_live, limit)
    if (4 * ef + 5 * k) * 4 > SMEM_LIMIT:
        raise ValueError(f"beam_hop: ef={ef}, K={k} exceed one block's "
                         f"shared memory")
    if q:
        _BEAM_UPDATE.launch(buf_d.data_ptr(), buf_p.data_ptr(),
                            nbrs.data_ptr(), nbrs.shape[0],
                            cand_d.data_ptr(), q, ef, k,
                            None if ef_live is None else ef_live.data_ptr(),
                            limit.data_ptr(), cur.data_ptr(),
                            ndis.data_ptr(), steps.data_ptr(),
                            symbol="hnsw_beam_hop")
        _BEAM_UPDATE.count_tag("hop")
    return buf_d, buf_p, cur, ndis, steps
