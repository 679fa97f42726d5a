"""K5 ``fused_gather_distances``: the fused gather + distance of every hop
under ``HNSW_TPU_PALLAS_HOP=1``, C entry in ``csrc/hop_kernel.cu``.

[capacity, d] f32 or bf16 table x [Q, K] ids x [Q, d] queries -> [Q, K]
surrogate distances ``Σv² − 2 q·v`` (L2) or ``−q·v`` (IP) of the rows
``vectors[clamp(ids, 0, capacity − 1)]``, gathered inside the kernel. This
is K3's function without the dequant affine, and the kernel runs K3's row
engines (``csrc/vec_dist.cuh``): its output equals
``gathered_vec_dist_ids(vectors, ids, queries)`` bit for bit. bf16 rows are
widened to f32 in registers (exact), never copied to an f32 table;
launches are counted under this kernel's own name, and also by row dtype
("float32", "bfloat16"). Any Q, K and d (the reference needs Q % 8 == 0 and
d % 128 == 0): the kernel keeps the query in registers, not shared memory.

The plain PyTorch version sits beside it; the wrapper runs it for CPU
tensors and launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from ..config import IP, L2
from ._cuda import CudaKernel, check, on_cpu

_GATHER_DIST = CudaKernel("fused_gather_distances", "hnsw_gather_dist")
_ROW_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_gather_distances_plain(vectors, ids, queries, metric=L2):
    v = vectors[ids.long().clamp(0, vectors.shape[0] - 1)].float()  # [Q, K, d]
    dots = (v * queries[:, None, :]).sum(-1)
    if metric == IP:
        return -dots
    return (v * v).sum(-1) - 2.0 * dots


def fused_gather_distances(vectors: torch.Tensor, ids: torch.Tensor,
                           queries: torch.Tensor,
                           metric: str = L2) -> torch.Tensor:
    """vectors f32 or bf16 [capacity, d], ids int32 [Q, K] (negative and
    out-of-range ids read the nearest end row; callers mask the result),
    queries f32 [Q, d]. Returns f32 [Q, K]."""
    if metric not in (L2, IP):
        raise ValueError(f"metric must be {L2!r} or {IP!r}, got {metric!r}")
    if vectors.dtype not in _ROW_DTYPES:
        raise ValueError(f"vectors: expected torch.float32 or "
                         f"torch.bfloat16, got {vectors.dtype}")
    check(vectors, "vectors", vectors.dtype, (None, None))
    cap, d = vectors.shape
    check(ids, "ids", torch.int32, (None, None))
    q, k = ids.shape
    check(queries, "queries", torch.float32, (q, d))
    if cap == 0:
        raise ValueError("fused_gather_distances: empty table")
    if on_cpu(vectors, ids, queries):
        return fused_gather_distances_plain(vectors, ids, queries, metric)
    out = torch.empty((q, k), dtype=torch.float32, device=vectors.device)
    if q and k:
        _GATHER_DIST.launch(vectors.data_ptr(), _ROW_DTYPES[vectors.dtype],
                            cap, d, ids.data_ptr(), q, k, queries.data_ptr(),
                            int(metric == IP), out.data_ptr())
        _GATHER_DIST.count_tag(str(vectors.dtype).removeprefix("torch."))
    return out
