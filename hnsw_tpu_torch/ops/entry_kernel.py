"""K6 ``entry_scan``: the search's sampled entry scan, CUDA kernel in
``csrc/entry_kernel.cu``.

queries f32 [Q, d], the decoded sample ``sv`` f32 [S, d], ``svsq`` f32 [S]
(its rows' squared norms), ``ok`` bool [S] (the rows that may seed) and
``n_seeds`` equal contiguous strata of S // n_seeds rows. For every query and
stratum: the index within the stratum of the least ``svsq - 2 q·sv`` (L2) or
``-q·sv`` (IP) over the rows with ``ok``, the first on a tie, or -1 where the
stratum has no finite distance. int32 [Q, n_seeds].

The kernel forms the product in f32 on the FFMA units and keeps each
stratum's minimum in registers, so the [Q, S] distance block is never
written. Its sums run in another order than the plain version's matmul, so
a near-tie may pick another row. The plain version (``entry_scan_plain``,
the search's scan as it was composed of PyTorch ops) runs for CPU tensors.
CUDA tensors with strata of fewer than ``MIN_STRATUM`` rows are refused; no
search makes them (``entry_sample_size`` gives at least 128 rows and the
seed mode at most 16 strata).
"""

from __future__ import annotations

import torch

from ..config import IP, L2
from ._cuda import CudaKernel, check, on_cpu

_ENTRY_SCAN = CudaKernel("entry_scan", "hnsw_entry_scan")

MIN_STRATUM = 8          # the least stratum the kernel takes (csrc kMinStratum)


def entry_scan_plain(queries, sv, svsq, ok, n_seeds: int, metric=L2,
                     tile_q: int = 2048):
    """[tile_q, S] distance blocks, each stratum's argmin (first on ties)
    and -1 where its least distance is not finite."""
    ss = sv.shape[0] // n_seeds
    out = []
    for q0 in range(0, queries.shape[0], tile_q):
        dots = queries[q0:q0 + tile_q].float() @ sv.T
        dist = -dots if metric == IP else svsq[None, :] - 2.0 * dots
        dist = torch.where(ok[None, :], dist, float("inf")).view(-1, n_seeds,
                                                                 ss)
        j = torch.argmin(dist, dim=2)                            # first on ties
        cd = torch.gather(dist, 2, j[..., None])[..., 0]
        out.append(torch.where(torch.isfinite(cd), j, -1))
    return torch.cat(out).to(torch.int32)


def entry_scan(queries: torch.Tensor, sv: torch.Tensor, svsq: torch.Tensor,
               ok: torch.Tensor, n_seeds: int,
               metric: str = L2) -> torch.Tensor:
    """queries f32 [Q, d], sv f32 [S, d], svsq f32 [S], ok bool [S], all
    contiguous; S a multiple of ``n_seeds``. Returns int32 [Q, n_seeds]:
    each stratum's argmin within it, or -1."""
    if metric not in (L2, IP):
        raise ValueError(f"metric must be {L2!r} or {IP!r}, got {metric!r}")
    check(queries, "queries", torch.float32, (None, None))
    q, d = queries.shape
    check(sv, "sv", torch.float32, (None, d))
    s = sv.shape[0]
    check(svsq, "svsq", torch.float32, (s,))
    check(ok, "ok", torch.bool, (s,))
    n_seeds = int(n_seeds)
    if n_seeds < 1 or s % n_seeds:
        raise ValueError(f"entry_scan: {s} sample rows do not cut into "
                         f"{n_seeds} equal strata")
    if on_cpu(queries, sv, svsq, ok):
        return entry_scan_plain(queries, sv, svsq, ok, n_seeds, metric)
    if s // n_seeds < MIN_STRATUM or s >= 1 << 31:
        raise ValueError(f"entry_scan: strata of {s // n_seeds} rows, {s} "
                         f"rows in all; the kernel takes strata of at least "
                         f"{MIN_STRATUM} and fewer than 2**31 rows")
    dev = queries.device
    keys = torch.empty((q, n_seeds), dtype=torch.int64, device=dev)
    out = torch.empty((q, n_seeds), dtype=torch.int32, device=dev)
    if q:
        _ENTRY_SCAN.launch(queries.data_ptr(), q, d, sv.data_ptr(),
                           svsq.data_ptr(), ok.data_ptr(), s, n_seeds,
                           int(metric == IP), keys.data_ptr(), out.data_ptr())
    return out
