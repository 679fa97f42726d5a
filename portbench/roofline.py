"""Peaks of the card and the operations and bytes a kernel's work needs.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the full 700 W.

A roofline share is the least time the chip could take (the larger of
bytes over the memory bandwidth and operations over the float32 rate)
over the kernel's measured time. The counts take what the inputs need,
each needed byte once: where the program's counters do not say a size,
the count takes the smallest the work can need, so a share errs low.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12       # HBM3, 80 GB
F32_FLOPS = 67e12               # float32 outside the tensor cores


def bound_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def vec_dist_work(ndis: int, launches: int, q_rows: int, d: int,
                  row_bytes: int) -> tuple[float, float]:
    """(bytes, flops) of K3's (gathered-row distance) launches in a window:
    ``ndis`` fresh (query, row) distances, each reading its row once
    (``row_bytes``) and taking at least one multiply-add a dimension;
    each launch reading its ``q_rows`` f32 query rows and writing at least
    one f32 distance a query row."""
    nbytes = ndis * row_bytes + launches * q_rows * (d * 4 + 4)
    flops = ndis * 2.0 * d
    return float(nbytes), float(flops)


def share_percent(nbytes: float, flops: float, seconds: float):
    """The roofline share in %, or None when nothing ran."""
    if seconds <= 0 or (nbytes <= 0 and flops <= 0):
        return None
    return 100.0 * bound_seconds(nbytes, flops) / seconds
