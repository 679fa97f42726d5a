"""The benchmark's own data, made from ``--seed``.

A frozen copy of the method of ``hnsw_tpu_torch.utils.datasets.
synthetic_workload``: a Gaussian mixture of ``n_clusters`` centres (one
N(0, 1) draw a coordinate), each base vector a centre plus N(0, 0.35)
noise, each query drawn the same way around the same centres, so a query's
neighbours are points of its own cluster and not the centre. Drawn on the
device with one ``torch.Generator`` in a few large calls, so set-up stays
short. The program never sees the seed, only the arrays made here; the
reference gets the same arrays.
"""

from __future__ import annotations

import math

import torch

SEED_MOD = 1 << 63       # torch.Generator takes seeds below 2**64


def generator(seed: int, device) -> torch.Generator:
    """The data's generator on ``device`` for ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) * 1_000_003 % SEED_MOD)
    return g


def n_clusters_for(n: int) -> int:
    """synthetic_workload's default: max(16, int(sqrt(n) // 4))."""
    return max(16, math.isqrt(n) // 4)


def gaussian_mixture(n: int, d: int, n_queries: int, seed: int, device, *,
                     n_clusters: int | None = None, center_std: float = 1.0,
                     noise_std: float = 0.35):
    """(base [n, d], queries [n_queries, d]) float32 on ``device``."""
    g = generator(seed, device)
    c = n_clusters or n_clusters_for(n)
    centers = torch.randn(c, d, generator=g, device=device) * center_std
    assign = torch.randint(0, c, (n,), generator=g, device=device)
    base = torch.randn(n, d, generator=g, device=device).mul_(noise_std)
    base += centers[assign]
    qassign = torch.randint(0, c, (n_queries,), generator=g, device=device)
    queries = torch.randn(n_queries, d, generator=g, device=device)
    queries.mul_(noise_std).add_(centers[qassign])
    return base, queries


def make(cfg: dict, n_queries: int, seed: int, device):
    """The configuration's data for ``seed``: (base, queries) on
    ``device``."""
    data = cfg["data"]
    return gaussian_mixture(cfg["n"], cfg["d"], n_queries, seed, device,
                            n_clusters=data.get("n_clusters"),
                            center_std=data["center_std"],
                            noise_std=data["noise_std"])
