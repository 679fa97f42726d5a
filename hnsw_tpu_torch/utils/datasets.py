"""Synthetic workloads — the same generator as ``hnsw_tpu.utils.datasets``.

``synthetic_workload`` draws the identical vectors from the same seed, so
both packages build and search the same data. The file readers (fvecs,
ivecs, fbin, hdf5) and the named eval configs are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Workload:
    name: str
    base: np.ndarray           # [n, d] float32 database vectors
    queries: np.ndarray        # [q, d] float32
    metric: str                # "l2" | "ip"
    ground_truth: np.ndarray | None = None  # [q, k] int (exact NN ids), optional
    meta: dict = field(default_factory=dict)


def synthetic_workload(
    n: int,
    d: int,
    n_queries: int = 1000,
    metric: str = "l2",
    n_clusters: int | None = None,
    seed: int = 1234,
    name: str | None = None,
) -> Workload:
    """Seeded Gaussian-mixture database + queries drawn near the same clusters.

    Queries are perturbed database-distribution samples, so nearest neighbors
    are non-trivial (not the cluster centroid) — matching how SIFT queries
    relate to the SIFT base set.
    """
    rng = np.random.default_rng(seed)
    if n_clusters is None:
        n_clusters = max(16, int(np.sqrt(n) // 4))
    centers = rng.normal(0.0, 1.0, size=(n_clusters, d)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    base = centers[assign] + rng.normal(0.0, 0.35, size=(n, d)).astype(np.float32)
    qassign = rng.integers(0, n_clusters, size=n_queries)
    queries = centers[qassign] + rng.normal(0.0, 0.35, size=(n_queries, d)).astype(
        np.float32
    )
    if metric == "ip":
        # normalize -> inner product == cosine, the ann-benchmarks "angular"
        base /= np.linalg.norm(base, axis=1, keepdims=True) + 1e-30
        queries /= np.linalg.norm(queries, axis=1, keepdims=True) + 1e-30
    return Workload(
        name=name or f"synthetic-{n}x{d}-{metric}",
        base=base.astype(np.float32),
        queries=queries.astype(np.float32),
        metric=metric,
        meta={"n_clusters": n_clusters, "seed": seed},
    )
