"""Query statistics aggregation (faiss ``hnsw_stats``), ported from
``hnsw_tpu.utils.stats``.

faiss keeps global counters (n1/n2/ndis/nhops) that every search bumps.
Here a search returns a ``SearchStats`` per batch (``with_stats=True``);
``HnswStats`` aggregates them the way faiss's global object does, plus the
batch latency percentiles.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


@dataclasses.dataclass
class HnswStats:
    nqueries: int = 0
    nbatches: int = 0
    nhops: int = 0          # level-0 loop iterations (batch-wide)
    ndis: int = 0           # distance computations
    wall_seconds: float = 0.0
    _lat: list = dataclasses.field(default_factory=list)

    def accumulate(self, n_queries: int, stats, wall: float | None = None):
        """stats: ``hnsw_tpu_torch.search.SearchStats`` of one batch."""
        self.nqueries += int(n_queries)
        self.nbatches += 1
        self.nhops += int(stats.hops)
        ndis = stats.ndis
        self.ndis += int(ndis.sum()) if isinstance(ndis, torch.Tensor) \
            else int(np.asarray(ndis).sum())
        if wall is not None:
            self.wall_seconds += wall
            self._lat.append(wall)

    def reset(self):
        self.__init__()

    @property
    def qps(self) -> float:
        return self.nqueries / self.wall_seconds if self.wall_seconds else 0.0

    def summary(self) -> dict:
        lat = np.asarray(self._lat) if self._lat else np.zeros(1)
        return {
            "nqueries": self.nqueries,
            "nbatches": self.nbatches,
            "hops_per_batch": self.nhops / max(self.nbatches, 1),
            "ndis_per_query": self.ndis / max(self.nqueries, 1),
            "qps": round(self.qps, 1),
            "batch_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 2),
            "batch_p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 2),
        }


class Timer:
    """Wall timer. Device work is asynchronous: finish the timed work with
    a host read (``search`` returns numpy) or ``torch.cuda.synchronize()``
    inside the ``with`` block, or the time is the enqueue's."""

    def __init__(self):
        self.t0 = None
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.time() - self.t0
        return False
