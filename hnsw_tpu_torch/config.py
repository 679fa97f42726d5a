"""Index configuration — the same ``HnswConfig`` as ``hnsw_tpu.config``.

Fields, defaults, validation and JSON are kept identical so a config written
by either package loads in the other. Storage dtypes other than float32 pass
validation here (the config must interchange) but ``HnswIndex`` refuses them
until the storage codecs are ported.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any

L2 = "l2"
IP = "ip"
_METRICS = (L2, IP)

# Sentinel for "empty neighbor slot" / "unassigned node" throughout the graph
# arrays. Chosen negative so validity tests are a single `>= 0` compare.
NO_NEIGHBOR = -1


@dataclasses.dataclass(frozen=True)
class HnswConfig:
    """Static hyperparameters of an HNSW index (faiss ``IndexHNSWFlat``
    semantics: ``m`` links per node on levels >= 1, ``m0`` = 2m on level 0,
    ``level_mult`` = 1/ln(m)).

    ``capacity`` preallocates every per-node array; ``max_level_cap`` bounds
    the upper levels; ``upper_capacity`` sizes the compacted upper-level
    adjacency (only ~capacity/m nodes have level >= 1)."""

    dim: int
    m: int = 32
    metric: str = L2
    capacity: int = 1_000_000
    m0: int = -1  # -1 -> 2*m (faiss default)
    ef_construction: int = 200
    ef_search: int = 64
    level_mult: float = -1.0  # -1 -> 1/ln(m)
    max_level_cap: int = 6
    upper_capacity: int = -1  # -1 -> auto
    dtype: str = "float32"  # vector storage: float32 | bfloat16 | sq8 | pq
    pq_m: int = 0
    pq_bits: int = 8
    seed: int = 42

    def __post_init__(self):
        if self.metric not in _METRICS:
            raise ValueError(f"metric must be one of {_METRICS}, got {self.metric!r}")
        if self.dim <= 0 or self.m <= 1 or self.capacity <= 0:
            raise ValueError("dim, m, capacity must be positive (m > 1)")
        if self.dtype not in ("float32", "bfloat16", "sq8", "pq"):
            raise ValueError(f"unsupported storage dtype {self.dtype!r}")
        if self.dtype == "pq":
            if self.pq_m <= 0 or self.dim % self.pq_m:
                raise ValueError(
                    f"dtype='pq' needs pq_m > 0 dividing dim "
                    f"(got pq_m={self.pq_m}, dim={self.dim})")
        elif self.pq_m:
            raise ValueError("pq_m is only meaningful with dtype='pq'")
        if self.pq_bits not in (4, 8):
            raise ValueError(f"pq_bits must be 4 or 8, got {self.pq_bits}")
        if self.capacity >= 1 << 24:
            # kept from the reference so configs interchange; the port has no
            # f32 id arithmetic, so lifting this is a later feature
            raise ValueError("capacity must be < 2^24 per (shard) index; "
                             "use ShardedHnswIndex for larger corpora")
        if self.m0 == -1:
            object.__setattr__(self, "m0", 2 * self.m)
        if self.level_mult < 0:
            object.__setattr__(self, "level_mult", 1.0 / math.log(self.m))
        if self.upper_capacity == -1:
            auto = max(1024, 4 * self.capacity // self.m)
            object.__setattr__(self, "upper_capacity", min(auto, self.capacity))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "HnswConfig":
        d: dict[str, Any] = json.loads(s)
        return cls(**d)

    def replace(self, **kw) -> "HnswConfig":
        return dataclasses.replace(self, **kw)
