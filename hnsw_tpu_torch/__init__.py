"""hnsw_tpu_torch — the PyTorch / CUDA port of ``hnsw_tpu`` for NVIDIA
Hopper (H100).

The module layout follows ``hnsw_tpu`` file by file. The five TPU kernels
are hand-written CUDA C++ under ``csrc/`` (K1 ``ops/beam_kernel.py``; K2,
K3 and K4 ``ops/dist_kernel.py``; K5 ``ops/hop_kernel.py``), built with
nvcc for sm_90a on first use. This package imports torch and numpy only: never
jax, never ``hnsw_tpu``.

Ranking math runs in exact float32: importing the package turns TF32 off
for matmuls and cuDNN and sets float32 matmul precision to "highest"
(process-wide), because TF32 keeps ~3 decimal digits and truncated
products in the exact oracle capped recall in the reference's history.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .config import IP, L2, HnswConfig  # noqa: E402
from .graph import (GraphArrays, check_invariants, load_graph,  # noqa: E402
                    save_graph)
from .models.brute import FlatIndex  # noqa: E402
from .models.hnsw import HnswIndex  # noqa: E402
from .ops.distances import brute_force_topk  # noqa: E402
from .ops.packed import PackedNeighbors, pack_neighbors  # noqa: E402
from .search import hnsw_search  # noqa: E402
from .utils.datasets import synthetic_workload  # noqa: E402

__all__ = [
    "IP", "L2", "HnswConfig", "GraphArrays", "HnswIndex", "FlatIndex",
    "brute_force_topk", "hnsw_search", "check_invariants",
    "PackedNeighbors", "pack_neighbors", "save_graph", "load_graph",
    "synthetic_workload",
]
