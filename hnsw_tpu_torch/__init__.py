"""hnsw_tpu_torch — the PyTorch / CUDA port of ``hnsw_tpu`` for NVIDIA
Hopper (H100).

The module layout follows ``hnsw_tpu`` file by file. The three TPU kernels
of the main path are hand-written CUDA C++ under ``csrc/`` (K1
``ops/beam_kernel.py``, K2 and K3 ``ops/dist_kernel.py``), built with nvcc
for sm_90a on first use. This package imports torch and numpy only: never
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
from .models.hnsw import HnswIndex  # noqa: E402
from .utils.datasets import synthetic_workload  # noqa: E402

__all__ = ["IP", "L2", "HnswConfig", "HnswIndex", "synthetic_workload"]
