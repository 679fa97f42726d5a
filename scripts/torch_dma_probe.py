"""The per-row copy rate of the TPU probes ``scripts/dma_rate_probe.py``
(P1: one row a query, by row size) and ``scripts/dma_rate_probe2.py`` (P2:
G rows of 8 KB a loop iteration), on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 scripts/torch_dma_probe.py

The probes' tables (200,000 rows of uint8, filled from a seed) and their
8,192 random row ids a hop, read by the hand-written gather ceiling of
``scripts/torch_kernel_ab.py`` (16-byte loads, no arithmetic: the least
time this card takes to fetch the rows) and by ``torch.index_select`` (the
plain PyTorch version, which also writes the rows out), each timed with
``chip_smoke.time_ms`` and printed beside its bound (the distinct rows'
bytes over the HBM rate) with rows/s and GB/s. P1's rows are 2, 8 and
32 KB with one id a query; P2's are 8 KB with the ids grouped G = 8, 16
and 32 a query. P3's fused row fetch plus distance is K2
(``packed_row_dist_ids``), which ``chip_smoke.py`` times.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import chip_smoke as cs  # noqa: E402
import torch_kernel_ab as ab  # noqa: E402

N_ROWS, Q = 200_000, 8192        # the probes' table rows and ids a hop
CASES = [("P1", 2048, 1), ("P1", 8192, 1), ("P1", 32768, 1),
         ("P2", 8192, 8), ("P2", 8192, 16), ("P2", 8192, 32)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_dma_probe: CUDA is not available")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        lib = ab.build_ceiling(Path(tmp))
        for probe, row_bytes, g in CASES:
            table = torch.randint(0, 256, (N_ROWS, row_bytes), generator=gen,
                                  device=dev, dtype=torch.uint8)
            ids = torch.randint(0, N_ROWS, (Q // g, g), generator=gen,
                                device=dev, dtype=torch.int32)
            flat = ids.reshape(-1).long()
            ms = ab.ceiling_ms(lib, table, ids)
            plain = cs.time_ms(lambda: torch.index_select(table, 0, flat))
            b = cs.bound(torch.unique(flat).numel() * row_bytes, 0)
            cs.log(f"{probe} rows of {row_bytes} B, {g} a query ({Q} rows): "
                   f"ceiling {ms:.4f} ms ({Q / ms / 1e3:.1f} M rows/s, "
                   f"{Q * row_bytes / ms / 1e6:.0f} GB/s), index_select "
                   f"{plain:.4f} ms, bound {b['bound_ms']:.4f} ms by bytes "
                   f"({b['bound_ms'] / ms:.1%} of it)")
            del table


if __name__ == "__main__":
    main()
