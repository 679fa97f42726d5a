"""Sharded index on the PyTorch / CUDA port: per-shard build, fan-out
search, packed serving, elastic degradation, on a 4 x 2 mesh of one
device (eight entries of the same card or of the CPU). A shard's state
lives on its mesh row's device, so the rows may repeat one card.

    python examples/torch_sharded_mesh.py [--device cpu] [--nq Q] [--n 20000]

Across processes (one per card), initialize ``torch.distributed`` first
and pass each rank's own devices; see README.md.
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from hnsw_tpu_torch import ShardedHnswIndex, make_mesh


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nq", type=int, default=512, help="queries")
    ap.add_argument("--n", type=int, default=20_000)
    args = ap.parse_args()
    dev = torch.device(args.device)
    mesh = make_mesh(4, 2, devices=[dev] * 8)
    print("mesh:", mesh.shape)

    rng = np.random.default_rng(0)
    xb = rng.random((args.n, 64), np.float32)
    xq = rng.random((args.nq, 64), np.float32)

    index = ShardedHnswIndex(64, 16, "l2", mesh=mesh,
                             capacity_per_shard=args.n // 4 + 1024,
                             ef_construction=80)
    index.add(xb)                   # the shards' builds, in lockstep
    D, I = index.search(xq, 10, ef_search=64)
    print(f"ntotal={index.ntotal}  shard counts={index._counts.tolist()}")

    # packed serving: a code table per shard
    nbytes = index.enable_packed(bits=8)
    D2, I2 = index.search(xq, 10, ef_search=64)
    print(f"packed tables: {nbytes / 1e6:.1f} MB, id agreement with "
          f"unpacked: {(I == I2).mean():.3f}")

    # elastic serving: a failed shard degrades coverage, not availability
    index.mark_shard_failed(2)
    D3, I3 = index.search(xq, 10, ef_search=64)
    assert not (I3[I3 >= 0] % 4 == 2).any()
    print(f"degraded (shard 2 out): still {I3.shape} results, "
          f"failed={index.failed_shards}")
    index.mark_shard_ok(2)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sharded.npz")
        index.save(path)
        back = ShardedHnswIndex.load(path, mesh=mesh)
    assert back.ntotal == index.ntotal
    print("save/load over the mesh: ok")


if __name__ == "__main__":
    main()
