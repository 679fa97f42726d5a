"""Quickstart on the PyTorch / CUDA port: build, search, persist — the
faiss IndexHNSWFlat flow.

Runs on the first CUDA card by default; ``--device cpu`` runs the kernels'
plain PyTorch versions on the host (slow: for checking, not serving).

    python examples/torch_quickstart.py [--device cpu] [--nq Q] [--n 20000]
"""

import argparse
import os
import tempfile

import numpy as np

import hnsw_tpu_torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nq", type=int, default=1_000, help="queries")
    ap.add_argument("--n", type=int, default=20_000)
    args = ap.parse_args()
    n, dev = args.n, args.device
    rng = np.random.default_rng(0)
    xb = rng.random((n, 128), np.float32)          # database
    xq = rng.random((args.nq, 128), np.float32)    # queries

    # faiss: index = faiss.IndexHNSWFlat(128, 32)
    index = hnsw_tpu_torch.HnswIndex(128, 32, "l2", capacity=n + 1024,
                                     ef_construction=100, device=dev)
    index.add(xb)                                  # batched on-device build
    index.ef_search = 64                           # faiss: hnsw.efSearch
    D, I = index.search(xq, k=10)
    print(f"ntotal={index.ntotal}  first hit id={I[0, 0]} "
          f"dist={D[0, 0]:.4f}")

    # exact ground truth (faiss IndexFlat) -> recall
    flat = hnsw_tpu_torch.FlatIndex(128, device=dev)
    flat.add(xb)
    _, gt = flat.search(xq, 10)
    recall = (I[:, :, None] == gt[:, None, :]).any(-1).mean()
    print(f"recall@10 = {recall:.4f}")

    # persist + reload: results are bit-identical
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "quickstart.npz")
        index.save(path)
        index2 = hnsw_tpu_torch.HnswIndex.load(path, device=dev)
    D2, I2 = index2.search(xq, k=10)
    assert (I == I2).all() and (D == D2).all()
    print("save/load roundtrip: identical results")

    # deletion: tombstone, then physically unlink
    index.remove_ids(np.arange(0, n, 2))           # drop every even id
    index.vacuum()                                 # re-prune routing
    _, I3 = index.search(xq, k=10)
    assert (I3[I3 >= 0] % 2 == 1).all()
    print("deletion + vacuum: only odd ids returned")


if __name__ == "__main__":
    main()
