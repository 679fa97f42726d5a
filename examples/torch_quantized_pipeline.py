"""Quantized serving pipeline on the PyTorch / CUDA port: OPQ rotation ->
HNSW over PQ codes -> exact rerank, the faiss "OPQ16,HNSW16,PQ16,RFlat"
composition built with the same index_factory grammar.

    python examples/torch_quantized_pipeline.py [--device cpu] [--nq Q] \
        [--n 15000]
"""

import argparse

import numpy as np

from hnsw_tpu_torch import FlatIndex, index_factory


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nq", type=int, default=500, help="queries")
    ap.add_argument("--n", type=int, default=15_000)
    args = ap.parse_args()
    n, dev = args.n, args.device
    rng = np.random.default_rng(0)
    # correlated data: the regime OPQ exists for
    w = rng.standard_normal((64, 64)) * np.linspace(2.0, 0.05, 64)
    xb = (rng.standard_normal((n, 64)) @ w.T).astype(np.float32)
    xq = (rng.standard_normal((args.nq, 64)) @ w.T).astype(np.float32)

    # 16 bytes a vector + a learned rotation + an exact f32 rerank
    index = index_factory(64, "OPQ16,HNSW16,PQ16,RFlat", capacity=n + 1024,
                          ef_construction=100, k_factor=8.0, device=dev)
    index.train(xb)          # the OPQ rotation, then the PQ codebooks
    index.add(xb)
    D, I = index.search(xq, 10, ef_search=96)

    flat = FlatIndex(64, device=dev)
    flat.add(xb)
    _, gt = flat.search(xq, 10)
    r = (I[:, :, None] == gt[:, None, :]).any(-1).mean()
    print(f"OPQ16,HNSW16,PQ16,RFlat recall@10 vs exact GT: {r:.4f}")

    # without the rerank, the PQ codes cap recall much lower
    inner = index.index.index      # PreTransform -> Refine -> HnswIndex
    tq = index.transforms[0].apply(xq)
    _, I_pq = inner.search(tq, 10, ef_search=96)
    r_pq = (I_pq[:, :, None] == gt[:, None, :]).any(-1).mean()
    print(f"same index without rerank:            {r_pq:.4f}")


if __name__ == "__main__":
    main()
