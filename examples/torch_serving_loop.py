"""Serving pattern on the PyTorch / CUDA port: many small requests
micro-batched into device-shaped launches with ``Searcher``.

    python examples/torch_serving_loop.py [--device cpu] [--n 20000]
"""

import argparse

import numpy as np

from hnsw_tpu_torch import HnswIndex, Searcher


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=20_000)
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    xb = rng.random((args.n, 64), np.float32)
    index = HnswIndex(64, 16, "l2", capacity=args.n + 1024,
                      ef_construction=80, device=args.device)
    index.add(xb)

    s = Searcher(index, k=10, ef_search=64, max_bucket=1024)

    # direct mode: any request size, padded to power-of-two buckets
    for n in (1, 3, 17, 500):
        D, I = s.search(rng.random((n, 64), np.float32))
        assert I.shape == (n, 10)

    # coalescing mode: queue tiny requests, serve them in one launch
    handles = [s.submit(rng.random((rng.integers(1, 8), 64), np.float32))
               for _ in range(20)]
    s.flush()
    total = sum(s.result(h)[1].shape[0] for h in handles)
    st = s.stats
    print(f"served {st['queries_served']} queries in {st['launches']} "
          f"launches ({st['rows_padded']} padded rows); "
          f"coalesced batch covered {total} rows")

    # ef is a runtime value: any ef in the same bucket
    s.search(rng.random((8, 64), np.float32), ef_search=128)
    s.search(rng.random((8, 64), np.float32), ef_search=32)
    print("ef sweeps served from the same buckets")


if __name__ == "__main__":
    main()
