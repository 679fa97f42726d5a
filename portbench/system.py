"""The system under test: ``hnsw_tpu_torch``, the PyTorch and CUDA port,
driven through its public entry points (``HnswIndex``, ``Searcher``) and
read through its own counters. The runners drive the program through this
module. Three other modules of the benchmark import it: ``spans.py``
(``hnsw_tpu_torch.trace``, the program's spans), ``faults.py``
(``HnswIndex``, to break it under the fault tests) and
``probe_sharded.py`` (``hnsw_tpu_torch.parallel.sharded``, the four-card
probe, which is no cell). The reference and the data import nothing of
it.
"""

from __future__ import annotations

import numpy as np


def new_index(cfg: dict, device):
    """An empty ``HnswIndex`` of the configuration (trained for sq8 by
    ``build``)."""
    from hnsw_tpu_torch import HnswIndex
    return HnswIndex(cfg["d"], cfg["m"], cfg["metric"],
                     capacity=cfg["capacity"],
                     ef_construction=cfg["ef_construction"],
                     ef_search=cfg["ef_search"], dtype=cfg["dtype"],
                     device=device)


def build(cfg: dict, base: np.ndarray, device):
    """The configuration's index over ``base``: sq8 trained on its first
    ``sq_train_rows`` rows, one ``add()`` of the whole corpus, then the
    serving tables the configuration names."""
    idx = new_index(cfg, device)
    if cfg["dtype"] == "sq8":
        idx.train(base[:cfg["sq_train_rows"]])
    idx.add(base)
    if cfg.get("packed_bits"):
        idx.enable_packed(bits=cfg["packed_bits"])
    return idx


def search(idx, queries: np.ndarray, k: int, ef: int, stats: bool = False):
    """(D, I[, SearchStats]) of one ``HnswIndex.search`` call."""
    return idx.search(queries, k, ef_search=ef, with_stats=stats)


def searcher(idx, k: int, ef: int):
    from hnsw_tpu_torch.serving import Searcher
    return Searcher(idx, k=k, ef_search=ef)


def build_stats(idx) -> dict:
    """The last ``add()``'s ``StagedBuild.stats()``."""
    return dict(idx._builder.last_stats)


def stored_rows(idx) -> np.ndarray:
    """The rows ``add()`` stored, [ntotal, d] (f32 storage)."""
    return idx.vectors[:idx.ntotal].float().cpu().numpy()


def level0(idx) -> np.ndarray:
    """The level-0 adjacency, [ntotal, m0] int32, -1 padded."""
    return idx.graph.neighbors0[:idx.ntotal].cpu().numpy()


def launches() -> dict:
    """{kernel: launches} and {kernel/tag: launches} so far."""
    from hnsw_tpu_torch.ops import _cuda
    out = dict(_cuda.launch_counts())
    for name, tags in _cuda.tagged_launch_counts().items():
        for tag, n in tags.items():
            out[f"{name}/{tag}"] = n
    return out
