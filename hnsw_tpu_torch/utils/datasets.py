"""Dataset loading and synthetic workloads, ported from
``hnsw_tpu.utils.datasets``.

The readers take the eval configs of BASELINE.json (SIFT10K / SIFT1M /
GIST1M in TEXMEX .fvecs / .ivecs, GloVe-100 in ann-benchmarks HDF5,
Deep10M in .fbin); ``load_eval_workload`` falls back to a seeded synthetic
workload of the same shape when the files are absent. ``synthetic_workload``
draws the reference's vectors from the same seed, so both packages build
and search the same data.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np


# ---------------------------------------------------------------------------
# TEXMEX / common ANN file formats
# ---------------------------------------------------------------------------

def read_fvecs(path: str, count: int = -1) -> np.ndarray:
    """TEXMEX .fvecs: each row is [int32 d][d float32]."""
    with open(path, "rb") as f:
        head = f.read(4)
        if len(head) < 4:
            return np.empty((0, 0), np.float32)
        d = struct.unpack("<i", head)[0]
    row = 1 + d
    data = np.fromfile(path, dtype=np.float32,
                       count=-1 if count < 0 else count * row)
    data = data.reshape(-1, row)
    if not np.all(data[:, 0].view(np.int32) == d):
        raise ValueError(f"{path}: inconsistent row dims in fvecs file")
    return np.ascontiguousarray(data[:, 1:])


def read_ivecs(path: str, count: int = -1) -> np.ndarray:
    """TEXMEX .ivecs: each row is [int32 d][d int32] (ground truth)."""
    with open(path, "rb") as f:
        head = f.read(4)
        if len(head) < 4:
            return np.empty((0, 0), np.int32)
        d = struct.unpack("<i", head)[0]
    row = 1 + d
    data = np.fromfile(path, dtype=np.int32,
                       count=-1 if count < 0 else count * row)
    return np.ascontiguousarray(data.reshape(-1, row)[:, 1:])


def read_bvecs(path: str, count: int = -1) -> np.ndarray:
    """TEXMEX .bvecs: each row is [int32 d][d uint8]; returned as f32."""
    with open(path, "rb") as f:
        d = struct.unpack("<i", f.read(4))[0]
    row = 4 + d
    raw = np.fromfile(path, dtype=np.uint8,
                      count=-1 if count < 0 else count * row)
    return raw.reshape(-1, row)[:, 4:].astype(np.float32)


def read_fbin(path: str, count: int = -1) -> np.ndarray:
    """big-ann-benchmarks .fbin: [int32 n][int32 d][n*d float32]."""
    with open(path, "rb") as f:
        n, d = struct.unpack("<ii", f.read(8))
        if count >= 0:
            n = min(n, count)
        data = np.fromfile(f, dtype=np.float32, count=n * d)
    return data.reshape(n, d)


def read_ann_benchmarks_hdf5(path: str):
    """ann-benchmarks HDF5 (e.g. glove-100-angular): returns (train, test,
    neighbors, distance_name). h5py is imported here, only when an HDF5
    file is read."""
    import h5py

    with h5py.File(path, "r") as f:
        return (np.asarray(f["train"], np.float32),
                np.asarray(f["test"], np.float32),
                np.asarray(f["neighbors"], np.int64),
                f.attrs.get("distance", "euclidean"))


@dataclass
class Workload:
    name: str
    base: np.ndarray           # [n, d] float32 database vectors
    queries: np.ndarray        # [q, d] float32
    metric: str                # "l2" | "ip"
    ground_truth: np.ndarray | None = None  # [q, k] int (exact NN ids), optional
    meta: dict = field(default_factory=dict)


def synthetic_workload(
    n: int,
    d: int,
    n_queries: int = 1000,
    metric: str = "l2",
    n_clusters: int | None = None,
    seed: int = 1234,
    name: str | None = None,
) -> Workload:
    """Seeded Gaussian-mixture database + queries drawn near the same clusters.

    Queries are perturbed database-distribution samples, so nearest neighbors
    are non-trivial (not the cluster centroid) — matching how SIFT queries
    relate to the SIFT base set.
    """
    rng = np.random.default_rng(seed)
    if n_clusters is None:
        n_clusters = max(16, int(np.sqrt(n) // 4))
    centers = rng.normal(0.0, 1.0, size=(n_clusters, d)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    base = centers[assign] + rng.normal(0.0, 0.35, size=(n, d)).astype(np.float32)
    qassign = rng.integers(0, n_clusters, size=n_queries)
    queries = centers[qassign] + rng.normal(0.0, 0.35, size=(n_queries, d)).astype(
        np.float32
    )
    if metric == "ip":
        # normalize -> inner product == cosine, the ann-benchmarks "angular"
        base /= np.linalg.norm(base, axis=1, keepdims=True) + 1e-30
        queries /= np.linalg.norm(queries, axis=1, keepdims=True) + 1e-30
    return Workload(
        name=name or f"synthetic-{n}x{d}-{metric}",
        base=base.astype(np.float32),
        queries=queries.astype(np.float32),
        metric=metric,
        meta={"n_clusters": n_clusters, "seed": seed},
    )


# Named eval configs (BASELINE.json): file candidates under $HNSW_TPU_DATA
# (or ./data), else an equal-shape synthetic workload.
_EVAL_CONFIGS = {
    "sift10k": dict(n=10_000, d=128, metric="l2",
                    base="siftsmall/siftsmall_base.fvecs",
                    query="siftsmall/siftsmall_query.fvecs",
                    gt="siftsmall/siftsmall_groundtruth.ivecs"),
    "sift1m": dict(n=1_000_000, d=128, metric="l2",
                   base="sift/sift_base.fvecs",
                   query="sift/sift_query.fvecs",
                   gt="sift/sift_groundtruth.ivecs"),
    "gist1m": dict(n=1_000_000, d=960, metric="l2",
                   base="gist/gist_base.fvecs",
                   query="gist/gist_query.fvecs",
                   gt="gist/gist_groundtruth.ivecs"),
    "glove100": dict(n=1_183_514, d=100, metric="ip",
                     hdf5="glove-100-angular.hdf5"),
    "deep10m": dict(n=10_000_000, d=96, metric="l2",
                    base="deep/base.10M.fbin",
                    query="deep/query.public.10K.fbin"),
}


def _validate_shape(config: str, what: str, arr: np.ndarray,
                    n: int | None, d: int | None):
    """Refuse truncated or mismatched real files: the rows x dim of every
    eval dataset are published constants."""
    if n is not None and arr.shape[0] != n:
        raise ValueError(
            f"{config} {what}: expected {n} rows, file has {arr.shape[0]} "
            f"(truncated or wrong download — see data/README.md)")
    if d is not None and arr.shape[1] != d:
        raise ValueError(
            f"{config} {what}: expected dim {d}, file has {arr.shape[1]}")


def load_eval_workload(config: str, data_dir: str | None = None,
                       n_queries: int = 1000) -> Workload:
    """A named BASELINE.json eval config from disk if its files are there
    (shape-checked against the published sizes), else the synthetic
    workload of the same shape."""
    cfg = _EVAL_CONFIGS[config]
    root = data_dir or os.environ.get("HNSW_TPU_DATA", "data")
    if "hdf5" in cfg:
        p = os.path.join(root, cfg["hdf5"])
        if os.path.exists(p):
            train, test, nbrs, _dist = read_ann_benchmarks_hdf5(p)
            _validate_shape(config, "train", train, cfg["n"], cfg["d"])
            _validate_shape(config, "test", test, None, cfg["d"])
            return Workload(config, train, test, cfg["metric"],
                            ground_truth=nbrs.astype(np.int64))
    else:
        bp = os.path.join(root, cfg["base"])
        if os.path.exists(bp):
            rd = read_fbin if bp.endswith(".fbin") else read_fvecs
            base = rd(bp)
            queries = rd(os.path.join(root, cfg["query"]))
            _validate_shape(config, "base", base, cfg["n"], cfg["d"])
            _validate_shape(config, "query", queries, None, cfg["d"])
            gt = None
            gp = os.path.join(root, cfg["gt"]) if cfg.get("gt") else None
            if gp and os.path.exists(gp):
                gt = read_ivecs(gp).astype(np.int64)
                _validate_shape(config, "ground_truth", gt, len(queries),
                                None)
            return Workload(config, base, queries, cfg["metric"],
                            ground_truth=gt)
    return synthetic_workload(cfg["n"], cfg["d"], n_queries=n_queries,
                              metric=cfg["metric"],
                              name=f"{config}-synthetic")
