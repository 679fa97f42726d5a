"""``FlatIndex`` — exact search (faiss ``IndexFlat``), ported from
``hnsw_tpu.models.brute``: the standalone exact index and the recall oracle
of the HNSW index, with the same add / search surface as ``HnswIndex``.
The vectors live on ``device`` (the card unless the caller passes
``device="cpu"``) in ``dtype`` ("float32" or "bfloat16")."""

from __future__ import annotations

import numpy as np
import torch

from ..config import L2
from ..ops._cuda import default_device
from ..ops.distances import brute_force_topk


class FlatIndex:
    def __init__(self, dim: int, metric: str = L2, dtype: str = "float32",
                 *, device=None):
        self.dim = dim
        self.metric = metric
        self.dtype = dtype
        self.is_trained = True
        self.device = torch.device(device) if device is not None \
            else default_device()
        self._torch_dtype = getattr(torch, dtype)
        self._chunks: list[np.ndarray] = []
        self._vectors: torch.Tensor | None = None

    @property
    def ntotal(self) -> int:
        if self._vectors is not None:
            return self._vectors.shape[0]
        return sum(len(c) for c in self._chunks)

    def add(self, x: np.ndarray) -> None:
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}], got {x.shape}")
        self._chunks.append(x)
        self._vectors = None

    def _materialize(self) -> torch.Tensor:
        if self._vectors is None:
            host = np.concatenate(self._chunks, axis=0) if self._chunks else \
                np.zeros((0, self.dim), np.float32)
            self._vectors = torch.from_numpy(host).to(self.device,
                                                      self._torch_dtype)
        return self._vectors

    def search(self, x: np.ndarray, k: int, tile_n: int = 65536):
        """(D [n, k] f32, I [n, k] int64) as numpy, ascending; true squared
        L2 for l2, the negated dot for ip."""
        base = self._materialize()
        if base.shape[0] == 0:
            n = len(x)
            return (np.full((n, k), np.inf, np.float32),
                    np.full((n, k), -1, np.int64))
        q = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        d, i = brute_force_topk(q.to(self.device), base, k, self.metric,
                                tile_n=tile_n)
        return d.cpu().numpy(), i.cpu().numpy()

    def reconstruct(self, i: int) -> np.ndarray:
        return self._materialize()[i].float().cpu().numpy()

    def range_search(self, x: np.ndarray, radius: float):
        """Exact range search, faiss ``IndexFlat.range_search`` semantics:
        L2 keeps squared distance < radius; IP keeps dot > radius. Returns
        (lims [nq+1], D, I) in faiss's CSR layout, each query's results
        best-first. Runs on the host in numpy, as the reference's does."""
        x = np.asarray(x, np.float32)
        base = self._materialize().float().cpu().numpy()
        if self.metric == L2:
            score = ((x ** 2).sum(1)[:, None] + (base ** 2).sum(1)[None]
                     - 2.0 * x @ base.T)
            keep = score < radius
            order_sign = 1.0
        else:
            score = x @ base.T
            keep = score > radius
            order_sign = -1.0
        lims = np.zeros(len(x) + 1, np.int64)
        ds, is_ = [], []
        for qi in range(len(x)):
            rows = np.flatnonzero(keep[qi])
            rows = rows[np.argsort(order_sign * score[qi, rows],
                                   kind="stable")]
            lims[qi + 1] = lims[qi] + len(rows)
            ds.append(score[qi, rows])
            is_.append(rows)
        return (lims, np.concatenate(ds) if ds else np.zeros(0, np.float32),
                np.concatenate(is_).astype(np.int64) if is_
                else np.zeros(0, np.int64))
