"""``RefineFlatIndex`` — faiss ``IndexRefineFlat``, ported from
``hnsw_tpu.models.refine``.

The standard faiss companion to quantized indexes: the wrapped index (HNSW
over sq8 or PQ codes, say) proposes ``k * k_factor`` candidates a query
from its compressed vectors; an f32 flat store reranks them with exact
distances and the top k survive.

The rerank is K3 (``ops/dist_kernel.gathered_vec_dist_ids``), which gathers
the candidates' rows by id inside the kernel on the card (the plain version
on the CPU), so no [Q, kk, d] copy of the rows is made; then
``torch.topk``. The store lives on the wrapped index's device, made from
the added vectors once after each ``add``. ``save`` / ``load`` write and
read the reference's ``path + ".rflat.npz"`` beside the wrapped index's
file.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import IP, L2
from ..ops.dist_kernel import gathered_vec_dist_ids
from .pretransform import as_input


def rerank(store: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor,
           *, k: int, metric: str):
    """Exact rerank: store [N, d] f32, queries [Q, d] f32, ids int32 [Q, kk]
    (-1 = hole) -> (dists [Q, k], ids [Q, k] int32) in the reference's
    conventions (L2: squared distance ascending; IP: dot descending), holes
    last as (inf or -inf, -1). K3 returns ``Σv² − 2Σq·v`` (L2), to which
    ``‖q‖²`` is added, or ``−Σq·v`` (IP), negated back to the dot."""
    part = gathered_vec_dist_ids(store, ids.clamp(min=0), queries,
                                 metric=metric)
    hole = ids < 0
    if metric == IP:
        score = torch.where(hole, -torch.inf, -part)
        top, pos = torch.topk(score, k, dim=1)
    else:
        qsq = (queries * queries).sum(1, keepdim=True)
        dist = torch.where(hole, torch.inf, qsq + part)
        top, pos = torch.topk(dist, k, dim=1, largest=False)
    return top, torch.where(torch.isfinite(top), ids.gather(1, pos), -1)


class RefineFlatIndex:
    """faiss ``IndexRefineFlat``: exact rerank over any index.

    ``k_factor`` (mutable, as in faiss) sets how many candidates the
    wrapped index proposes per returned result. ``device``: where the f32
    store lives, by default the wrapped index's."""

    def __init__(self, index, k_factor: float = 4.0, *, device=None):
        self.index = index
        self.k_factor = float(k_factor)
        self.device = torch.device(device) if device is not None \
            else index.device
        self._chunks: list[np.ndarray] = []
        self._store = None

    # -- forwarding --------------------------------------------------------
    @property
    def d(self) -> int:
        return self.index.d

    @property
    def ntotal(self) -> int:
        return self.index.ntotal

    @property
    def is_trained(self) -> bool:
        return getattr(self.index, "is_trained", True)

    @property
    def metric(self) -> str:
        return getattr(self.index, "metric", None) or \
            getattr(self.index.config, "metric", L2)

    def __getattr__(self, name):
        if name in ("index",):
            raise AttributeError(name)
        return getattr(self.index, name)

    def train(self, x: np.ndarray) -> None:
        if hasattr(self.index, "train"):
            self.index.train(x)

    # -- add / search --------------------------------------------------------
    def add(self, x: np.ndarray) -> None:
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        self.index.add(x)        # validates shape / trained state first
        self._chunks.append(x)
        self._store = None

    def _host_store(self) -> np.ndarray:
        return (np.concatenate(self._chunks, 0) if self._chunks
                else np.zeros((0, self.d), np.float32))

    def _materialize(self) -> torch.Tensor:
        if self._store is None:
            self._store = torch.from_numpy(self._host_store()).to(self.device)
        return self._store

    def _candidates(self, x, q: torch.Tensor, kk: int, **kw) -> torch.Tensor:
        """The wrapped index's [Q, kk] ids as int32 on the store's device.
        The port's HnswIndex takes the queries ``q`` already there and
        hands its ids back there (``device_out``), with no host round
        trip; another index gets ``x`` as given."""
        from .hnsw import HnswIndex
        if isinstance(self.index, HnswIndex):
            ids = self.index.search(q, kk, device_out=True, **kw)[1]
        else:
            ids = self.index.search(x, kk, **kw)[1]
        if not isinstance(ids, torch.Tensor):   # numpy (an empty index's)
            ids = torch.from_numpy(np.asarray(ids))
        return ids.to(self.device, torch.int32)

    def search(self, x, k: int, **kw):
        """(D [n, k] f32, I [n, k] int64) as numpy: exact f32 distances of
        the reranked candidates (L2 ascending, IP dots descending)."""
        x = as_input(x)
        q = torch.as_tensor(x).to(self.device, torch.float32).contiguous()
        kk = max(int(round(k * self.k_factor)), k)
        kk = min(kk, max(self.ntotal, 1))
        ids = self._candidates(x, q, kk, **kw)
        if ids.shape[1] < k:     # tiny index: pad holes so topk(k) is legal
            ids = torch.nn.functional.pad(ids, (0, k - ids.shape[1]),
                                          value=-1)
        store = self._materialize()
        if store.shape[0] == 0:
            n = len(x)
            return (np.full((n, k), np.inf, np.float32),
                    np.full((n, k), -1, np.int64))
        d, i = rerank(store, q, ids.contiguous(), k=k, metric=self.metric)
        return d.cpu().numpy(), i.cpu().numpy().astype(np.int64)

    def reconstruct(self, i: int) -> np.ndarray:
        return np.array(self._materialize()[i].cpu())

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        self.index.save(path)
        np.savez(path + ".rflat.npz", store=self._host_store(),
                 k_factor=np.float64(self.k_factor))

    @classmethod
    def load(cls, path: str, index_cls=None, device=None):
        """The wrapped index (``index_cls.load``, ``HnswIndex`` by default)
        and the store, both on ``device`` (the card by default)."""
        if index_cls is None:
            from .hnsw import HnswIndex
            index_cls = HnswIndex
        with np.load(path + ".rflat.npz") as z:
            store = z["store"]
            kf = float(z["k_factor"])
        out = cls(index_cls.load(path, device=device), k_factor=kf)
        if len(store):
            out._chunks = [store]
        return out
