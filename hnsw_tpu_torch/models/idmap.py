"""``IdMapIndex`` — faiss ``IndexIDMap``, ported from
``hnsw_tpu.models.idmap``.

faiss's HNSW indexes assign sequential ids and reject ``add_with_ids``;
users who want their own int64 ids wrap the index in ``IndexIDMap``. Same
here: the wrapper keeps a host id table (results are remapped through it,
a [n, k] numpy gather after the search) and forwards the rest to the
wrapped index. ``save`` / ``load`` write and read the reference's
``path + ".ids.npy"`` beside the wrapped index's file.
"""

from __future__ import annotations

import numpy as np


class IdMapIndex:
    """Wrap any index (HnswIndex, FlatIndex, a PreTransformIndex) to take
    user-chosen int64 ids through ``add_with_ids`` (faiss ``IndexIDMap``:
    ids need not be unique or dense; results carry the user id)."""

    def __init__(self, index):
        self.index = index
        self._ids = np.zeros(0, np.int64)

    # -- forwarding ----------------------------------------------------------
    @property
    def ntotal(self) -> int:
        return self.index.ntotal

    @property
    def d(self) -> int:
        return self.index.d

    @property
    def device(self):
        return self.index.device

    @property
    def is_trained(self) -> bool:
        return getattr(self.index, "is_trained", True)

    def train(self, x: np.ndarray) -> None:
        if hasattr(self.index, "train"):
            self.index.train(x)

    # -- id-mapped surface ---------------------------------------------------
    def add(self, x: np.ndarray) -> None:
        raise RuntimeError("IdMapIndex requires add_with_ids (faiss "
                           "IndexIDMap parity); use the wrapped index "
                           "directly for sequential ids")

    def add_with_ids(self, x: np.ndarray, ids: np.ndarray) -> None:
        ids = np.asarray(ids, np.int64).reshape(-1)
        if len(ids) != len(x):
            raise ValueError(f"{len(x)} vectors but {len(ids)} ids")
        self.index.add(x)
        self._ids = np.concatenate([self._ids, ids])

    def search(self, x, k: int, **kw):
        """(D, I) as numpy, I holding user ids (-1 where the wrapped index
        returned a hole)."""
        d, i = self.index.search(x, k, **kw)
        i = np.asarray(i, np.int64)
        mapped = np.where(i >= 0, self._ids[np.maximum(i, 0)]
                          if len(self._ids) else -1, -1)
        return np.asarray(d), mapped

    def remove_ids(self, user_ids: np.ndarray) -> int:
        """Tombstone every row whose USER id is listed (user ids may repeat,
        so one user id can remove several rows)."""
        user_ids = np.asarray(user_ids, np.int64).reshape(-1)
        rows = np.flatnonzero(np.isin(self._ids, user_ids))
        if not len(rows):
            return 0
        return self.index.remove_ids(rows)

    def reconstruct(self, user_id: int) -> np.ndarray:
        rows = np.flatnonzero(self._ids == user_id)
        if not len(rows):
            raise KeyError(f"id {user_id} not in index")
        return self.index.reconstruct(int(rows[0]))

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        self.index.save(path)
        np.save(path + ".ids.npy", self._ids)

    @classmethod
    def load(cls, path: str, index_cls=None, device=None):
        """The wrapped index (``index_cls.load``, ``HnswIndex`` by default)
        on ``device`` (the card by default), and the id table."""
        if index_cls is None:
            from .hnsw import HnswIndex
            index_cls = HnswIndex
        wrapped = cls(index_cls.load(path, device=device))
        wrapped._ids = np.load(path + ".ids.npy")
        return wrapped
