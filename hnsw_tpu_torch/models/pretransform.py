"""``PreTransformIndex`` — faiss ``IndexPreTransform``, ported from
``hnsw_tpu.models.pretransform``.

Chains one or more ``VectorTransform``s (``ops/transforms.py``) in front of
any index: ``train`` trains each untrained transform on the progressively
transformed data, then the wrapped index; ``add`` / ``search`` push vectors
through the chain first (one f32 product a transform, on the transforms'
device). ``save`` / ``load`` write and read the reference's
``path + ".vt.npz"`` key for key, beside the wrapped index's own file.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.transforms import VectorTransform


def as_input(x):
    """Queries or vectors as the wrappers take them: a tensor as it is,
    anything else as f32 numpy."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


class PreTransformIndex:
    """faiss ``IndexPreTransform``: ``PreTransformIndex(transform, index)``
    or ``PreTransformIndex([t1, t2], index)`` (applied in order)."""

    def __init__(self, transforms, index):
        if isinstance(transforms, VectorTransform):
            transforms = [transforms]
        self.transforms: list[VectorTransform] = list(transforms)
        self.index = index
        if not self.transforms:
            raise ValueError("PreTransformIndex needs >= 1 transform")
        d = self.transforms[0].d_in
        for t in self.transforms:
            if t.d_in != d:
                raise ValueError(f"transform chain dim mismatch: expected "
                                 f"d_in={d}, got {t.d_in}")
            d = t.d_out
        if d != index.d:
            raise ValueError(f"chain output dim {d} != index dim {index.d}")

    # -- forwarding ------------------------------------------------------
    @property
    def d(self) -> int:
        return self.transforms[0].d_in

    @property
    def ntotal(self) -> int:
        return self.index.ntotal

    @property
    def is_trained(self) -> bool:
        return (all(t.is_trained for t in self.transforms)
                and getattr(self.index, "is_trained", True))

    @property
    def ef_search(self):
        return getattr(self.index, "ef_search", None)

    @ef_search.setter
    def ef_search(self, v):
        self.index.ef_search = v

    def __getattr__(self, name):
        # the rest of the wrapped index's surface; the two own attributes
        # are guarded so a half-built instance cannot recurse
        if name in ("index", "transforms"):
            raise AttributeError(name)
        return getattr(self.index, name)

    # -- chain -----------------------------------------------------------
    def apply_chain(self, x):
        """numpy in, numpy out; a tensor in, a tensor out."""
        for t in self.transforms:
            x = t.apply(x)
        return x

    def reverse_chain(self, y):
        for t in reversed(self.transforms):
            y = t.reverse_transform(y)
        return y

    def train(self, x: np.ndarray) -> None:
        """Train each untrained transform on the progressively transformed
        data, then the wrapped index (faiss IndexPreTransform::train)."""
        x = np.asarray(x, np.float32)
        for t in self.transforms:
            if not t.is_trained:
                t.train(x)
            x = t.apply(x)
        if hasattr(self.index, "train"):
            self.index.train(x)

    def add(self, x: np.ndarray) -> None:
        self.index.add(self.apply_chain(np.asarray(x, np.float32)))

    def search(self, x, k: int, **kw):
        return self.index.search(self.apply_chain(as_input(x)), k, **kw)

    def range_search(self, x, radius: float, **kw):
        """As in faiss, the radius lives in the TRANSFORMED space (exact
        under orthonormal chains for L2; rescaled under whitening)."""
        return self.index.range_search(self.apply_chain(as_input(x)),
                                       radius, **kw)

    def reconstruct(self, key: int) -> np.ndarray:
        return self.reverse_chain(
            np.asarray(self.index.reconstruct(key))[None])[0]

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        self.index.save(path)
        blobs: dict[str, np.ndarray] = {"n": np.int64(len(self.transforms))}
        for i, t in enumerate(self.transforms):
            for k, v in t.state().items():
                blobs[f"t{i}.{k}"] = v
        np.savez(path + ".vt.npz", **blobs)

    @classmethod
    def load(cls, path: str, index_cls=None, device=None):
        """The wrapped index (``index_cls.load``, ``HnswIndex`` by default)
        and the transforms, all on ``device`` (the card by default)."""
        if index_cls is None:
            from .hnsw import HnswIndex
            index_cls = HnswIndex
        with np.load(path + ".vt.npz") as z:
            n = int(z["n"])
            ts = []
            for i in range(n):
                pre = f"t{i}."
                st = {k[len(pre):]: z[k] for k in z.files
                      if k.startswith(pre)}
                ts.append(VectorTransform.from_state(st, device=device))
        return cls(ts, index_cls.load(path, device=device))
