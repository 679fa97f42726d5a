"""faiss ``index_factory``, ported from ``hnsw_tpu.factory``: the string
spec constructor users reach for first. The grammar, its order and its
errors are the reference's.

Supported specs:
  * ``"HNSW"``        -> HnswIndex with default M=32
  * ``"HNSW32"``      -> HnswIndex(M=32)
  * ``"HNSW16,Flat"`` -> same (flat f32 storage, faiss IndexHNSWFlat)
  * ``"HNSW32,SQ8"``  -> sq8 scalar-quantized storage (faiss IndexHNSWSQ
                          with ScalarQuantizer.QT_8bit): train() required
  * ``"HNSW32,PQ16"`` -> product-quantized storage, 16 sub-quantizers x
                          8 bits (faiss IndexHNSWPQ): train() required
  * ``"HNSW32,PQ32x4"`` -> 4-bit PQ, 32 sub-quantizers x 16 centroids
  * ``"Flat"``        -> FlatIndex (exact search)
  * ``"IDMap,..."``   -> IdMapIndex wrapping any of the above (faiss
                          IndexIDMap: user-chosen int64 ids, add_with_ids)
  * transform prefixes (faiss VectorTransform family, chainable):
      ``"L2norm,HNSW32,Flat"``   cosine over an IP index
      ``"PCA64,HNSW32,Flat"``    PCA to 64 dims (PCAW = whitened,
                                  PCAR = + random rotation)
      ``"RR64,HNSW32,Flat"``     seeded random rotation/projection
      ``"OPQ16,HNSW32,PQ16"``    learned rotation minimizing PQ error
                                  (OPQ16_64 also reduces to 64 dims)
  * trailing ``"...,RFlat"``  -> RefineFlatIndex (faiss IndexRefineFlat):
                                  exact-f32 rerank of k*k_factor candidates
Metric: "l2" (faiss METRIC_L2) or "ip" (METRIC_INNER_PRODUCT).

``device`` (a keyword, the card by default) is given to every part: the
transforms, the refine store, ``FlatIndex`` and ``HnswIndex``. The other
keywords go to ``HnswIndex``.
"""

from __future__ import annotations

import re

from .config import L2
from .models.brute import FlatIndex
from .models.hnsw import HnswIndex

_TRANSFORM_RE = re.compile(
    r"L2norm|RR(\d+)|PCA([WR]?)(\d+)|OPQ(\d+)(?:_(\d+))?")


def _parse_transform(tok: str, d: int, seed: int, device):
    """Transform token -> (VectorTransform, d_out) or None."""
    from .ops import transforms as T
    m = _TRANSFORM_RE.fullmatch(tok)
    if m is None:
        return None
    if tok == "L2norm":
        return T.NormalizationTransform(d, device=device), d
    if m.group(1):                                   # RR{d}
        d_out = int(m.group(1))
        return T.RandomRotation(d, d_out, seed=seed, device=device), d_out
    if m.group(3):                                   # PCA / PCAW / PCAR
        d_out = int(m.group(3))
        flavor = m.group(2)
        return T.PCAMatrix(
            d, d_out, eigen_power=(-0.5 if flavor == "W" else 0.0),
            random_rotation=(flavor == "R"), seed=seed,
            device=device), d_out
    m_sub = int(m.group(4))                          # OPQ{m}[_{d}]
    d_out = int(m.group(5)) if m.group(5) else d
    return T.OPQMatrix(d, m_sub, d_out, seed=seed, device=device), d_out


def index_factory(d: int, spec: str, metric: str = L2, **kw):
    device = kw.pop("device", None)
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if not parts:
        raise ValueError(f"empty index spec {spec!r}")
    # leading VectorTransform tokens (faiss: "OPQ16,HNSW32,PQ16", ...)
    transforms = []
    seed = kw.get("seed", 42)
    dim = d
    while parts:
        parsed = _parse_transform(parts[0], dim, seed, device)
        if parsed is None:
            break
        t, dim = parsed
        transforms.append(t)
        parts = parts[1:]
    if transforms:
        from .models.pretransform import PreTransformIndex
        if not parts:
            raise ValueError(f"spec {spec!r} has transforms but no index")
        return PreTransformIndex(
            transforms, index_factory(dim, ",".join(parts), metric,
                                      device=device, **kw))
    # trailing "RFlat" (faiss IndexRefineFlat): exact-f32 rerank wrapper
    if parts[-1] == "RFlat":
        from .models.refine import RefineFlatIndex
        if len(parts) == 1:
            raise ValueError(f"RFlat needs a wrapped spec, got {spec!r}")
        k_factor = kw.pop("k_factor", 4.0)
        return RefineFlatIndex(
            index_factory(dim, ",".join(parts[:-1]), metric, device=device,
                          **kw),
            k_factor=k_factor, device=device)
    if parts[0] == "IDMap":
        from .models.idmap import IdMapIndex
        if len(parts) == 1:
            raise ValueError(f"IDMap needs a wrapped spec, got {spec!r}")
        return IdMapIndex(index_factory(d, ",".join(parts[1:]), metric,
                                        device=device, **kw))
    head = parts[0]
    if head == "Flat":
        if len(parts) > 1:
            raise ValueError(f"unsupported spec {spec!r}")
        return FlatIndex(d, metric=metric, device=device)
    m = re.fullmatch(r"HNSW(\d+)?", head)
    if m:
        pq = re.fullmatch(r"PQ(\d+)(x4)?", parts[1]) \
            if len(parts) == 2 else None
        if len(parts) > 2 or (len(parts) == 2 and pq is None and
                              parts[1] not in ("Flat", "SQ8")):
            raise ValueError(
                f"unsupported spec {spec!r}: storage codecs are Flat "
                "(IndexHNSWFlat), SQ8 (IndexHNSWSQ/QT_8bit), PQ<m> "
                "(IndexHNSWPQ, 8 bits/sub-code) and PQ<m>x4 (4-bit)")
        M = int(m.group(1)) if m.group(1) else 32
        if len(parts) == 2 and parts[1] == "SQ8":
            kw.setdefault("dtype", "sq8")
        elif pq is not None:
            kw.setdefault("dtype", "pq")
            kw.setdefault("pq_m", int(pq.group(1)))
            if pq.group(2):
                kw.setdefault("pq_bits", 4)
        return HnswIndex(d, M, metric, device=device, **kw)
    raise ValueError(f"unsupported index spec {spec!r}")
