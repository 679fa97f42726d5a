"""``HnswIndex`` — the faiss ``IndexHNSWFlat``-style API of ``hnsw_tpu``,
ported to PyTorch: ``HnswIndex(d, m, metric, capacity=…)`` → ``add(x)`` →
``enable_packed(bits=8)`` → ``search(q, k, ef_search=…)``.

Vectors and graph live as tensors on one device (``device``; the default
is the first CUDA device, and with no card the constructor and ``load``
raise: pass ``device="cpu"`` to run on the CPU). ``add`` runs the batched
device build; ``search`` the batched query pipeline, with filters
(``allowed``), ``beam_keys`` and the ``n_expand`` attribute.

Storage codecs (``dtype``): "float32", "bfloat16", "sq8" (faiss
``IndexHNSWSQ``: uint8 codes and a per-dim affine trained by ``train``) and
"pq" (faiss ``IndexHNSWPQ``: ``pq_m`` codes a vector and codebooks trained
by ``train``). Every build and search distance is exact over the stored
x̂. Packed routing rows come as sq rows (``enable_packed(bits=)``) or as
PQ-coded rows (``enable_packed(mode="pq")``). ``save`` / ``load`` /
``to_bytes`` / ``from_bytes`` read and write the reference's ``.npz``.

Not ported yet (they raise NotImplementedError): ``build="host"``; ``add``
while packed tables are enabled (incremental row maintenance); deletion
(tombstones) and the rest of the API breadth (ROADMAP.md Queue A).
"""

from __future__ import annotations

import io

import numpy as np
import torch

from ..config import L2, HnswConfig
from ..graph import (GraphArrays, check_invariants, empty_graph,
                     graph_from_numpy, load_graph, save_graph, vectors_tensor)
from ..ops._cuda import default_device
from ..ops.distances import decode_rows
from ..search import hnsw_search


class HnswIndex:
    def __init__(self, dim: int | None = None, m: int = 32, metric: str = L2,
                 *, config: HnswConfig | None = None,
                 capacity: int | None = None, build: str = "device",
                 device=None, _alloc: bool = True, **kw):
        if config is None:
            if dim is None:
                raise ValueError("dim or config required")
            config = HnswConfig(dim=dim, m=m, metric=metric,
                                capacity=capacity or 1_000_000, **kw)
        if build == "host":
            raise NotImplementedError(
                "build='host' (the NumPy reference builder) is not ported "
                "yet: ROADMAP.md A5")
        if build != "device":
            raise ValueError(f"build must be 'device' or 'host', got {build!r}")
        self.config = config
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.ef_search = config.ef_search
        self.ef_construction = config.ef_construction
        self.n_expand = 1
        self.beam_keys = "auto"  # default merge-key dtype (see search())
        self.entry_mode = "auto"
        self.r_window = 16  # back-link repair window; set before first add()
        # faiss SQ / PQ need train() before add(); flat storage is train-free
        self.is_trained = not (config.is_sq or config.is_pq)
        self._graph: GraphArrays | None = None
        self._vectors: torch.Tensor | None = None
        if _alloc:
            self._graph = empty_graph(config, self.device)
            self._vectors = torch.zeros(
                (config.capacity, config.storage_width),
                dtype=getattr(torch, config.storage_dtype), device=self.device)
        self._builder = None
        self._packed = None
        # storage codecs, None until train(): each as device tensors (the
        # search) and numpy (the builder, and the host-side sq8 encode)
        self._sq = self._sq_np = None   # (offset [d], scale [d])
        self._pq = self._pq_np = None   # codebooks [pq_m, ksub, dsub]
        # (codebooks, codes [capacity, pq_m]) of PQ ROUTING rows over flat
        # or sq8 storage (enable_packed(mode="pq")), kept across re-packs
        self._route = None

    @property
    def ntotal(self) -> int:
        return self._graph.ntotal

    @property
    def d(self) -> int:  # faiss naming
        return self.config.dim

    @property
    def graph(self) -> GraphArrays:
        return self._graph

    @property
    def vectors(self) -> torch.Tensor:
        return self._vectors

    # -- construction -------------------------------------------------------
    def train(self, x: np.ndarray) -> None:
        """faiss parity: a no-op for flat storage; for sq8 the per-dim [min,
        max] range of ``x`` (faiss ``ScalarQuantizer::train``, QT_8bit); for
        pq the per-subspace k-means codebooks (``ops/pq.py`` ``train_pq``,
        on this index's device). Must come before the first ``add()``."""
        if not (self.config.is_sq or self.config.is_pq):
            return
        if self.ntotal:
            raise RuntimeError("train() after add(): stored codes would "
                               "decode under different params; build a new "
                               "index instead")
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self.config.dim:
            raise ValueError(f"expected [n, {self.config.dim}], got {x.shape}")
        if self.config.is_pq:
            from ..ops.pq import train_pq
            self._set_pq(train_pq(x, self.config.pq_m,
                                  ksub=self.config.pq_ksub,
                                  seed=self.config.seed, device=self.device))
        else:
            from ..ops.packed import quantization_params
            xt = torch.from_numpy(x).to(self.device)
            off, sc = quantization_params(
                xt, torch.ones(len(x), dtype=torch.bool, device=self.device),
                8)
            self._set_sq(off.cpu().numpy(), sc.cpu().numpy())

    def _set_sq(self, offset: np.ndarray, scale: np.ndarray) -> None:
        self._sq_np = (np.array(offset, np.float32),
                       np.array(scale, np.float32))
        self._sq = tuple(torch.from_numpy(a).to(self.device)
                         for a in self._sq_np)
        self.is_trained = True

    def _set_pq(self, cb: np.ndarray) -> None:
        self._pq_np = np.array(cb, np.float32)
        self._pq = torch.from_numpy(self._pq_np).to(self.device)
        self.is_trained = True

    def _sq_encode(self, x: np.ndarray) -> np.ndarray:
        """f32 -> x̂, the dequantized value of the stored code, on the host
        in numpy as in the reference (so x̂ is the reference's, bit for
        bit). The builder sees x̂, so every build distance is what a search
        of the finished index measures; the storage write re-encodes x̂ to
        the same code."""
        off, sc = self._sq_np
        u = np.clip(np.round((x - off) / sc), 0, 255).astype(np.float32)
        return off + sc * u

    def _pq_encode_decode(self, x: np.ndarray) -> np.ndarray:
        """f32 -> the PQ reconstruction x̂ (the rationale of
        ``_sq_encode``), encoded and decoded on this index's device."""
        from ..ops.pq import decode_pq, encode_pq
        codes = encode_pq(torch.from_numpy(x).to(self.device), self._pq)
        return decode_pq(codes, self._pq).cpu().numpy()

    def add(self, x: np.ndarray) -> None:
        """Append vectors; ids are assigned sequentially (faiss parity)."""
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        if x.ndim != 2 or x.shape[1] != self.config.dim:
            raise ValueError(f"expected [n, {self.config.dim}], got {x.shape}")
        if not self.is_trained:
            raise RuntimeError("sq8/pq storage: call train(x) before add() "
                               "(faiss IndexHNSWSQ/IndexHNSWPQ parity)")
        if self.ntotal + len(x) > self.config.capacity:
            raise ValueError("capacity exceeded; create the index with a "
                             "larger `capacity`")
        if self._packed is not None:
            raise NotImplementedError(
                "add() with packed tables enabled: incremental packed-row "
                "maintenance is not ported yet (ROADMAP.md A4); call "
                "disable_packed() first")
        if self.config.is_sq:
            x = self._sq_encode(x)
        elif self.config.is_pq:
            x = self._pq_encode_decode(x)
        from ..build import DeviceBuilder
        if self._builder is None:
            self._builder = DeviceBuilder(self.config, r_window=self.r_window,
                                          sq_params=self._sq_np,
                                          pq_cb=self._pq_np)
        self._builder.add(self._graph, self._vectors, x,
                          ef_construction=self.ef_construction)

    # -- packed serving mode (ops/packed.py) -------------------------------
    def enable_packed(self, bits: int = 8, *, mode: str | None = None,
                      layout: str = "auto", pq_m: int | None = None,
                      pq_bits: int = 8, train_x: np.ndarray | None = None,
                      max_bytes: int | None = None, reserve: int = 0) -> int:
        """Build packed neighbor-code tables: the level-0 beam then routes on
        distances from ONE code row per expanded node; the final buffer is
        re-ranked with storage-grade distances (exact f32 / sq8 x̂ / exact
        ADC). Returns the tables' size in bytes.

        ``mode``: "sq" (the default for flat, bf16 and sq8 storage: d
        scalar-quantized dims a neighbor, ``bits`` 8 or 4; sq8 storage at 8
        bits packs its own codes) or "pq" (the default, and the only mode,
        for pq storage: ``pq_m`` PQ codes a neighbor, 8-16x smaller rows;
        pq storage packs its stored codes, other storage trains
        ROUTING-only codebooks once, ``pq_m`` dividing d, ``pq_bits`` 8 or
        4, on ``train_x``, else on up to 65,536 stored vectors).
        ``layout`` (sq rows): "bytes" (uint8 rows, K2), "words" (int32
        rows holding the same bits, K4) or "auto", which resolves to
        "bytes" (the reference picks "words" only on a TPU)."""
        if mode is None:
            mode = "pq" if self.config.is_pq else "sq"
        if mode not in ("sq", "pq"):
            raise ValueError(f"mode must be 'sq' or 'pq', got {mode!r}")
        n_rows = min(self.config.capacity,
                     max(self.ntotal, 1) + max(reserve, 0))
        if mode == "sq":
            if self.config.is_pq:
                raise ValueError(
                    "sq packed rows need scalar storage; pq storage packs "
                    "its own codes — use enable_packed(mode='pq')")
            if layout not in ("auto", "bytes", "words"):
                raise ValueError(f"layout must be 'auto', 'bytes' or "
                                 f"'words', got {layout!r}")
            from ..ops.packed import pack_neighbors
            self._packed = pack_neighbors(
                self._graph.neighbors0, self._vectors, self._graph.levels,
                bits=bits, max_bytes=max_bytes, n_rows=n_rows,
                dequant=self._sq,
                layout="bytes" if layout == "auto" else layout)
        else:
            from ..ops.packed import pack_pq_neighbors
            cb, codes, pq_bits = self._route_codebooks(pq_m, pq_bits, train_x)
            self._packed = pack_pq_neighbors(
                self._graph.neighbors0, codes, cb, pq_bits=pq_bits,
                max_bytes=max_bytes, n_rows=n_rows)
        return self._packed.nbytes

    def _route_codebooks(self, pq_m, pq_bits, train_x):
        """(cb, codes [capacity, pq_m], pq_bits) of PQ-coded packed rows:
        pq storage's own, or ROUTING-only codebooks trained once and kept
        until ``disable_packed(reset_routing=True)``."""
        if self.config.is_pq:
            return self._pq, self._vectors, self.config.pq_bits
        if self._route is not None:
            cb = self._route[0]
            if pq_m not in (None, cb.shape[0]):
                raise ValueError(
                    f"routing codebooks already trained with pq_m="
                    f"{cb.shape[0]}; call disable_packed(reset_routing="
                    f"True) to retrain with pq_m={pq_m}")
            return self._route
        from ..ops.pq import encode_pq, train_pq
        if pq_m is None or pq_m <= 0 or self.config.dim % pq_m:
            raise ValueError(
                f"mode='pq' on {self.config.dtype} storage needs pq_m > 0 "
                f"dividing dim={self.config.dim} (got {pq_m})")
        xs = np.asarray(train_x, np.float32) if train_x is not None \
            else self.reconstruct_n(0, min(self.ntotal, 65536))
        cb = torch.from_numpy(train_pq(xs, pq_m, ksub=1 << pq_bits,
                                       seed=self.config.seed,
                                       device=self.device)).to(self.device)
        codes = encode_pq(self._vectors, cb, dequant=self._sq)
        self._route = (cb, codes, pq_bits)
        return self._route

    def disable_packed(self, *, reset_routing: bool = False) -> None:
        """Drop the packed tables (and with ``reset_routing`` the routing
        codebooks, so the next enable_packed(mode='pq') trains anew)."""
        self._packed = None
        if reset_routing:
            self._route = None

    @property
    def packed_enabled(self) -> bool:
        return self._packed is not None

    # -- query ----------------------------------------------------------------
    def search(self, x, k: int, *, ef_search: int | None = None,
               with_stats: bool = False, allowed=None, max_hops: int = 0,
               use_packed: bool | None = None, beam_keys: str | None = None,
               entry_mode: str | None = None, device_out: bool = False):
        """Batched k-NN. Returns (D [n, k] float32, I [n, k] int64) numpy
        arrays like faiss (I == -1 where fewer than k are reachable), or the
        device tensors (D f32, I int32) with ``device_out``. ``x`` is a
        numpy array or a tensor. Distances are exact over the stored
        vectors (x̂ for sq8 / PQ storage).

        ``allowed``: an id filter (faiss IDSelector), a bool mask over ids
        or an int array of allowed ids, as numpy or as a tensor; traversal
        is unfiltered, only allowed ids are returned.
        ``max_hops``: 0 caps the level-0 loop at ef_search + 8 hops
        (filtered searches run to convergence), > 0 sets the cap, < 0 runs
        to convergence. ``use_packed``: None routes on the packed tables
        when enabled, False bypasses them, True requires them.
        ``beam_keys``: "auto" | "bf16" | "f32", the legacy beam's merge
        keys; None uses ``self.beam_keys``. ``entry_mode``: "auto" |
        "sample" | "seed" | "descend" (see ``hnsw_search``). The
        ``n_expand`` attribute sets the expansions per hop."""
        if use_packed is None:
            packed = self._packed
        elif use_packed:
            if self._packed is None:
                raise ValueError("use_packed=True but enable_packed() was "
                                 "not called")
            packed = self._packed
        else:
            packed = None
        if self.ntotal == 0:
            n = len(x)
            return (np.full((n, k), np.inf, np.float32),
                    np.full((n, k), -1, np.int64))
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        x = x.to(self.device, torch.float32)
        if allowed is not None:
            allowed = self._normalize_allowed(allowed)
        out = hnsw_search(
            self._graph, self._vectors, x, k=k,
            ef_search=int(ef_search or self.ef_search),
            metric=self.config.metric,
            max_level_cap=self.config.max_level_cap, max_hops=max_hops,
            n_expand=self.n_expand, with_stats=with_stats, allowed=allowed,
            packed=packed, dequant=self._sq, pq=self._pq,
            beam_keys=beam_keys or self.beam_keys,
            entry_mode=entry_mode or self.entry_mode)
        if device_out:
            return out
        d, i = out[0].cpu().numpy(), out[1].cpu().numpy().astype(np.int64)
        return (d, i, out[2]) if with_stats else (d, i)

    def _normalize_allowed(self, allowed) -> torch.Tensor:
        """A user id filter as a bool [capacity] mask on the index's device,
        by dtype and shape: a bool mask (1-d, at most capacity long; the
        tail is False) or an int id list, as numpy or as a tensor. Ids
        follow the reference's two paths: a numpy id in [-capacity, -1]
        selects id + capacity and any other id out of range raises (numpy
        indexing); a tensor id in [-capacity, -1] selects id + capacity and
        any other id outside [0, capacity) is dropped (its device path's
        ``.at[ids].set(True, mode="drop")``)."""
        cap = self.config.capacity
        if isinstance(allowed, torch.Tensor):
            a = allowed.to(self.device)
            if a.dtype == torch.bool:
                if a.dim() != 1 or a.shape[0] > cap:
                    raise ValueError(
                        f"allowed bool mask must be 1-d with length <= "
                        f"capacity ({cap}), got shape {tuple(a.shape)}")
                mask = torch.zeros(cap, dtype=torch.bool, device=self.device)
                mask[:a.shape[0]] = a
                return mask
            if a.is_floating_point() or a.is_complex():
                raise TypeError(f"allowed: expected bool mask or int id "
                                f"list, got dtype {a.dtype}")
            ids = a.reshape(-1).long()
            ids = torch.where(ids < 0, ids + cap, ids)
            mask = torch.zeros(cap, dtype=torch.bool, device=self.device)
            mask[ids[(ids >= 0) & (ids < cap)]] = True
            return mask
        a = np.asarray(allowed)
        if a.dtype == np.bool_:
            if a.ndim != 1 or len(a) > cap:
                raise ValueError(
                    f"allowed bool mask must be 1-d with length <= capacity "
                    f"({cap}), got shape {a.shape}")
            mask = np.zeros(cap, np.bool_)
            mask[:len(a)] = a
        elif np.issubdtype(a.dtype, np.integer):
            mask = np.zeros(cap, np.bool_)
            mask[a.reshape(-1)] = True  # raises on out-of-range, on purpose
        else:
            raise TypeError(f"allowed: expected bool mask or int id list, "
                            f"got dtype {a.dtype}")
        return torch.from_numpy(mask).to(self.device)

    # -- reconstruction (faiss reconstruct*) ----------------------------------
    def _decode(self, rows: torch.Tensor) -> np.ndarray:
        """Stored rows -> f32 vectors on the host (x̂ for sq8 / PQ), never a
        view of the storage."""
        return np.array(decode_rows(rows, self._sq, self._pq).cpu())

    def reconstruct(self, i: int) -> np.ndarray:
        if not 0 <= i < self.ntotal:
            raise IndexError(i)
        return self.reconstruct_n(i, 1)[0]

    def reconstruct_n(self, i0: int, n: int) -> np.ndarray:
        return self._decode(self._vectors[i0:i0 + n])

    def reconstruct_batch(self, ids: np.ndarray) -> np.ndarray:
        """Decode arbitrary ids (faiss ``reconstruct_batch``); ids may
        repeat, and -1 decodes to a zero row."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ((ids < -1) | (ids >= self.ntotal)).any():
            raise IndexError("reconstruct_batch: id out of range")
        v = self._decode(self._vectors[torch.from_numpy(
            np.maximum(ids, 0)).to(self.device)])
        v[ids < 0] = 0.0
        return v

    def search_and_reconstruct(self, x: np.ndarray, k: int, **kw):
        """faiss ``search_and_reconstruct``: (D, I, R [n, k, d] f32) with R
        the stored (decoded) vector of each result and NaN rows where I ==
        -1; keyword arguments go to :meth:`search` (with ``with_stats`` the
        stats come last)."""
        out = self.search(x, k, **kw)
        d, i = out[0], out[1]
        r = self.reconstruct_batch(i).reshape(len(i), k, self.config.dim)
        r[np.asarray(i) < 0] = np.nan
        return (d, i, r, *out[2:])

    # -- maintenance ----------------------------------------------------------
    def check(self, strict: bool = True) -> dict:
        """Structural invariant check on the host (``check_invariants``)."""
        return check_invariants(self._graph, self.config, strict=strict)

    # -- persistence (faiss write_index / read_index) -------------------------
    def save(self, path) -> None:
        """Write the reference's ``.npz`` (a file name or a binary file
        object): graph, vectors (codes for sq8 / PQ), config, the level-RNG
        state, and the codec state (``sq_offset`` / ``sq_scale`` /
        ``pq_codebooks``), so either package loads it and a resumed build
        draws the levels an uninterrupted one would."""
        extra = {"routing_clean": True}
        if self._builder is not None:
            extra["builder_rng_state"] = _jsonify(
                self._builder.rng.bit_generator.state)
        xarr = {}
        if self._sq_np is not None:
            xarr["sq_offset"], xarr["sq_scale"] = self._sq_np
        if self._pq_np is not None:
            xarr["pq_codebooks"] = self._pq_np
        save_graph(path, self._graph, self._vectors, self.config, extra,
                   extra_arrays=xarr)

    def to_bytes(self) -> bytes:
        """faiss ``serialize_index``: the whole index as one bytes blob, in
        the format of :meth:`save`."""
        buf = io.BytesIO()
        self.save(buf)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes, device=None) -> "HnswIndex":
        """faiss ``deserialize_index``."""
        return cls.load(io.BytesIO(data), device=device)

    @classmethod
    def load(cls, path, device=None) -> "HnswIndex":
        """Load a ``.npz`` written by either package (a file name or a
        binary file object). A saved level-RNG state carries over, so
        further adds draw the levels the writer's would."""
        arrays, vectors, cfg, extra, xarr = load_graph(path)
        if "alive" in xarr:
            raise NotImplementedError(
                "index file carries tombstones (xarr_alive): deletion is "
                "not ported yet, ROADMAP.md A9")
        idx = cls(config=cfg, device=device, _alloc=False)
        idx._graph = graph_from_numpy(arrays, idx.device)
        idx._vectors = vectors_tensor(vectors, cfg, idx.device)
        if "sq_offset" in xarr:
            idx._set_sq(xarr["sq_offset"], xarr["sq_scale"])
        if "pq_codebooks" in xarr:
            idx._set_pq(xarr["pq_codebooks"])
        if "builder_rng_state" in extra:
            from ..build import DeviceBuilder
            idx._builder = DeviceBuilder(cfg, r_window=idx.r_window,
                                         sq_params=idx._sq_np,
                                         pq_cb=idx._pq_np)
            idx._builder.rng.bit_generator.state = extra["builder_rng_state"]
        return idx


def _jsonify(obj):
    """numpy scalars inside np.random state dicts -> plain python."""
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj
