"""``HnswIndex`` — the faiss ``IndexHNSWFlat``-style API of ``hnsw_tpu``,
ported to PyTorch: ``HnswIndex(d, m, metric, capacity=…)`` → ``add(x)`` →
``enable_packed(bits=8)`` → ``search(q, k, ef_search=…)``.

Vectors and graph live as tensors on one device (``device``; the default
is the first CUDA device, and with no card the constructor and ``load``
raise: pass ``device="cpu"`` to run on the CPU). ``add`` runs the batched
device build; ``search`` the batched query pipeline, with filters
(``allowed``), ``beam_keys`` and the ``n_expand`` attribute.

Not ported yet (they raise NotImplementedError): ``build="host"``; sq8 /
bf16 / pq storage; PQ packed rows; ``add`` while packed tables are enabled
(incremental row maintenance); deletion (tombstones), ``save`` and the rest
of the API breadth (ROADMAP.md Queue A).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import L2, HnswConfig
from ..graph import (GraphArrays, check_invariants, empty_graph,
                     graph_from_numpy, load_graph)
from ..search import hnsw_search


def _default_device() -> torch.device:
    """The first CUDA device. Never a silent fall back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("HnswIndex: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda")


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
        if config.dtype != "float32":
            raise NotImplementedError(
                f"{config.dtype} storage is not ported yet: ROADMAP.md A8")
        self.config = config
        self.device = torch.device(device) if device is not None \
            else _default_device()
        self.ef_search = config.ef_search
        self.ef_construction = config.ef_construction
        self.n_expand = 1
        self.beam_keys = "auto"  # default merge-key dtype (see search())
        self.entry_mode = "auto"
        self.r_window = 16  # back-link repair window; set before first add()
        self._graph: GraphArrays | None = None
        self._vectors: torch.Tensor | None = None
        if _alloc:
            self._graph = empty_graph(config, self.device)
            self._vectors = torch.zeros((config.capacity, config.dim),
                                        dtype=torch.float32,
                                        device=self.device)
        self._builder = None
        self._packed = None

    @property
    def ntotal(self) -> int:
        return self._graph.ntotal

    @property
    def graph(self) -> GraphArrays:
        return self._graph

    @property
    def vectors(self) -> torch.Tensor:
        return self._vectors

    # -- construction -------------------------------------------------------
    def add(self, x: np.ndarray) -> None:
        """Append vectors; ids are assigned sequentially (faiss parity)."""
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        if x.ndim != 2 or x.shape[1] != self.config.dim:
            raise ValueError(f"expected [n, {self.config.dim}], got {x.shape}")
        if self.ntotal + len(x) > self.config.capacity:
            raise ValueError("capacity exceeded; create the index with a "
                             "larger `capacity`")
        if self._packed is not None:
            raise NotImplementedError(
                "add() with packed tables enabled: incremental packed-row "
                "maintenance is not ported yet (ROADMAP.md A4); call "
                "disable_packed() first")
        from ..build import DeviceBuilder
        if self._builder is None:
            self._builder = DeviceBuilder(self.config, r_window=self.r_window)
        self._builder.add(self._graph, self._vectors, x,
                          ef_construction=self.ef_construction)

    # -- packed serving mode (ops/packed.py) -------------------------------
    def enable_packed(self, bits: int = 8, *, mode: str | None = None,
                      layout: str = "auto", max_bytes: int | None = None,
                      reserve: int = 0) -> int:
        """Build the packed neighbor-code tables ("sq" rows: d scalar-
        quantized dims per neighbor, 8 or 4 bits). The level-0 beam then
        routes on distances from ONE code row per expanded node; the final
        buffer is re-ranked exactly. ``layout``: "bytes" (uint8 rows, K2),
        "words" (int32 rows holding the same bits, K4) or "auto", which
        resolves to "bytes" (the reference picks "words" only on a TPU).
        Returns the tables' size in bytes."""
        if mode not in (None, "sq"):
            raise NotImplementedError(
                f"packed mode {mode!r} (PQ-coded rows) is not ported yet: "
                f"ROADMAP.md A8")
        if layout not in ("auto", "bytes", "words"):
            raise ValueError(f"layout must be 'auto', 'bytes' or 'words', "
                             f"got {layout!r}")
        from ..ops.packed import pack_neighbors
        n_rows = min(self.config.capacity,
                     max(self.ntotal, 1) + max(reserve, 0))
        self._packed = pack_neighbors(
            self._graph.neighbors0, self._vectors, self._graph.levels,
            bits=bits, max_bytes=max_bytes, n_rows=n_rows,
            layout="bytes" if layout == "auto" else layout)
        return self._packed.nbytes

    def disable_packed(self) -> None:
        self._packed = None

    # -- query ----------------------------------------------------------------
    def search(self, x, k: int, *, ef_search: int | None = None,
               with_stats: bool = False, allowed=None, max_hops: int = 0,
               use_packed: bool | None = None, beam_keys: str | None = None,
               entry_mode: str | None = None, device_out: bool = False):
        """Batched k-NN. Returns (D [n, k] float32, I [n, k] int64) numpy
        arrays like faiss (I == -1 where fewer than k are reachable), or the
        device tensors (D f32, I int32) with ``device_out``. ``x`` is a
        numpy array or a tensor.

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
            packed=packed, beam_keys=beam_keys or self.beam_keys,
            entry_mode=entry_mode or self.entry_mode)
        if device_out:
            return out
        d, i = out[0].cpu().numpy(), out[1].cpu().numpy().astype(np.int64)
        return (d, i, out[2]) if with_stats else (d, i)

    def _normalize_allowed(self, allowed) -> torch.Tensor:
        """A user id filter as a bool [capacity] mask on the index's device,
        by dtype and shape: a bool mask (1-d, at most capacity long; the
        tail is False) or an int id list, as numpy or as a tensor. A numpy
        id out of range raises (numpy indexing); tensor ids outside
        [0, capacity) are dropped, as the reference drops them on device."""
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

    # -- maintenance ----------------------------------------------------------
    def check(self, strict: bool = True) -> dict:
        """Structural invariant check on the host (``check_invariants``)."""
        return check_invariants(self._graph, self.config, strict=strict)

    @classmethod
    def load(cls, path, device=None) -> "HnswIndex":
        """Load a ``.npz`` written by ``hnsw_tpu`` ``HnswIndex.save``. A
        saved level-RNG state carries over, so further adds draw the levels
        the reference would."""
        arrays, vectors, cfg, extra, xarr = load_graph(path)
        if xarr:
            raise NotImplementedError(
                f"index file carries {sorted(xarr)} (tombstones or storage "
                f"codecs), which are not ported yet: ROADMAP.md A8/A9")
        idx = cls(config=cfg, device=device, _alloc=False)
        idx._graph = graph_from_numpy(arrays, idx.device)
        idx._vectors = torch.from_numpy(
            np.ascontiguousarray(vectors, np.float32)).to(idx.device)
        if "builder_rng_state" in extra:
            from ..build import DeviceBuilder
            idx._builder = DeviceBuilder(cfg, r_window=idx.r_window)
            idx._builder.rng.bit_generator.state = extra["builder_rng_state"]
        return idx
