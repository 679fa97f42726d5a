"""``HnswIndex`` — the faiss ``IndexHNSWFlat``-style API of ``hnsw_tpu``,
ported to PyTorch: ``HnswIndex(d, m, metric, capacity=…)`` → ``add(x)`` →
``enable_packed(bits=8)`` → ``search(q, k, ef_search=…)``.

Vectors and graph live as tensors on one device (``device``; the default
is the first CUDA device, and with no card the constructor and ``load``
raise: pass ``device="cpu"`` to run on the CPU). ``add`` runs the batched
device build (``build="device"``, the default) or the serial numpy
reference builder (``build="host"``, ``reference_impl.NumpyHnsw``: f32 and
bf16 storage), which builds on the host and then copies the graph and
vectors to ``device``; ``search`` runs the batched query pipeline, with
filters (``allowed``), ``beam_keys`` and the ``n_expand`` attribute.

Storage codecs (``dtype``): "float32", "bfloat16", "sq8" (faiss
``IndexHNSWSQ``: uint8 codes and a per-dim affine trained by ``train``) and
"pq" (faiss ``IndexHNSWPQ``: ``pq_m`` codes a vector and codebooks trained
by ``train``). Every build and search distance is exact over the stored
x̂. Packed routing rows come as sq rows (``enable_packed(bits=)``) or as
PQ-coded rows (``enable_packed(mode="pq")``). ``save`` / ``load`` /
``to_bytes`` / ``from_bytes`` read and write the reference's ``.npz``.

The index is mutable while it serves: ``add`` keeps enabled packed tables
valid (the rows it changed are re-packed in place, ``_refresh_packed``);
``remove_ids`` tombstones ids (filtered from results until ``vacuum``
removes them from routing); ``compacted`` renumbers without them;
``grow`` raises the capacity in place; ``merge_from`` absorbs another
index. ``range_search``, the ``tune_ef_search`` / ``tune_operating_point``
tuners and the ``serving.Searcher`` front end sit on ``search``.
"""

from __future__ import annotations

import io
import logging

import numpy as np
import torch

from .. import trace
from ..config import L2, HnswConfig
from ..graph import (GraphArrays, check_invariants, empty_graph,
                     graph_from_numpy, jsonify, load_graph, save_graph)
from ..ops._cuda import default_device
from ..ops.storage import Storage
from ..search import hnsw_search

log = logging.getLogger("hnsw_tpu_torch")


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
        if build not in ("device", "host"):
            raise ValueError(f"build must be 'device' or 'host', got {build!r}")
        if build == "host" and (config.is_sq or config.is_pq):
            raise ValueError("sq8/pq storage requires build='device' "
                             "(the NumPy reference builder is f32-only)")
        self.config = config
        self.build_mode = build
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.ef_search = config.ef_search
        self.ef_construction = config.ef_construction
        self.n_expand = 1
        self.beam_keys = "auto"  # default merge-key dtype (see search())
        self.entry_mode = "auto"
        self.r_window = 16  # back-link repair window; set before first add()
        self._graph: GraphArrays | None = None
        # the stored rows and their codec (set by train() or load)
        self._storage: Storage | None = None
        if _alloc:
            self._graph = empty_graph(config, self.device)
            self._storage = Storage.empty(config, self.device)
        self._builder = None
        self._host = None   # build="host": the NumpyHnsw holding the graph
        self._packed = None
        # enable_packed's arguments, the layout resolved: a full re-pack
        # after add() rebuilds the same table format
        self._packed_opts = None
        # what the last add() did to the packed tables: {"branch":
        # "incremental" | "full" | "failed", "rows": rows re-packed}
        self._last_refresh = None
        # tombstones: bool [capacity] (None: no removals); routing passes
        # through dead ids and results are filtered until vacuum()
        self._alive = None
        # tombstoned ids, kept on the host by every call that changes
        # _alive, so a search reads nothing from the card for it
        self._n_deleted = 0
        self._routing_clean = True
        # rows patched by the last vacuum(): {"level0": n, "upper": n}
        self._last_vacuum = None
        # (codebooks, codes [capacity, pq_m]) of PQ ROUTING rows over flat
        # or sq8 storage (enable_packed(mode="pq")), kept across re-packs
        self._route = None

    @property
    def ntotal(self) -> int:
        """Slots used, tombstoned ids included (ids are stable: removal
        does not renumber, ``compacted`` does)."""
        return self._graph.ntotal

    @property
    def n_deleted(self) -> int:
        """Tombstoned ids (``remove_ids``), a host count."""
        return self._n_deleted

    @property
    def d(self) -> int:  # faiss naming
        return self.config.dim

    @property
    def graph(self) -> GraphArrays:
        return self._graph

    @property
    def vectors(self) -> torch.Tensor:
        return self._storage.rows

    @property
    def is_trained(self) -> bool:
        """faiss parity: sq8 / PQ storage needs its codec (``train``)."""
        return not (self.config.is_sq or self.config.is_pq) or \
            self._storage.coded

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
        self._storage.train(x, self.config)

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
                             "larger `capacity` or grow() it")
        x = self._storage.encode(x)     # x̂ for a codec
        # packed tables: the adjacency rows' fingerprints before the build
        # find the rows to re-pack after it (the tables stay on the device
        # through the build; disable_packed() first to free them). A host
        # build drops the tables, as the reference's does.
        packed_was, fp_old, old_ntotal = self._packed, None, self.ntotal
        if packed_was is not None and self.build_mode == "device":
            from ..ops.packed import row_fingerprints
            fp_old = row_fingerprints(self._graph.neighbors0)
        self._packed = None   # stays None unless the refresh succeeds
        if self.build_mode == "host":
            self._add_host(x)
        else:
            from ..build import DeviceBuilder
            if self._builder is None:
                self._builder = DeviceBuilder(self.config,
                                              r_window=self.r_window)
            self._builder.add(self._graph, self._storage, x,
                              ef_construction=self.ef_construction)
        if self._route is not None and not self.config.is_pq:
            self._encode_route(old_ntotal)
        if fp_old is not None:
            self._refresh_packed(packed_was, fp_old, old_ntotal)

    def _add_host(self, x: np.ndarray) -> None:
        """build="host": serial inserts by ``NumpyHnsw`` on the host, then
        the whole graph and the vectors copied to ``self.device``."""
        from ..reference_impl import NumpyHnsw
        if self._host is None:
            self._host = NumpyHnsw(self.config.replace(
                ef_construction=self.ef_construction))
        self._host.cfg = self._host.cfg.replace(
            ef_construction=self.ef_construction)
        self._host.add(x)
        self._sync_from_host()

    def _sync_from_host(self) -> None:
        """The host builder's graph and vectors (cast to the storage dtype)
        as this index's tensors on ``self.device``. The host graph still
        links tombstoned ids that a ``vacuum()`` had cut from the device
        graph, so results are filtered again until the next vacuum."""
        h = self._host
        self._graph = graph_from_numpy(h.to_graph_arrays(), self.device)
        self._storage = Storage(torch.from_numpy(h.vectors).to(
            self.device, getattr(torch, self.config.storage_dtype),
            copy=True))     # never a view of the builder's array
        if self.n_deleted:
            self._routing_clean = False

    def _encode_route(self, start: int) -> None:
        """PQ routing codes of ids [start, ntotal) on the kept routing
        codebooks, whether or not tables are live, so a later
        ``enable_packed(mode="pq")`` never routes new ids on stale codes.
        A failure is logged and drops the codebooks (the next PQ enable
        trains anew): the add itself is kept."""
        cb, codes, _ = self._route
        try:
            codes[start:self.ntotal] = self._storage.pq_codes(
                cb, start, self.ntotal)
        except Exception:  # noqa: BLE001 — serving must not lose adds
            log.warning("routing-code encode failed; routing codebooks "
                        "dropped", exc_info=True)
            self._route = None

    def _refresh_packed(self, packed, fp_old: torch.Tensor,
                        old_ntotal: int) -> None:
        """Packed-table maintenance after add(): re-pack, in place, exactly
        the rows the build changed (fingerprint diff) and the new ids, 4,096
        at a time; re-pack in full when the new total exceeds the table's
        rows or more than max(n // 4, 50,000) rows changed (a full re-pack
        retrains the quantization). A failure is logged and leaves the
        index unpacked: serving never loses an add."""
        from ..ops.packed import (PackedPQ, row_fingerprints,
                                  update_packed_pq_rows, update_packed_rows)
        is_pq_rows = isinstance(packed, PackedPQ)
        n = self.ntotal
        try:
            ids = None
            rebuild = n > packed.nbr_codes.shape[0]
            if not rebuild:
                fp_new = row_fingerprints(self._graph.neighbors0)
                changed = (fp_old[:n] != fp_new[:n]).any(1)
                changed[old_ntotal:] = True          # new rows always re-pack
                ids = torch.nonzero(changed).flatten().to(torch.int32)
                rebuild = ids.numel() > max(n // 4, 50_000)
            if rebuild:
                packed = None      # free the old table before building anew
                self.enable_packed(**self._packed_opts)
                self._last_refresh = {"branch": "full", "rows": n}
                log.info("packed tables fully re-packed after add()")
                return
            for i in range(0, ids.numel(), 4096):
                part = ids[i:i + 4096]
                if is_pq_rows:
                    update_packed_pq_rows(
                        packed.nbr_codes, self._graph.neighbors0,
                        self._storage.rows if self.config.is_pq
                        else self._route[1], part, pq_bits=packed.pq_bits)
                else:
                    update_packed_rows(
                        packed.nbr_codes, packed.nbr_sq,
                        self._graph.neighbors0, self._storage,
                        packed.offset, packed.scale, part,
                        bits=self._packed_opts["bits"])
            self._packed = packed
            self._last_refresh = {"branch": "incremental",
                                  "rows": int(ids.numel())}
            log.info("packed tables updated after add(): %d rows re-packed",
                     ids.numel())
        except Exception:  # noqa: BLE001 — serving must not lose adds
            log.warning("packed-table refresh failed; packed mode disabled "
                        "(call enable_packed() to restore)", exc_info=True)
            self._packed = None
            self._last_refresh = {"branch": "failed", "rows": 0}

    def grow(self, capacity: int, *, upper_capacity: int = -1) -> None:
        """Raise the preallocated ``capacity`` in place: every
        capacity-sized tensor is padded to the new size one at a time (a
        transient of one tensor's old + new, not a second index). Contents,
        tombstones and the level RNG are kept, so a grown index searches
        bit-identically and builds on as one made at the new capacity.
        Packed tables hold rows for ids < ntotal, which a grow leaves
        untouched: they stay valid."""
        cfg = self.config
        if capacity <= cfg.capacity:
            raise ValueError(f"grow() needs capacity > current "
                             f"({capacity} <= {cfg.capacity})")
        new_cfg = cfg.replace(capacity=capacity,
                              upper_capacity=upper_capacity)
        if new_cfg.upper_capacity < cfg.upper_capacity:
            new_cfg = cfg.replace(capacity=capacity,
                                  upper_capacity=cfg.upper_capacity)

        def pad(t: torch.Tensor, rows: int, fill) -> torch.Tensor:
            extra = rows - t.shape[0]
            if extra <= 0:
                return t
            return torch.cat([t, t.new_full((extra, *t.shape[1:]), fill)])

        c, u = capacity, new_cfg.upper_capacity
        g = self._graph
        for name in ("neighbors0", "levels", "upper_slot"):
            setattr(g, name, pad(getattr(g, name), c, -1))
        for name in ("upper_node", "upper_neighbors"):
            setattr(g, name, pad(getattr(g, name), u, -1))
        self._storage.grow(c)
        if self._alive is not None:
            self._alive = pad(self._alive, c, True)
        if self._route is not None:    # PQ routing codes [capacity, pq_m]
            cb, codes, bits = self._route
            self._route = (cb, pad(codes, c, 0), bits)
        if self._host is not None:     # build="host": its numpy arrays
            h = self._host
            h.cfg = h.cfg.replace(capacity=c, upper_capacity=u)
            for name, rows in (("vectors", c), ("neighbors0", c),
                               ("levels", c), ("upper_slot", c),
                               ("upper_node", u), ("upper_neighbors", u)):
                a = getattr(h, name)
                setattr(h, name, np.pad(
                    a, [(0, rows - len(a))] + [(0, 0)] * (a.ndim - 1),
                    constant_values=0 if name == "vectors" else -1))
        self.config = new_cfg
        if self._builder is not None:  # the level RNG carries on
            self._builder.cfg = new_cfg

    # -- packed serving mode (ops/packed.py) -------------------------------
    def enable_packed(self, bits: int = 8, *, mode: str | None = None,
                      layout: str = "auto", pq_m: int | None = None,
                      pq_bits: int = 8, train_x: np.ndarray | None = None,
                      max_bytes: int | None = None, reserve: int = 0,
                      chunk: int = 1 << 16) -> int:
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
        "bytes" (the reference picks "words" only on a TPU).

        The tables hold rows for ids < ntotal + ``reserve``, padded up to a
        whole number of ``chunk``-row chunks (``ops/packed.py``
        ``padded_rows``). Later ``add()`` calls keep them valid: in place
        while the new total fits those rows, else by a full re-pack.
        Tombstoned ids keep routing (results are filtered); ``vacuum()``
        drops the tables."""
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
            layout = "bytes" if layout == "auto" else layout
            self._packed = pack_neighbors(
                self._graph.neighbors0, self._storage, self._graph.levels,
                bits=bits, max_bytes=max_bytes, n_rows=n_rows, chunk=chunk,
                layout=layout)
        else:
            from ..ops.packed import pack_pq_neighbors
            cb, codes, pq_bits = self._route_codebooks(pq_m, pq_bits, train_x)
            self._packed = pack_pq_neighbors(
                self._graph.neighbors0, codes, cb, pq_bits=pq_bits,
                max_bytes=max_bytes, n_rows=n_rows, chunk=chunk)
        self._packed_opts = dict(bits=bits, mode=mode, layout=layout,
                                 pq_m=pq_m, pq_bits=pq_bits,
                                 max_bytes=max_bytes, reserve=reserve,
                                 chunk=chunk)
        return self._packed.nbytes

    def _route_codebooks(self, pq_m, pq_bits, train_x):
        """(cb, codes [capacity, pq_m], pq_bits) of PQ-coded packed rows:
        pq storage's own, or ROUTING-only codebooks trained once and kept
        until ``disable_packed(reset_routing=True)``."""
        if self.config.is_pq:
            return self._storage.pq, self._storage.rows, self.config.pq_bits
        if self._route is not None:
            cb = self._route[0]
            if pq_m not in (None, cb.shape[0]):
                raise ValueError(
                    f"routing codebooks already trained with pq_m="
                    f"{cb.shape[0]}; call disable_packed(reset_routing="
                    f"True) to retrain with pq_m={pq_m}")
            return self._route
        from ..ops.pq import train_pq
        if pq_m is None or pq_m <= 0 or self.config.dim % pq_m:
            raise ValueError(
                f"mode='pq' on {self.config.dtype} storage needs pq_m > 0 "
                f"dividing dim={self.config.dim} (got {pq_m})")
        xs = np.asarray(train_x, np.float32) if train_x is not None \
            else self.reconstruct_n(0, min(self.ntotal, 65536))
        cb = torch.from_numpy(train_pq(xs, pq_m, ksub=1 << pq_bits,
                                       seed=self.config.seed,
                                       device=self.device)).to(self.device)
        codes = self._storage.pq_codes(cb)
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
        ``n_expand`` attribute sets the expansions per hop.

        Tombstoned ids (``remove_ids``) are filtered out, with a user
        filter too (``allowed & alive``), until ``vacuum()``; when every id
        is dead the result is empty (inf, -1).

        While tracing is on (``trace.py``) the call is span
        ``hnsw.search``, with ``hnsw.search.upload``, the search's own
        spans, ``hnsw.search.wait`` and ``hnsw.search.download``."""
        with trace.span("hnsw.search"):
            if use_packed is None:
                packed = self._packed
            elif use_packed:
                if self._packed is None:
                    raise ValueError("use_packed=True but enable_packed() was "
                                     "not called")
                packed = self._packed
            else:
                packed = None
            if self.ntotal == 0 or self.n_deleted >= self.ntotal:
                n = len(x)
                return (np.full((n, k), np.inf, np.float32),
                        np.full((n, k), -1, np.int64))
            g, st, q, kw = self._search_call(
                x, k, ef_search=ef_search, with_stats=with_stats,
                allowed=allowed, max_hops=max_hops, packed=packed,
                beam_keys=beam_keys, entry_mode=entry_mode)
            out = hnsw_search(g, st, q, **kw)
            if device_out:
                return out
            if not with_stats:          # with_stats: hnsw_search waited
                trace.wait(out[0])
            with trace.span("hnsw.search.download"):
                d = out[0].cpu().numpy()
                i = out[1].cpu().numpy().astype(np.int64)
            return (d, i, out[2]) if with_stats else (d, i)

    def _search_call(self, x, k: int, *, ef_search=None, with_stats=False,
                     allowed=None, max_hops=0, packed=None, beam_keys=None,
                     entry_mode=None):
        """(graph, storage, queries, {keywords}) of the ``hnsw_search`` call
        that ``search`` makes (``search.search_key`` takes the same)."""
        with trace.span("hnsw.search.upload"):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            x = x.to(self.device, torch.float32)
        if allowed is not None:
            allowed = self._normalize_allowed(allowed)
        if self._alive is not None and not self._routing_clean:
            allowed = self._alive if allowed is None \
                else allowed & self._alive
        return self._graph, self._storage, x, dict(
            k=k, ef_search=int(ef_search or self.ef_search),
            metric=self.config.metric,
            max_level_cap=self.config.max_level_cap, max_hops=max_hops,
            n_expand=self.n_expand, with_stats=with_stats, allowed=allowed,
            packed=packed, beam_keys=beam_keys or self.beam_keys,
            entry_mode=entry_mode or self.entry_mode)

    def _oracle_ids(self, x: torch.Tensor, k: int) -> np.ndarray:
        """Exact top-k ids of ``x`` over the stored vectors (x̂ for a
        codec), tombstoned ids included, as the reference's tuners."""
        return self._storage.exact_topk(x, k, self.config.metric,
                                        self.ntotal)[1].cpu().numpy()

    def _recall_at(self, x, gt, k: int, ef: int, hops: int = 0) -> float:
        from ..utils.recall import recall_at_k
        _, ii = self.search(x, k, ef_search=ef, max_hops=hops)
        return recall_at_k(ii, gt, k)

    def tune_ef_search(self, x: np.ndarray, target_recall: float = 0.95,
                       *, k: int = 10, set_default: bool = True,
                       ef_grid=(16, 24, 32, 48, 64, 96, 128, 192, 256,
                                384, 512)) -> int:
        """faiss AutoTune analogue: the smallest grid ef whose recall@k on
        ``x``, against the exact oracle over the stored vectors, reaches
        ``target_recall`` (the largest grid point if none does). With
        ``set_default`` it becomes ``self.ef_search``."""
        x = torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
        gt = self._oracle_ids(x, k)
        chosen = ef_grid[-1]
        for ef in ef_grid:
            if ef >= k and self._recall_at(x, gt, k, ef) >= target_recall:
                chosen = ef
                break
        if set_default:
            self.ef_search = int(chosen)
        return int(chosen)

    def tune_operating_point(self, x: np.ndarray, target_recall: float = 0.95,
                             *, k: int = 10, set_default: bool = True,
                             ef_grid=(16, 24, 32, 40, 48, 56, 64, 80, 96,
                                      128, 192, 256, 384, 512)) -> tuple:
        """The cheapest (ef_search, max_hops) reaching ``target_recall``:
        the smallest grid ef that reaches it at the auto hop cap, then the
        smallest hop cap (binary search over [16, ef + 8]; recall does not
        fall as the cap rises) that still does. Returns (ef, max_hops);
        with ``set_default`` the ef becomes ``self.ef_search`` (pass
        max_hops to each search)."""
        x = torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
        gt = self._oracle_ids(x, k)
        chosen_ef = ef_grid[-1]
        for ef in ef_grid:
            if ef >= k and self._recall_at(x, gt, k, ef) >= target_recall:
                chosen_ef = int(ef)
                break
        lo, hi = 16, chosen_ef + 8
        best = hi
        while lo <= hi:
            mid = (lo + hi) // 2
            if self._recall_at(x, gt, k, chosen_ef, mid) >= target_recall:
                best, hi = mid, mid - 1
            else:
                lo = mid + 1
        if set_default:
            self.ef_search = chosen_ef
        return chosen_ef, int(best)

    def range_search(self, x: np.ndarray, radius: float, *,
                     ef_search: int | None = None, **kw):
        """faiss ``IndexHNSW.range_search``: L2 keeps squared distance <
        radius, IP keeps dot > radius; returns (lims [nq+1], D, I) in
        faiss's CSR layout, each query's results best-first. Bounded by the
        beam: at most ``ef_search`` candidates a query are tested (raise it
        to widen coverage; ``FlatIndex.range_search`` is exact). Keyword
        arguments go to :meth:`search`."""
        ef = int(ef_search or self.ef_search)
        d, i = self.search(x, k=ef, ef_search=ef, **kw)
        if self.config.metric == L2:
            keep = (i >= 0) & (d < radius)
        else:
            d = -d  # the search returns -dot ascending; faiss reports dot
            keep = (i >= 0) & (d > radius)
        lims = np.zeros(len(d) + 1, np.int64)
        np.cumsum(keep.sum(1), out=lims[1:])
        return lims, d[keep], i[keep]

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
    def reconstruct(self, i: int) -> np.ndarray:
        if not 0 <= i < self.ntotal:
            raise IndexError(i)
        return self.reconstruct_n(i, 1)[0]

    def reconstruct_n(self, i0: int, n: int) -> np.ndarray:
        """Stored rows as f32 on the host (x̂ for a codec), not a view."""
        return np.array(self._storage.read(slice(i0, i0 + n)).cpu())

    def reconstruct_batch(self, ids: np.ndarray) -> np.ndarray:
        """Decode arbitrary ids (faiss ``reconstruct_batch``); ids may
        repeat, and -1 decodes to a zero row."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ((ids < -1) | (ids >= self.ntotal)).any():
            raise IndexError("reconstruct_batch: id out of range")
        v = np.array(self._storage.read(torch.from_numpy(
            np.maximum(ids, 0)).to(self.device)).cpu())
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

    def merge_from(self, other: "HnswIndex") -> int:
        """Absorb another index's live vectors (faiss ``merge_from``; a
        batched re-insert, so graph quality equals a fresh add()).
        Tombstoned ids of ``other`` are skipped and ``other`` is unchanged.
        The merged vectors take ids from ``self.ntotal`` on. Returns how
        many were merged."""
        if other.config.dim != self.config.dim:
            raise ValueError(f"merge_from: dim mismatch {other.config.dim} "
                             f"!= {self.config.dim}")
        if other.config.metric != self.config.metric:
            raise ValueError("merge_from: metric mismatch")
        if other.ntotal == 0:
            return 0
        x = other.reconstruct_n(0, other.ntotal)
        if other._alive is not None:
            x = x[other._alive[:other.ntotal].cpu().numpy()]
        if len(x):
            self.add(x)
        return len(x)

    # -- deletion (tombstones) ------------------------------------------------
    def remove_ids(self, ids: np.ndarray) -> int:
        """Tombstone ids: they leave the results at once but keep routing
        queries (the graph stays whole) until ``vacuum()``. Slots are not
        reused and other ids keep their numbers (faiss renumbers:
        ``compacted``). Returns the number of ids newly removed."""
        ids = np.asarray(ids).reshape(-1)
        if ((ids < 0) | (ids >= self.ntotal)).any():
            raise IndexError("remove_ids: id out of range")
        if self._alive is None:
            self._alive = torch.ones(self.config.capacity, dtype=torch.bool,
                                     device=self.device)
        t = torch.from_numpy(np.unique(ids).astype(np.int64)).to(self.device)
        newly = int(self._alive[t].sum())
        self._alive[t] = False
        self._n_deleted += newly
        self._routing_clean = False
        return newly

    def vacuum(self) -> int:
        """Remove tombstoned nodes from routing (``ops/vacuum.py``): links
        into dead nodes are deleted and the holes patched with live
        candidates inherited from the dead nodes' lists, re-pruned by the
        select-neighbors heuristic; dead rows are cleared and the entry
        point moves to a live node. Searches then need no tombstone filter
        (nor its full-convergence beam). Ids stay stable. Packed tables are
        dropped (call ``enable_packed()`` again). Returns the number of
        nodes vacuumed."""
        if self._alive is None or self.n_deleted == 0:
            self._routing_clean = True
            return 0
        from ..ops.vacuum import live_entry_point, vacuum_level0, vacuum_upper
        n_dead = self.n_deleted
        g, metric = self._graph, self.config.metric
        dead = ~self._alive & (g.levels >= 0)
        self._packed = None          # rows hold pre-vacuum adjacency
        rows0 = vacuum_level0(g.neighbors0, self._storage, dead,
                              metric=metric)
        rows_up = vacuum_upper(g.upper_neighbors, g.upper_node, g.upper_slot,
                               self._storage, dead, metric=metric)
        g.entry_point, g.max_level = live_entry_point(g.levels, dead)
        self._routing_clean = True
        self._last_vacuum = {"level0": rows0, "upper": rows_up}
        return n_dead

    def compacted(self, x: np.ndarray | None = None) -> tuple[
            "HnswIndex", np.ndarray]:
        """A new index WITHOUT the tombstoned ids, renumbered like faiss
        ``remove_ids``, on this index's device. Returns (new_index,
        old_ids), ``old_ids[j]`` the original id of new id j. ``x``: the
        original f32 vectors [ntotal, d]; by default the stored ones
        (``reconstruct_n``; x̂ for a codec, which encodes to the same
        codes)."""
        n = self.ntotal
        x = self.reconstruct_n(0, n) if x is None else \
            np.asarray(x, np.float32)
        if x.shape[0] != n:
            raise ValueError(f"expected all {n} original vectors, "
                             f"got {x.shape[0]}")
        alive = np.ones(n, bool) if self._alive is None \
            else self._alive[:n].cpu().numpy()
        old_ids = np.flatnonzero(alive)
        out = HnswIndex(config=self.config, build=self.build_mode,
                        device=self.device)
        out.ef_construction = self.ef_construction
        out.ef_search = self.ef_search
        out._storage.set_codec(self._storage.codec_arrays())
        if len(old_ids):
            out.add(x[old_ids])
        return out, old_ids

    # -- maintenance ----------------------------------------------------------
    def check(self, strict: bool = True) -> dict:
        """Structural invariant check on the host (``check_invariants``);
        tombstoned nodes are exempt from the liveness invariants, and
        ``links_to_dead`` counts live links into them."""
        alive = None if self._alive is None else self._alive.cpu().numpy()
        return check_invariants(self._graph, self.config, strict=strict,
                                alive=alive)

    # -- persistence (faiss write_index / read_index) -------------------------
    def save(self, path) -> None:
        """Write the reference's ``.npz`` (a file name or a binary file
        object): graph, vectors (codes for sq8 / PQ), config, the level-RNG
        state, the codec state (``sq_offset`` / ``sq_scale`` /
        ``pq_codebooks``), the tombstones (``alive``, ``routing_clean``) and
        the back-link window (``r_window``, which the reference's load
        ignores), so either package loads it and a resumed build draws the
        levels and repairs the links an uninterrupted one would."""
        extra = {"routing_clean": bool(self._routing_clean),
                 "r_window": int(self.r_window)}
        if self._builder is not None:
            extra["builder_rng_state"] = jsonify(
                self._builder.rng.bit_generator.state)
        xarr = self._storage.codec_arrays()
        if self._alive is not None:
            xarr["alive"] = self._alive.cpu().numpy()
        save_graph(path, self._graph, self._storage.rows, self.config, extra,
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
        further adds draw the levels the writer's would, and so do
        tombstones: a file saved before ``vacuum()`` keeps filtering, and the
        back-link window (16 where the file has none, as the reference's)."""
        arrays, vectors, cfg, extra, xarr = load_graph(path)
        idx = cls(config=cfg, device=device, _alloc=False)
        idx.r_window = int(extra.get("r_window", idx.r_window))
        idx._graph = graph_from_numpy(arrays, idx.device)
        idx._storage = Storage.load(vectors, cfg, idx.device, xarr)
        if "alive" in xarr:
            alive = np.asarray(xarr["alive"], bool)
            idx._alive = torch.from_numpy(alive).to(idx.device)
            idx._n_deleted = idx.ntotal - int(alive[:idx.ntotal].sum())
            idx._routing_clean = bool(extra.get("routing_clean", False))
        if "builder_rng_state" in extra:
            from ..build import DeviceBuilder
            idx._builder = DeviceBuilder(cfg, r_window=idx.r_window)
            idx._builder.rng.bit_generator.state = extra["builder_rng_state"]
        return idx
