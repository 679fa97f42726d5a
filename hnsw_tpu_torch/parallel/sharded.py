"""Sharded HNSW, ported from ``hnsw_tpu.parallel.sharded``: one sub-index
per shard, a fan-out search and a global top-k merge.

  * the dataset is sharded round robin (user id ``u`` lives on shard
    ``u % S``); each shard owns an independent sub-index: its graph, its
    ``Storage`` (``ops/storage.py``: the rows and the codec's tensors) and
    a local-row -> user-id table, as tensors on the shard's device;
  * **build**: every shard takes the same batch schedule in lockstep (the
    reference's one ``shard_map`` step a batch): the batch size follows the
    smallest shard, each shard draws its levels from its own seeded
    generator, and the per-shard insert is the single index's staged
    batch (``build.StagedBuild``), replayed from its capture on a card;
  * **search**: each shard searches its own sub-index (``hnsw_search``,
    with the shard-local form of a user-id filter), maps local rows to
    user ids, and the per-shard [Q, k] results are merged on the first
    shard's device into the global top k. Ties resolve to the lower shard,
    as the reference's ``top_k`` does;
  * **elastic serving**: a shard marked failed (by an operator or by
    ``health_check``) is left out of the merge until ``restore_shards``
    reloads it from a ``save()`` checkpoint.

A mesh (``make_mesh``) is an [S, q] grid of devices; a device may repeat,
so one card (or the CPU) holds many shards. A shard's state lives on its
row's device, so the q devices of a row must be one device here: the q axis
keeps the reference's API, and each shard searches the whole batch at once
(each query is searched on its own, so the results are the same).

Two forms, as the reference's mesh may span ``jax.distributed`` processes:

  * one process drives every shard, one after another;
  * under an initialized ``torch.distributed`` group, one process per card
    (or per block of shards): the mesh is every rank's local devices in
    rank order, and the rank that owns a row's devices owns its shard. The
    contract is the reference's SPMD one: every rank makes the same calls
    with the same arguments (the same ``x``, the same queries). A rank
    inserts only its own shards but replays the others' level draws from
    their seeded generators, so every rank follows the one-process form's
    lockstep schedule and every shard's graph equals that form's edge for
    edge. A search runs ``hnsw_search`` on the rank's own shards, one
    ``all_gather`` over the ranks collects the [S, Q, k] results, and every
    rank merges them into the full (D, I). The backend is the caller's:
    under NCCL the gathered tensors stay on the card, under gloo they go
    through host memory for the collective only. Failed shards, tombstones
    and the sq8 quantizer (trained on the rank that owns shard 0 and
    broadcast) are the same on every rank; ``health_check`` and ``check``
    gather each rank's reports on its own shards.

``save`` / ``load`` read and write the reference's ``.npz`` key for key,
so a sharded index moves between the packages either way. Across processes
``save`` raises, as the reference's must (it fetches arrays that span
other processes' devices); ``load`` and ``restore_shards`` read each
rank's own shards from a file every rank can open.
"""

from __future__ import annotations

import json
import logging

import numpy as np
import torch

from .. import graphs, trace
from ..build import (DeviceBuilder, order_batch_by_level, stage_plan,
                     upper_batch_cap)
from ..config import L2, HnswConfig
from ..graph import (SCALAR_FIELDS, TENSOR_FIELDS, GraphArrays,
                     check_invariants, empty_graph, jsonify)
from ..ops.storage import Storage
from ..search import hnsw_search

SHARD_AXIS = "shard"
QUERY_AXIS = "q"
INTRA_K, R_WINDOW = 32, 16   # the reference's sharded insert constants

log = logging.getLogger("hnsw_tpu_torch")


class Mesh:
    """An [S, q] grid of ``torch.device``s: row s serves shard s.
    ``shape`` is keyed like the reference's. ``ranks`` (same grid) names
    the process that owns each device; ``rank`` / ``world`` are this
    process's place in the group (0 / 1 in the one-process form, where
    every device is local)."""

    def __init__(self, devices, ranks=None, rank: int = 0, world: int = 1):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        self.ranks = ranks if ranks is not None else \
            [[rank] * len(row) for row in self.devices]
        self.rank, self.world = rank, world

    @property
    def shape(self) -> dict:
        return {SHARD_AXIS: len(self.devices),
                QUERY_AXIS: len(self.devices[0])}


def make_mesh(n_shards: int | None = None, q_parallel: int = 1,
              devices=None) -> Mesh:
    """All ``devices`` on the shard axis (``n_shards`` rows of
    ``q_parallel``); by default every visible CUDA device, and with no card
    this raises. A list may repeat a device: ``[torch.device("cuda")] * 4``
    puts four shards on one card. Under an initialized ``torch.distributed``
    group ``devices`` are this rank's local devices (every rank calls
    ``make_mesh`` with the same counts), and the mesh spans every rank's,
    in rank order: ``make_mesh(4, 2, devices=[cpu] * 4)`` on each of two
    ranks puts shards 0-1 on rank 0 and shards 2-3 on rank 1."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices="
                               "[torch.device('cpu')] * n to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    import torch.distributed as dist
    devices = [torch.device(d) for d in devices]
    rank, world = 0, 1
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    owners = [rank] * len(devices)
    if world > 1:
        per_rank = [None] * world
        dist.all_gather_object(per_rank, [str(d) for d in devices])
        devices = [torch.device(d) for r in per_rank for d in r]
        owners = [r for r in range(world) for _ in per_rank[r]]
    if n_shards is None:
        n_shards = max(1, len(devices) // q_parallel)
    if n_shards < 1 or q_parallel < 1 or \
            n_shards * q_parallel > len(devices):
        raise ValueError(f"a mesh of {n_shards} x {q_parallel} needs that "
                         f"many devices, got {len(devices)}")
    rows = [slice(s * q_parallel, (s + 1) * q_parallel)
            for s in range(n_shards)]
    return Mesh([devices[r] for r in rows], [owners[r] for r in rows],
                rank, world)


class _RemoteShard:
    """Another rank's shard, as this rank tracks it: the scalars of the
    lockstep schedule (``ntotal`` sizes every batch), no tensors."""

    def __init__(self):
        self.ntotal = self.n_upper = self.entry_point = 0
        self.max_level = -1


class ShardedHnswIndex:
    """Dataset-sharded HNSW: a sub-index per shard, fan-out search, global
    top-k merge. The API follows ``HnswIndex`` (add / search / ntotal /
    save / load; tombstones and vacuum; packed serving)."""

    def __init__(self, dim: int | None = None, m: int = 32, metric: str = L2,
                 *, mesh: Mesh | None = None,
                 capacity_per_shard: int = 250_000,
                 config: HnswConfig | None = None, **kw):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.shape[SHARD_AXIS]
        if config is None:
            config = HnswConfig(dim=dim, m=m, metric=metric,
                                capacity=capacity_per_shard, **kw)
        if config.is_pq:
            raise ValueError("ShardedHnswIndex does not take dtype='pq' "
                             "storage (no codebooks per shard); use "
                             "HnswIndex for PQ storage")
        for row, owners in zip(self.mesh.devices, self.mesh.ranks):
            if any(d != row[0] for d in row) or \
                    any(r != owners[0] for r in owners):
                raise ValueError("the q devices of a mesh row must be one "
                                 "device: a shard's state lives on one "
                                 f"device, got {row} on ranks {owners}")
        self.config = config
        self.ef_search = config.ef_search
        self.ef_construction = config.ef_construction
        cfg, S = config, self.n_shards
        self._dev = [row[0] for row in self.mesh.devices]
        self._rank, self._world = self.mesh.rank, self.mesh.world
        # the rank that owns each shard, and each rank's shards in order
        self._owner = [owners[0] for owners in self.mesh.ranks]
        self._shards_of = [[s for s in range(S) if self._owner[s] == r]
                           for r in range(self._world)]
        self._local = self._shards_of[self._rank]
        # the merge runs on this rank's first shard's device
        self._merge_dev = self._dev[self._local[0]] if self._local \
            else torch.device("cpu")
        self._graphs = [empty_graph(cfg, self._dev[s]) if self._is_local(s)
                        else _RemoteShard() for s in range(S)]
        # each local shard's rows and codec tensors; the one sq8 quantizer
        # of every shard on the host (the x̂ encode, saving): ``_codec``
        self._storage = [Storage.empty(cfg, self._dev[s])
                         if self._is_local(s) else None for s in range(S)]
        self._codec = Storage(torch.zeros((0, cfg.dim)))
        # local row -> user id (insertion order), -1 unused
        self._global_ids = [torch.full((cfg.capacity,), -1, dtype=torch.int32,
                                       device=self._dev[s])
                            if self._is_local(s) else None for s in range(S)]
        self._builders = [DeviceBuilder(cfg.replace(seed=cfg.seed + s),
                                        intra_k=INTRA_K, r_window=R_WINDOW)
                          for s in range(S)]
        self._ntotal = 0
        # tombstones over USER ids (bool [S * capacity]; None: none). Results
        # are filtered, routing is untouched until vacuum()
        self._removed: np.ndarray | None = None
        self._routing_clean = True
        # per-shard health: a failed shard is left out of the merge
        self._shard_ok = np.ones(S, bool)
        # per-shard packed serving tables (enable_packed); None: unpacked
        self._packed: list | None = None
        # per shard, the last add()'s StagedBuild.stats() (None: no batch
        # or another rank's shard)
        self.last_build_stats: list = []

    @property
    def ntotal(self) -> int:
        return self._ntotal

    @property
    def is_trained(self) -> bool:
        return not self.config.is_sq or self._codec.coded

    def _is_local(self, s: int) -> bool:
        return self._owner[s] == self._rank

    def _gather_objects(self, obj) -> list:
        """Every rank's ``obj``, in rank order (``[obj]`` in one
        process)."""
        if self._world == 1:
            return [obj]
        import torch.distributed as dist
        out = [None] * self._world
        dist.all_gather_object(out, obj)
        return out

    @property
    def d(self) -> int:  # faiss naming; lets the wrappers compose
        return self.config.dim

    @property
    def _counts(self) -> np.ndarray:
        """Points on each shard (int64 [S])."""
        return np.array([g.ntotal for g in self._graphs], np.int64)

    # ------------------------------------------------------------------ add
    def train(self, x: np.ndarray) -> None:
        """A no-op for flat storage; for sq8 the per-dim range of ``x``,
        one quantizer for every shard (so user ids and save / load stay
        uniform). Must come before the first ``add()``."""
        if not self.config.is_sq:
            return
        if self._ntotal:
            raise RuntimeError("train() after add(): stored codes would "
                               "decode under different params")
        params = None
        if self._is_local(0):   # on shard 0's device, as in one process
            self._storage[0].train(np.asarray(x, np.float32), self.config)
            params = self._storage[0].codec_arrays()
        if self._world > 1:
            import torch.distributed as dist
            box = [params]
            dist.broadcast_object_list(box, src=self._owner[0])
            params = box[0]
        self._codec.set_codec(params)
        for st in self._storage:      # its tensors made once on each device
            if st is not None:
                st.set_codec(params)

    def add(self, x: np.ndarray) -> None:
        """Round-robin shard assignment; user ids are insertion order. Every
        shard takes the same batch schedule: the batch size follows the
        smallest shard (``DeviceBuilder.BATCH_SIZES``), a shard's levels are
        drawn a batch at a time, and when a batch's level>=1 points pass
        ``upper_batch_cap`` its tail is spilled to the next batch with its
        drawn levels thrown away (the generator has moved past them).
        Across processes every rank passes the same ``x``: a rank inserts
        its own shards and replays the others' draws.

        While tracing is on (``trace.py``) the call is span
        ``hnsw.shard.add``, with ``hnsw.shard.plan`` (the host's lockstep
        schedule) and ``hnsw.shard.stage`` (each shard's plan staged on its
        device) before the insert batches' own spans."""
        with trace.span("hnsw.shard.add"):
            cfg = self.config
            if self._packed is not None:
                log.warning("add() on a packed sharded index drops the "
                            "packed tables; call enable_packed() again after "
                            "adding")
                self.disable_packed()
            x = np.ascontiguousarray(np.asarray(x, np.float32))
            if x.ndim != 2 or x.shape[1] != cfg.dim:
                raise ValueError(f"expected [n, {cfg.dim}], got {x.shape}")
            if not self.is_trained:
                raise RuntimeError("sq8 storage: call train(x) before add()")
            x = self._codec.encode(x)  # the build sees x̂, writes re-encode
            S = self.n_shards
            user_ids = np.arange(self._ntotal, self._ntotal + len(x))
            per_shard = [np.flatnonzero(user_ids % S == s) for s in range(S)]
            counts = self._counts
            if max(counts[s] + len(per_shard[s]) for s in range(S)) > \
                    cfg.capacity:
                raise ValueError("capacity_per_shard exceeded")
            offs = np.zeros(S, np.int64)
            efc = int(self.ef_construction)
            sizes = DeviceBuilder.BATCH_SIZES
            parts = [[] for _ in range(S)]   # each shard's batches, in order
            uids = [[] for _ in range(S)]    # and their user ids
            with trace.span("hnsw.shard.plan"):
                while any(offs[s] < len(per_shard[s]) for s in range(S)):
                    allowed = max(sizes[0], max(1, int(self._counts.min())))
                    size = max(s for s in sizes if s <= allowed)
                    for s in range(S):
                        rows = per_shard[s][offs[s]:offs[s] + size]
                        if len(rows):
                            offs[s] += self._plan_rows(s, x, rows, user_ids,
                                                       size, parts[s], uids[s])
            with trace.span("hnsw.shard.stage"):
                runs = [self._stage_shard(s, parts[s], uids[s], efc)
                        for s in range(S)]
            # the lockstep steps: each one batch of every shard that has one
            for k in range(max(len(p) for p in parts)):
                for s, run in enumerate(runs):
                    if run is not None and k < len(parts[s]):
                        run.step()
            self.last_build_stats = [None if run is None else
                                     dict(run.stats(), dropped=run.finish())
                                     for run in runs]
            del runs                # frees the staged plans and their captures
            graphs._purge()
            self._ntotal += len(x)

    def _plan_rows(self, s: int, x: np.ndarray, rows: np.ndarray,
                   user_ids: np.ndarray, size: int, parts: list,
                   uids: list) -> int:
        """Plan one lockstep step of shard ``s`` on the host: ``rows``
        (indices into ``x``, at most ``size``) drawn, spilled and sorted
        into a batch appended to ``parts`` (``build.stage_plan``'s parts,
        with no rows of ``x`` for another rank's shard; its user ids to
        ``uids``); ``ntotal`` and ``n_upper`` move on. An
        empty shard's first point is seeded here. Returns how many rows it
        consumed. Another rank's shard takes the same draws."""
        cfg, b, g = self.config, self._builders[s], self._graphs[s]
        local = self._is_local(s)
        seeded = 0
        if g.ntotal == 0:   # the first point of an empty shard
            lv0 = int(b._draw_levels(1)[0])
            if local:
                b._seed_first(g, self._storage[s], x[rows[0]], lv0)
                self._global_ids[s][0] = int(user_ids[rows[0]])
            else:
                g.entry_point, g.max_level, g.ntotal = 0, lv0, 1
                g.n_upper = int(lv0 >= 1)
            rows, seeded = rows[1:], 1
            if not len(rows):
                return seeded
        lv = b._draw_levels(len(rows))
        n_ups = np.cumsum(lv >= 1)
        cap_up = upper_batch_cap(size, cfg.m)
        if n_ups[-1] > cap_up:   # spill the tail; its levels are dropped
            take = int(np.searchsorted(n_ups, cap_up, side="right"))
            lv, rows = lv[:take], rows[:take]
        perm, pids = order_batch_by_level(lv, g.ntotal)
        lv_sorted = lv[perm]
        ups = np.flatnonzero(lv_sorted >= 1)
        if g.n_upper + len(ups) > cfg.upper_capacity:
            raise ValueError("upper_capacity exceeded")
        slots = np.full(len(rows), -1, np.int32)
        slots[ups] = np.arange(g.n_upper, g.n_upper + len(ups),
                               dtype=np.int32)
        parts.append((x[rows][perm] if local else None, pids, lv_sorted,
                      slots, size))
        uids.append(user_ids[rows][perm])
        g.ntotal += len(rows)
        g.n_upper += len(ups)
        return len(rows) + seeded

    def _stage_shard(self, s: int, parts: list, uids: list, efc: int):
        """Shard ``s``'s planned batches staged on its device, with its
        user ids written (``StagedBuild.finish`` moves the entry point and
        max level on); None for another rank's shard, whose scalars move
        on here, or a shard with no batch."""
        g = self._graphs[s]
        if not self._is_local(s):
            # a batch's first row has its top level (``build._schedule``)
            for _, pids, lv, _, _ in parts:
                if int(lv[0]) > g.max_level:
                    g.entry_point, g.max_level = int(pids[0]), int(lv[0])
            return None
        if not parts:
            return None
        plan = stage_plan(parts, self.config.dim, self.config.capacity)
        dev = self._dev[s]
        rows = np.concatenate([p[1] for p in parts]).astype(np.int64)
        self._global_ids[s][torch.from_numpy(rows).to(dev)] = \
            torch.from_numpy(np.concatenate(uids).astype(np.int32)).to(dev)
        return self._builders[s].staged(g, self._storage[s], plan, efc)

    # ------------------------------------------------- packed serving mode
    @property
    def packed_enabled(self) -> bool:
        return self._packed is not None

    def enable_packed(self, bits: int = 8, *, layout: str = "auto") -> int:
        """Per-shard packed neighbor-code tables (``ops/packed.py``
        ``pack_neighbors``), every shard's with the same row count (the
        largest shard's). sq8 storage at 8 bits packs its stored codes;
        otherwise each shard trains its quantizer on its live rows.
        ``layout``: "bytes", "words" or "auto" ("bytes"; the reference
        picks "words" only on a TPU). ``add()`` and ``vacuum()`` drop the
        tables. Returns the tables' bytes over every shard (every rank's,
        across processes)."""
        from ..ops.packed import pack_neighbors
        if bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        if layout not in ("auto", "bytes", "words"):
            raise ValueError(f"layout must be 'auto', 'bytes' or 'words', "
                             f"got {layout!r}")
        if self._ntotal == 0:
            raise ValueError("enable_packed() on an empty index")
        layout = "bytes" if layout == "auto" else layout
        n_rows = max(1, int(self._counts.max()))
        self._packed = None          # free the old tables first
        self._packed = [
            pack_neighbors(g.neighbors0, st, g.levels, bits=bits,
                           n_rows=n_rows, chunk=min(1 << 16, n_rows),
                           layout=layout)
            if st is not None else None
            for g, st in zip(self._graphs, self._storage)]
        return sum(self._gather_objects(
            sum(p.nbytes for p in self._packed if p is not None)))

    def disable_packed(self) -> None:
        self._packed = None

    # ---------------------------------------------------------------- search
    def search(self, x, k: int, *, ef_search: int | None = None,
               allowed=None):
        """Fan-out k-NN. Returns (D [n, k] float32, I [n, k] int64) numpy
        arrays of USER ids (-1, inf past the reachable set). ``allowed``:
        a user-id filter, a bool mask or an int id list; it composes with
        the tombstones of ``remove_ids``. Raise ef_search when filtering
        hard: each shard's traversal is unfiltered. Across processes every
        rank passes the same queries and gets the full merged result.

        While tracing is on (``trace.py``) the call is span
        ``hnsw.shard.search``, with the phases ``hnsw.shard.local`` (this
        rank's shard searches and their id map), ``hnsw.shard.gather`` (the
        ``all_gather`` across processes, with the wait for the slowest
        rank) and ``hnsw.shard.merge``, each timed on a CUDA device by
        events between the phases, then ``hnsw.search.wait`` and
        ``hnsw.shard.download`` (the result to the host)."""
        with trace.span("hnsw.shard.search"):
            x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                           np.float32)
            if self._ntotal == 0:
                n = len(x)
                return (np.full((n, k), np.inf, np.float32),
                        np.full((n, k), -1, np.int64))
            permit = None if allowed is None else \
                self._normalize_allowed(allowed)
            if self._removed is not None and not self._routing_clean:
                alive = ~self._removed   # dead ids route until vacuum()
                permit = alive if permit is None else permit & alive
            ef = max(int(ef_search or self.ef_search), k)
            with trace.Phases("hnsw.shard", self._merge_dev,
                              trace.enabled()) as ph:
                ph.mark("local")
                parts = [self._search_shard(s, x, k, ef, permit)
                         for s in self._local]
                if self._world > 1:
                    ph.mark("gather")
                    parts = self._gather_parts(parts, len(x), k)
                ph.mark("merge")
                d, i = merge_topk([p[0] for p in parts],
                                  [p[1] for p in parts], k)
            trace.wait(d)
            with trace.span("hnsw.shard.download"):
                out = d.cpu().numpy(), i.cpu().numpy().astype(np.int64)
            trace.add_device("hnsw.shard", ph.ms())
            return out

    def _gather_parts(self, parts: list, n: int, k: int) -> list:
        """Every shard's (D, I), in shard order, from each rank's own
        ``parts``: one ``all_gather`` of [L, 2, n, k] float32 (the ids'
        int32 bits ride as float32), L the most shards a rank owns (a rank
        with fewer pads with rows it drops). Under NCCL the tensors stay on
        the card; otherwise they go through host memory for the collective
        only, and the merge runs back on this rank's device."""
        import torch.distributed as dist
        width = max(len(sh) for sh in self._shards_of)
        dev = self._merge_dev
        host = not (dev.type == "cuda" and "nccl" in str(dist.get_backend()))
        mine = torch.zeros((width, 2, n, k), dtype=torch.float32, device=dev)
        for j, (d, i) in enumerate(parts):
            mine[j, 0], mine[j, 1] = d, i.view(torch.float32)
        if host:
            mine = mine.cpu()
        out = [torch.empty_like(mine) for _ in range(self._world)]
        dist.all_gather(out, mine)
        trace.count("shard.gathered_bytes",
                    self._world * mine.numel() * mine.element_size())
        every = [None] * self.n_shards
        for r, shards in enumerate(self._shards_of):
            for j, s in enumerate(shards):
                row = out[r][j].to(dev)
                every[s] = (row[0], row[1].view(torch.int32))
        return every

    def _search_shard(self, s: int, x: np.ndarray, k: int, ef: int, permit):
        """Shard ``s``'s top k of every query of ``x``, as user ids on the
        merge device; (inf, -1) for a failed or empty shard."""
        merge_dev, dev = self._merge_dev, self._dev[s]
        if not self._shard_ok[s] or self._graphs[s].ntotal == 0:
            return (torch.full((len(x), k), float("inf"), device=merge_dev),
                    torch.full((len(x), k), -1, dtype=torch.int32,
                               device=merge_dev))
        gids = self._global_ids[s]
        allowed = None
        if permit is not None:
            p = torch.from_numpy(permit).to(dev)
            allowed = (gids >= 0) & p[gids.clamp(min=0).long()]
        d, i = hnsw_search(
            self._graphs[s], self._storage[s], torch.from_numpy(x).to(dev),
            k=k, ef_search=ef, metric=self.config.metric,
            max_level_cap=self.config.max_level_cap, allowed=allowed,
            packed=None if self._packed is None else self._packed[s])
        i = torch.where(i >= 0, gids[i.clamp(min=0).long()], -1)
        return d.to(merge_dev), i.to(merge_dev)

    # --------------------------------------- failure detection / elasticity
    @property
    def failed_shards(self) -> list[int]:
        return [int(s) for s in np.flatnonzero(~self._shard_ok)]

    def mark_shard_failed(self, s: int) -> None:
        """Operator-declared failure: shard ``s`` leaves the merge at once."""
        self._shard_ok[s] = False

    def mark_shard_ok(self, s: int) -> None:
        self._shard_ok[s] = True

    def health_check(self, *, auto_mark: bool = True) -> list[dict]:
        """Per-shard liveness: host scalar sanity (entry point in range,
        levels against the count) and a self-query of the shard's first
        live row through the search (k=1, ef=8): a corrupt graph or NaN
        rows fail to return it at a finite distance. One dict per shard;
        with ``auto_mark`` failing shards leave the merge. Across
        processes each rank probes its own shards and every rank gets
        every report."""
        mine = []
        for s in self._local:
            g = self._graphs[s]
            errors, cnt = [], g.ntotal
            if cnt > 0:
                if not 0 <= g.entry_point < cnt:
                    errors.append(f"entry_point {g.entry_point} outside "
                                  f"[0, {cnt})")
                if g.max_level < 0:
                    errors.append("max_level < 0 with live points")
                hit, d = self._probe(s)
                if not hit:
                    errors.append(f"self-query probe missed (d={d:.3g})")
            if cnt > self.config.capacity:
                errors.append("count exceeds capacity")
            mine.append({"shard": s, "ok": not errors, "count": cnt,
                         "errors": errors})
        out = sorted((r for rs in self._gather_objects(mine) for r in rs),
                     key=lambda r: r["shard"])
        for r in out:
            if auto_mark and not r["ok"]:
                self._shard_ok[r["shard"]] = False
        return out

    def _probe(self, s: int) -> tuple[bool, float]:
        """Shard ``s`` searched for its own first live local row (decoded
        for sq8): (found first at a finite distance, that distance). The
        reference probes row 0 even once ``vacuum()`` has cut it out of
        the graph, and so fails a healthy shard whose row 0 was removed; a
        shard with no live row has nothing to find and passes."""
        row = 0
        if self._removed is not None:
            gids = self._global_ids[s][:self._graphs[s].ntotal].cpu().numpy()
            live = np.flatnonzero(~self._removed[gids])
            if live.size == 0:
                return True, 0.0
            row = int(live[0])
        st = self._storage[s]
        q = st.decode(st.rows[row:row + 1])
        d, i = hnsw_search(self._graphs[s], st, q, k=1, ef_search=8,
                           metric=self.config.metric,
                           max_level_cap=self.config.max_level_cap)
        d0 = float(d[0, 0])
        return int(i[0, 0]) == row and bool(np.isfinite(d0)), d0

    def restore_shards(self, path, shards: list[int] | None = None):
        """Reload the given shards (default: every failed one) from a
        ``save()`` checkpoint, leaving the other shards as they are, and
        return them to the merge. The checkpoint must hold this index's
        config and shard count. Across processes each rank reloads its own
        shards of the list."""
        shards = self.failed_shards if shards is None else list(shards)
        if not shards:
            return []
        with np.load(path, allow_pickle=False) as z:
            cfg = HnswConfig.from_json(bytes(z["config_json"].item()).decode())
            if cfg.to_json() != self.config.to_json():
                raise ValueError("checkpoint config differs from live index")
            if len(z["counts"]) != self.n_shards:
                raise ValueError(f"checkpoint has {len(z['counts'])} shards; "
                                 f"index has {self.n_shards}")
            states = json.loads(bytes(z["rng_states"].item()).decode())
            for s in shards:
                if self._is_local(s):
                    self._load_shard(z, s)
                self._builders[s].rng.bit_generator.state = states[s]
                self._shard_ok[s] = True
        return shards

    def _load_shard(self, z, s: int) -> None:
        """Shard ``s``'s graph, rows, user ids and scalars from an open
        sharded ``.npz`` (the host keys ``entry`` / ``max_level`` /
        ``n_upper`` and ``counts`` give the scalars, as the reference's
        flush after a load does)."""
        dev = self._dev[s]
        self._graphs[s] = GraphArrays(
            **{f: torch.tensor(z[f"graph_{f}"][s], dtype=torch.int32,
                               device=dev) for f in TENSOR_FIELDS},
            entry_point=int(z["entry"][s]), max_level=int(z["max_level"][s]),
            ntotal=int(z["counts"][s]), n_upper=int(z["n_upper"][s]))
        self._storage[s] = Storage.load(z["vectors"][s], self.config, dev,
                                        self._codec.codec_arrays())
        self._global_ids[s] = torch.tensor(z["global_ids"][s],
                                           dtype=torch.int32, device=dev)

    # ------------------------------------------------- deletion / filtering
    @property
    def n_deleted(self) -> int:
        return 0 if self._removed is None else \
            int(self._removed[:self._ntotal].sum())

    def remove_ids(self, ids) -> int:
        """Tombstone USER ids: they leave the results at once and keep
        routing until ``vacuum()``; ids never renumber. Returns how many
        were newly removed."""
        ids = np.asarray(ids).reshape(-1)
        if ((ids < 0) | (ids >= self._ntotal)).any():
            raise IndexError("remove_ids: id out of range")
        if self._removed is None:
            self._removed = np.zeros(self.n_shards * self.config.capacity,
                                     bool)
        before = int(self._removed.sum())
        self._removed[ids] = True
        self._routing_clean = False
        return int(self._removed.sum()) - before

    def vacuum(self) -> int:
        """Remove tombstoned ids from every shard's routing
        (``ops/vacuum.py``, shard by shard): links into dead nodes are
        re-pruned away, dead rows cleared, each shard's entry point moved
        to a live node. Searches then skip the tombstone filter; packed
        tables are dropped. Returns the number of nodes vacuumed. Across
        processes each rank vacuums its own shards."""
        if self._removed is None or self.n_deleted == 0:
            self._routing_clean = True
            return 0
        from ..ops.vacuum import live_entry_point, vacuum_level0, vacuum_upper
        n_dead, metric = self.n_deleted, self.config.metric
        self._packed = None          # rows hold the pre-vacuum adjacency
        for s in self._local:
            g = self._graphs[s]
            gids, st = self._global_ids[s], self._storage[s]
            removed = torch.from_numpy(self._removed).to(self._dev[s])
            dead = (gids >= 0) & removed[gids.clamp(min=0).long()]
            vacuum_level0(g.neighbors0, st, dead, metric=metric)
            vacuum_upper(g.upper_neighbors, g.upper_node, g.upper_slot, st,
                         dead, metric=metric)
            g.entry_point, g.max_level = live_entry_point(g.levels, dead)
        self._routing_clean = True
        return n_dead

    def _normalize_allowed(self, allowed) -> np.ndarray:
        """A user-id filter -> bool mask over [S * capacity_per_shard]: a
        bool mask (1-d, at most that long) or an int id list (numpy
        indexing: a negative id counts from the end, any other id out of
        range raises), as numpy or as a tensor."""
        u_cap = self.n_shards * self.config.capacity
        if isinstance(allowed, torch.Tensor):
            allowed = allowed.cpu().numpy()
        a = np.asarray(allowed)
        mask = np.zeros(u_cap, np.bool_)
        if a.dtype == np.bool_:
            if a.ndim != 1 or len(a) > u_cap:
                raise ValueError(f"allowed bool mask must be 1-d with length "
                                 f"<= {u_cap}, got shape {a.shape}")
            mask[:len(a)] = a
        elif np.issubdtype(a.dtype, np.integer):
            mask[a.reshape(-1)] = True
        else:
            raise TypeError(f"allowed: expected bool mask or int id list, "
                            f"got dtype {a.dtype}")
        return mask

    # -------------------------------------------------------- persistence
    def save(self, path) -> None:
        """One ``.npz`` with the per-shard arrays stacked on a leading
        shard axis, the config and the host state (the reference's keys):
        loadable by either package onto a mesh of the same shard count.
        bf16 vectors are widened to f32 (exact), as ``HnswIndex.save``.
        One process only: across processes this raises, as the
        reference's does."""
        if self._world > 1:
            raise RuntimeError("ShardedHnswIndex.save() has no multi-process "
                               "form: the reference's fetches arrays that "
                               "span other processes' devices, which JAX "
                               "refuses")
        gs = self._graphs
        arrs = {f"graph_{f}": np.stack([getattr(g, f).cpu().numpy()
                                        for g in gs]) for f in TENSOR_FIELDS}
        arrs.update({f"graph_{f}": np.array([getattr(g, f) for g in gs],
                                            np.int32) for f in SCALAR_FIELDS})
        vectors = np.stack([(st.rows.float() if st.rows.dtype == torch.bfloat16
                             else st.rows).cpu().numpy()
                            for st in self._storage])
        i64 = np.int64
        np.savez_compressed(
            path, vectors=vectors,
            global_ids=np.stack([t.cpu().numpy() for t in self._global_ids]),
            counts=self._counts, ntotal=i64(self._ntotal),
            entry=np.array([g.entry_point for g in gs], i64),
            max_level=np.array([g.max_level for g in gs], i64),
            n_upper=np.array([g.n_upper for g in gs], i64),
            rng_states=np.bytes_(json.dumps(
                [jsonify(b.rng.bit_generator.state)
                 for b in self._builders]).encode()),
            removed=(self._removed if self._removed is not None
                     else np.zeros(0, bool)),
            routing_clean=np.bool_(self._routing_clean),
            shard_ok=self._shard_ok,
            config_json=np.bytes_(self.config.to_json()),
            **self._codec.codec_arrays(), **arrs)

    @classmethod
    def load(cls, path, *, mesh: Mesh | None = None) -> "ShardedHnswIndex":
        """Load a sharded ``.npz`` written by either package onto ``mesh``
        (by default every CUDA device), which must have the saved shard
        count. The level generators carry over, so further adds draw what
        the writer's would; tombstones saved before ``vacuum()`` keep
        filtering. On a mesh across processes every rank loads the same
        file and keeps its own shards."""
        with np.load(path, allow_pickle=False) as z:
            cfg = HnswConfig.from_json(bytes(z["config_json"].item()).decode())
            idx = cls(config=cfg, mesh=mesh)
            if idx.n_shards != len(z["counts"]):
                raise ValueError(f"index was saved with {len(z['counts'])} "
                                 f"shards; mesh has {idx.n_shards}")
            idx._codec.set_codec(z)
            for s in range(idx.n_shards):
                if idx._is_local(s):
                    idx._load_shard(z, s)
                else:
                    g = idx._graphs[s]
                    g.entry_point, g.max_level = (int(z["entry"][s]),
                                                  int(z["max_level"][s]))
                    g.ntotal, g.n_upper = (int(z["counts"][s]),
                                           int(z["n_upper"][s]))
            idx._ntotal = int(z["ntotal"])
            states = json.loads(bytes(z["rng_states"].item()).decode())
            for b, st in zip(idx._builders, states):
                b.rng.bit_generator.state = st
            if "removed" in z.files and z["removed"].size:
                idx._removed = z["removed"].copy()
                idx._routing_clean = bool(z["routing_clean"]) \
                    if "routing_clean" in z.files else False
            if "shard_ok" in z.files:
                idx._shard_ok = z["shard_ok"].copy()
        return idx

    def check(self, strict: bool = True) -> list[dict]:
        """Per-shard structural invariants (``check_invariants``), one dict
        a shard in shard order; tombstoned ids are exempt from the liveness
        invariants. Across processes each rank checks its own shards and
        every rank gets every report."""
        mine = []
        for s in self._local:
            alive = None
            if self._removed is not None:
                gs = self._global_ids[s].cpu().numpy()
                alive = ~((gs >= 0) & self._removed[np.maximum(gs, 0)])
            mine.append((s, check_invariants(self._graphs[s], self.config,
                                             strict=strict, alive=alive)))
        return [st for _, st in sorted(
            (p for ps in self._gather_objects(mine) for p in ps),
            key=lambda p: p[0])]


def merge_topk(dists: list, ids: list, k: int):
    """The global top k of per-shard results: [Q, k] tensors on one
    device, laid side by side shard-major ([Q, S * k]) and sorted stably,
    so tied distances keep the lower shard first (the reference's
    ``top_k`` order). Returns (D [Q, k] f32, I [Q, k] int32)."""
    d, i = torch.cat(dists, 1), torch.cat(ids, 1)
    d_sorted, order = torch.sort(d, dim=1, stable=True)
    return d_sorted[:, :k], torch.gather(i, 1, order[:, :k])
