"""On-device batched HNSW construction, ported from ``hnsw_tpu.build``.

faiss inserts one point at a time (greedy descent, beam search per level at
efConstruction, heuristic prune to M, links and locked back-links). Here a
batch of B points is inserted at once:

  1. storage writes (vectors, or their sq8 / PQ codes, through the index's
     ``ops/storage.Storage``; levels, upper-slot maps);
  2. batched greedy descent to each point's level (shared with search);
  3. per upper level, top down: beam search at efConstruction, the
     select-neighbors prune, forward links, back-links (``ops/repair.py``);
  4. level 0 likewise, with the batch's own brute-force nearest neighbors
     (one [B, B] product) merged into the candidates, since batch members
     cannot find each other in the pre-batch graph.

The host draws the levels from ``np.random.default_rng(cfg.seed)`` (the
same draw as the reference), plans the whole schedule of an ``add()``
(batch sizes that grow with the graph, each batch sorted by level) and
stages it on the device once, as the reference's ``_insert_batch_staged``
does: the vectors, ids, levels and upper slots in batch order, padded past
the end (pad id = capacity, level -1, slot -1), and per batch its offset,
its live row count and the graph's entry point and max level before it.
So every batch has a static shape: ``size`` rows, of which those past the
live count are masked pads, and the upper levels run on the first
``upper_batch_cap(size, m)`` rows, masked per level. A batch finds its row
of the schedule through a cursor on the device that it advances.

An insert batch is one device program (``graphs.py``). On a CUDA device
each batch profile (``_Profile``: size, upper levels run, level>=1 points
or not, descent or not) is captured as a CUDA graph and replayed for the
later batches of the profile: the counterpart of the reference's
``_get_step`` / ``_get_scan`` executables. A profile's first batch runs
eagerly and is the real insert; the capture after it only records. Inside
a batch the one host read is the greedy descent's condition, once every
``DESCENT_CHUNK`` steps; the back-link drop counter is read once an
``add()``. The graph tensors are updated in place.

While tracing is on (``trace.py``) an ``add()`` records its spans
(``hnsw.build.plan``, ``.step``, ``.sync``, ``.finish``) and a batch its
stages (``write``, ``descent``, ``upper``, ``beams``, ``select``,
``backlinks``; marked through its loop runner). A ``StagedBuild`` made
while tracing is on captures each profile split at the stages (another
capture key) and times the stages of its replayed batches with CUDA
events, read once, at ``finish()``.
"""

from __future__ import annotations

import collections
import logging
from typing import NamedTuple

import numpy as np
import torch

from . import graphs, trace
from .config import IP, L2, HnswConfig
from .graph import GraphArrays
from .graphs import EagerLoop
from .ops import beam as beam_ops
from .ops.prune import select_neighbors
from .ops.repair import apply_backlinks
from .ops.storage import Storage
from .search import greedy_descend

logger = logging.getLogger("hnsw_tpu_torch.build")

# greedy-descent steps between two reads of its condition: an insert
# batch's descent takes a handful of steps a level, and each read waits for
# the device to drain
DESCENT_CHUNK = 8


def upper_batch_cap(batch_size: int, m: int) -> int:
    """Most level>=1 points one batch may hold: E[#points with level>=1] =
    batch/m, with a 4x margin (the planner spills the batch tail past it)."""
    return max(32, min(batch_size, 4 * batch_size // m))


def order_batch_by_level(lv: np.ndarray, n0: int):
    """Stable level-descending permutation of a batch, so the points of each
    upper level are a prefix. Ids stay insertion order: position j carries
    id n0 + original index."""
    perm = np.argsort(-lv, kind="stable")
    ids = (n0 + np.arange(len(lv), dtype=np.int32))[perm]
    return perm, ids


class _Profile(NamedTuple):
    """What an insert batch's program is made from besides its tensors:
    the padded size, the upper levels it runs (its top level, capped by
    the graph's max level before it), whether it holds level>=1 points,
    and whether it descends (the graph has an upper level)."""
    size: int
    n_levels: int
    has_up: bool
    descend: bool


def _insert_batch(graph: GraphArrays, storage: Storage,
                  xb: torch.Tensor, ids: torch.Tensor, levels: torch.Tensor,
                  slots: torch.Tensor, entry_point: torch.Tensor,
                  max_level: torch.Tensor, prof: _Profile, *,
                  cfg: HnswConfig, ef_construction: int, intra_k: int,
                  r_window: int, n_expand: int = 4, hop_cap: int = 0,
                  loop=None) -> torch.Tensor:
    """Insert one padded batch into ``graph``/``storage`` in place.

    xb f32 [B, d]; ids, levels, slots int32 [B], level-sorted, with pad
    rows (id = capacity, level -1, slot -1) anywhere after row 0, which is
    live. entry_point, max_level: the graph's scalars before the batch, 0-d
    tensors; ``prof`` must agree with them and the levels. A pad row writes
    what row 0 writes, so every written row has one value. With an sq8 or
    PQ codec, xb holds x̂ (``HnswIndex`` encodes at the API boundary), the
    write encodes it back to the same codes, and every read of a stored
    row decodes it, so each build distance is exact over x̂. ``loop`` runs
    the descent and marks the stages (``graphs.EagerLoop`` or a capture).
    Returns the back-link window drops (int64 0-d tensor)."""
    loop = loop or EagerLoop(DESCENT_CHUNK)
    loop.phase("write")
    b = xb.shape[0]
    dev = xb.device
    metric = cfg.metric
    efc = ef_construction
    xf = xb.float()
    valid = levels >= 0
    pos = torch.arange(b, device=dev)
    src = torch.where(valid, pos, 0)          # the row a row's writes take
    w_ids = ids[src].long()

    # ---- 1. storage writes (adjacency untouched: the beams below see the
    # pre-batch graph)
    storage.write(w_ids, xf[src])
    graph.levels[w_ids] = levels[src]
    graph.upper_slot[w_ids] = slots[src]
    b_up = upper_batch_cap(b, cfg.m)
    if prof.has_up:      # row 0 has the batch's top level, so a slot
        up = torch.where(slots[:b_up] >= 0, pos[:b_up], 0)
        graph.upper_node[slots[up].long()] = ids[up]

    def read_rows(node_ids):  # stored rows -> f32 x̂
        return storage.read(node_ids.clamp(min=0).long())

    distance_to = storage.distance_fn(xf, metric)
    qsq = (xf * xf).sum(1, keepdim=True)   # surrogate -> true L2

    def to_true(d):
        return d + qsq[:d.shape[0]] if metric == L2 else d

    # ---- 2. greedy descent to each point's level (pad rows stay put)
    loop.phase("descent")
    ep = entry_point.to(torch.int32).expand(b).contiguous()
    ep_d = distance_to(ep[:, None], torch.ones_like(ep[:, None],
                                                    dtype=torch.bool))[:, 0]
    e, e_d = ep, ep_d
    if prof.descend:
        top = max_level.clamp(min=0).to(torch.int32)
        to_level = torch.where(valid, torch.minimum(levels.clamp(min=0), top),
                               cfg.max_level_cap)
        e, e_d = greedy_descend(graph, distance_to, ep, ep_d, to_level,
                                cfg.max_level_cap, max_level=max_level,
                                loop=loop)

    # insert beams stop at a hop cap: 0 = auto (~efc / (2 n_expand) + 12
    # hops), > 0 = explicit, < 0 = enough hops to converge
    if hop_cap == 0:
        max_hops = max(16, (efc // max(n_expand, 1)) // 2 + 12)
    elif hop_cap > 0:
        max_hops = hop_cap
    else:
        max_hops = 4 * efc + 16
    drops = torch.zeros((), dtype=torch.int64, device=dev)

    # ---- 3. upper levels, top down, on the first b_up rows; the rows
    # taking part at `level` are those with level >= it
    if prof.n_levels:
        loop.phase("upper")
        lv_up, slots_up, ids_up = levels[:b_up], slots[:b_up], ids[:b_up]
        e_up, ed_up = e[:b_up], e_d[:b_up]
        dist_up = storage.distance_fn(xf[:b_up], metric)
        for level in range(prof.n_levels, 0, -1):
            active = lv_up >= level        # row 0 always (its top level)
            adj_l = graph.upper_neighbors[:, level - 1]          # view [U, m]

            def gather_upper(node_ids, adj_l=adj_l):
                return adj_l[graph.upper_slot[node_ids].clamp(min=0)]

            state = beam_ops.init_beam(e_up, ed_up, efc, active=active)
            state = beam_ops.beam_search(state, gather_upper, dist_up,
                                         max_hops=max_hops,
                                         n_expand=n_expand)
            buf_ids, buf_d = beam_ops.dedup_sorted_buffer(state.buf_ids,
                                                          state.buf_dist)
            cand_ids = torch.where(active[:, None], buf_ids, -1)
            kept, _ = select_neighbors(
                cand_ids, to_true(buf_d), read_rows(cand_ids),
                m=cfg.m, metric=metric)
            act = torch.where(active, pos[:b_up], 0)             # forward
            adj_l[slots_up[act].long()] = kept[act]              # links
            dst = kept.reshape(-1)
            src_ids = ids_up[:, None].expand_as(kept).reshape(-1)
            pair_ok = (dst >= 0) & active[:, None].expand_as(kept).reshape(-1)
            dst_rows = torch.where(pair_ok,
                                   graph.upper_slot[dst.clamp(min=0)], -1)
            _, nd = apply_backlinks(adj_l, dst_rows.clamp(min=0), dst,
                                    src_ids, pair_ok & (dst_rows >= 0),
                                    storage, r_window=r_window,
                                    metric=metric)
            drops = drops + nd
            # the next level starts from the nearest node found at this one
            e_up = torch.where(active, buf_ids[:, 0], e_up)
            ed_up = torch.where(active, buf_d[:, 0], ed_up)
        e = torch.cat([e_up, e[b_up:]])
        e_d = torch.cat([ed_up, e_d[b_up:]])

    # ---- 4. level 0
    loop.phase("beams")
    neighbors0 = graph.neighbors0
    state = beam_ops.init_beam(e, e_d, efc, active=valid)
    state = beam_ops.beam_search(state, lambda node_ids: neighbors0[node_ids],
                                 distance_to, max_hops=max_hops,
                                 n_expand=n_expand)

    # the batch's own nearest neighbors: invisible in the pre-batch graph
    t = min(intra_k, b)
    dots = xf @ xf.T
    intra = -dots if metric == IP else (xf * xf).sum(1)[None, :] - 2.0 * dots
    ok = valid[None, :] & valid[:, None] & (pos[None, :] != pos[:, None])
    intra = torch.where(ok, intra, float("inf"))
    intra_d, near = torch.topk(intra, t, dim=1, largest=False, sorted=True)
    intra_ids = torch.where(torch.isinf(intra_d), -1, ids[near])

    loop.phase("select")
    buf_ids, buf_d = beam_ops.dedup_sorted_buffer(state.buf_ids,
                                                  state.buf_dist)
    cand_ids = torch.cat([torch.where(valid[:, None], buf_ids, -1),
                          intra_ids], 1)
    cand_true = torch.cat([to_true(buf_d), to_true(intra_d)], 1)
    # faiss parity: M forward links at level 0 (m0 = 2M is back-link room)
    kept0, _ = select_neighbors(cand_ids, cand_true, read_rows(cand_ids),
                                m=cfg.m, metric=metric)
    row = torch.full((b, cfg.m0), -1, dtype=torch.int32, device=dev)
    row[:, :cfg.m] = kept0
    neighbors0[w_ids] = row[src]
    loop.phase("backlinks")
    dst = kept0.reshape(-1)
    src_ids = ids[:, None].expand_as(kept0).reshape(-1)
    pair_ok = (dst >= 0) & valid[:, None].expand_as(kept0).reshape(-1)
    _, nd = apply_backlinks(neighbors0, dst.clamp(min=0), dst, src_ids,
                            pair_ok, storage, r_window=r_window,
                            metric=metric)
    return drops + nd


class Plan(NamedTuple):
    """An add()'s insert schedule on the host: the arrays in batch order
    (level-sorted within each batch), padded past the last batch by its
    size (pad id = capacity, level -1, slot -1), and per batch (offset,
    take, size)."""
    xs: np.ndarray      # f32 [n_staged, d]
    ids: np.ndarray     # int32 [n_staged]
    lv: np.ndarray      # int32 [n_staged]
    sl: np.ndarray      # int32 [n_staged]
    batches: list


def stage_plan(parts: list, d: int, capacity: int) -> Plan:
    """Concatenate per-batch parts (x, ids, levels, slots, size), each in
    batch order, into a ``Plan``."""
    n = sum(len(p[1]) for p in parts)
    n_staged = n + max((p[4] for p in parts), default=0)
    xs = np.zeros((n_staged, d), np.float32)
    ids = np.full((n_staged,), capacity, np.int32)
    lv = np.full((n_staged,), -1, np.int32)
    sl = np.full((n_staged,), -1, np.int32)
    batches, off = [], 0
    for x, pid, lev, slot, size in parts:
        take = len(pid)
        xs[off:off + take], ids[off:off + take] = x, pid
        lv[off:off + take], sl[off:off + take] = lev, slot
        batches.append((off, take, size))
        off += take
    return Plan(xs, ids, lv, sl, batches)


def _schedule(plan: Plan, entry_point: int, max_level: int):
    """The graph's scalars before each batch of ``plan``, as the device
    would compute them (the batch's first row has its top level), and each
    batch's profile. Returns (sched int64 [n_batches, 4] of (offset, take,
    entry point, max level), profiles, entry point after, max level
    after)."""
    rows, profiles = [], []
    for off, take, size in plan.batches:
        top = int(plan.lv[off])
        profiles.append(_Profile(size, min(top, max_level), top >= 1,
                                 max_level >= 1))
        rows.append((off, take, entry_point, max_level))
        if top > max_level:
            entry_point, max_level = int(plan.ids[off]), top
    return (np.asarray(rows, np.int64).reshape(-1, 4), profiles,
            entry_point, max_level)


class StagedBuild:
    """One add()'s insert batches into one graph: the ``Plan`` and its
    schedule staged on the device once, ``step()`` to insert the next
    batch (replayed from its profile's capture on a CUDA device) and
    ``finish()`` once every batch ran. Made while tracing is on
    (``traced``), it splits its captures at the stages and times the
    stages of its replayed batches."""

    def __init__(self, graph: GraphArrays, storage: Storage, plan: Plan, *,
                 cfg: HnswConfig, ef_construction: int, intra_k: int,
                 r_window: int, n_expand: int, hop_cap: int):
        self.dev = dev = storage.rows.device
        sched, profiles, *self.after = _schedule(plan, graph.entry_point,
                                                  graph.max_level)
        self.graph, self.storage, self.profiles = graph, storage, profiles
        self.left = collections.Counter(profiles)
        self.next = 0
        # what ran ("replayed", "eager", "captured") and the captures' ms
        self.ran = collections.Counter()
        self.capture_ms: list = []
        self.traced = trace.enabled()
        self.timed: list = []          # the replayed batches' trace.Phases

        def put(a):                        # one host-to-device copy each
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.xs, self.ids, self.lv, self.sl = (put(a) for a in plan[:4])
        self.sched = put(sched)
        self.cursor = torch.zeros((), dtype=torch.int64, device=dev)
        self.drops = torch.zeros((), dtype=torch.int64, device=dev)
        self.kw = dict(cfg=cfg, ef_construction=ef_construction,
                       intra_k=intra_k, r_window=r_window, n_expand=n_expand,
                       hop_cap=hop_cap)
        self.refs = [graph.neighbors0, graph.levels, graph.upper_slot,
                     graph.upper_node, graph.upper_neighbors,
                     *storage.refs(), self.xs, self.ids, self.lv, self.sl,
                     self.sched, self.cursor, self.drops]
        self.key = (cfg, ef_construction, intra_k, r_window, n_expand,
                    hop_cap, DESCENT_CHUNK, self.traced,
                    tuple(graphs.tensor_identity(t) for t in self.refs))

    def _body(self, prof: _Profile, loop) -> None:
        """The batch at the cursor: the counterpart of the reference's
        ``_insert_batch_staged`` (its scalars come from the schedule)."""
        row = self.sched.index_select(0, self.cursor.view(1))[0]
        pos = torch.arange(prof.size, device=row.device)
        idx = row[0] + pos
        live = pos < row[1]
        capacity = self.graph.levels.shape[0]
        ids = torch.where(live, self.ids.index_select(0, idx), capacity)
        levels = torch.where(live, self.lv.index_select(0, idx), -1)
        slots = torch.where(live, self.sl.index_select(0, idx), -1)
        nd = _insert_batch(self.graph, self.storage,
                           self.xs.index_select(0, idx), ids, levels, slots,
                           row[2], row[3], prof, loop=loop, **self.kw)
        self.drops.add_(nd)
        self.cursor.add_(1)

    def step(self) -> None:
        """Insert the next batch of the plan."""
        prof = self.profiles[self.next]
        self.next += 1
        self.left[prof] -= 1
        with trace.span("hnsw.build.step"), \
                trace.Phases("hnsw.build", self.dev, self.traced) as ph:
            if not graphs.capturing_enabled(self.dev):
                with trace.span("hnsw.build.eager"):
                    self._body(prof, EagerLoop(DESCENT_CHUNK, ph))
                    ph.stop()
                self.ran["eager"] += 1
                return
            ran, entry = graphs.insert_or_replay(
                (prof, self.key), self.refs,
                lambda _inputs, loop: self._body(prof, loop),
                chunk=DESCENT_CHUNK, keep=self.left[prof] > 0,
                split=self.traced, phases=ph)
        self.ran[ran] += 1
        if ran == "captured":
            self.capture_ms.append(entry.capture_ms)
        elif ran == "replayed" and self.traced:
            self.timed.append(ph)

    def sync(self) -> None:
        """Wait for the batches issued so far (bounds the host's run-ahead
        on a CUDA device)."""
        if self.dev.type == "cuda":
            with trace.span("hnsw.build.sync"):
                torch.cuda.current_stream(self.dev).synchronize()

    def finish(self) -> int:
        """After the last batch: moves the graph's entry point and max
        level on, and returns the back-link pairs the batches dropped,
        with the batches counted on the device (one read, after which the
        replayed batches' stage times are added to the trace). Raises
        unless every batch ran once."""
        done, drops = graphs.host_read(torch.stack([self.cursor,
                                                    self.drops]))
        if done != len(self.profiles) or self.next != done:
            raise RuntimeError(f"staged build: {done} of "
                               f"{len(self.profiles)} batches ran")
        for ph in self.timed:
            trace.add_device("hnsw.build", ph.ms())
        self.graph.entry_point, self.graph.max_level = self.after
        return int(drops)

    def stats(self) -> dict:
        """Batches, what ran them, the profiles (capture keys) and the
        capture ms of this run."""
        return {"batches": self.next, "profiles": len(self.left),
                **dict(self.ran), "capture_ms": list(self.capture_ms)}


class DeviceBuilder:
    """Host orchestration of the batched build: the seeded level draw and
    the batch schedule. Deterministic given the seed."""

    BATCH_SIZES = (32, 128, 512, 1024)
    # full-size batches issued back to back between two syncs (the
    # reference's lax.scan chunk); other batches sync every STEP_SYNC
    SCAN_CHUNK = 32
    STEP_SYNC = 16

    def __init__(self, cfg: HnswConfig, *, max_batch: int = 2048,
                 intra_k: int = 32, r_window: int = 16, n_expand: int = 4,
                 hop_cap: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.max_batch = max_batch
        self.intra_k = intra_k
        self.r_window = r_window
        self.n_expand = n_expand
        self.hop_cap = hop_cap
        # back-link pairs beyond the repair window, lost by the last add()
        self.last_backlink_dropped = 0
        self.last_stats: dict = {}    # the last add()'s StagedBuild.stats()

    @property
    def _sizes(self) -> tuple:
        sizes = [s for s in self.BATCH_SIZES if s <= self.max_batch]
        if not sizes:
            sizes = [self.max_batch]
        if self.max_batch > sizes[-1]:
            sizes.append(self.max_batch)
        return tuple(sizes)

    def _draw_levels(self, n: int) -> np.ndarray:
        u = self.rng.random(n)
        lv = np.floor(-np.log(np.maximum(u, 1e-12)) *
                      self.cfg.level_mult).astype(np.int32)
        return np.minimum(lv, self.cfg.max_level_cap)

    def _seed_first(self, graph: GraphArrays, storage: Storage,
                    x0: np.ndarray, level: int) -> None:
        """Insert the very first point (x̂0 for a codec): no search
        needed."""
        storage.write(slice(0, 1), torch.from_numpy(x0).to(
            storage.rows.device)[None])
        graph.levels[0] = level
        if level >= 1:
            graph.upper_slot[0] = 0
            graph.upper_node[0] = 0
            graph.n_upper = 1
        graph.entry_point, graph.max_level, graph.ntotal = 0, level, 1

    def _plan(self, n0: int, n_upper: int, x: np.ndarray,
              all_levels: np.ndarray) -> Plan:
        """The whole insert schedule on the host. A batch never exceeds
        the current graph's size class."""
        cfg = self.cfg
        n = len(x)
        parts = []
        i = 0
        while i < n:
            sizes = self._sizes
            size = max(s for s in sizes if s <= max(n0, sizes[0]))
            take = min(n - i, size)
            lv = all_levels[i:i + take]
            # keep the batch's level>=1 points within upper_batch_cap
            n_ups = np.cumsum(lv >= 1)
            cap_up = upper_batch_cap(size, cfg.m)
            if take and n_ups[take - 1] > cap_up:
                take = int(np.searchsorted(n_ups, cap_up, side="right"))
                lv = lv[:take]
            perm, pids = order_batch_by_level(lv, n0)
            lv_b = lv[perm]
            ups = np.flatnonzero(lv_b >= 1)
            if n_upper + len(ups) > cfg.upper_capacity:
                raise ValueError("upper_capacity exceeded; raise it in "
                                 "HnswConfig")
            sl_b = np.full((take,), -1, np.int32)
            sl_b[ups] = np.arange(n_upper, n_upper + len(ups),
                                  dtype=np.int32)
            parts.append((x[i:i + take][perm], pids, lv_b, sl_b, size))
            n_upper += len(ups)
            n0 += take
            i += take
        return stage_plan(parts, x.shape[1], cfg.capacity)

    def staged(self, graph: GraphArrays, storage: Storage, plan: Plan,
               ef_construction: int) -> StagedBuild:
        """``plan`` staged on the storage's device against ``graph``."""
        return StagedBuild(
            graph, storage, plan, cfg=self.cfg,
            ef_construction=ef_construction, intra_k=self.intra_k,
            r_window=self.r_window, n_expand=self.n_expand,
            hop_cap=self.hop_cap)

    def add(self, graph: GraphArrays, storage: Storage, x: np.ndarray,
            *, ef_construction: int | None = None) -> None:
        """Insert ``x`` (f32 [n, d], host; x̂ for a codec) with ids
        ntotal.. in place."""
        cfg = self.cfg
        efc = int(ef_construction or cfg.ef_construction)
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        with trace.span("hnsw.build.plan"):
            all_levels = self._draw_levels(len(x))
            i = 0
            if graph.ntotal == 0 and len(x):
                self._seed_first(graph, storage, x[0], int(all_levels[0]))
                i = 1
            plan = self._plan(graph.ntotal, graph.n_upper, x[i:],
                              all_levels[i:])
            if not plan.batches:
                return
            run = self.staged(graph, storage, plan, efc)
        batches = plan.batches
        bi = 0
        while bi < len(batches):
            chunk = batches[bi:bi + self.SCAN_CHUNK]
            if len(chunk) == self.SCAN_CHUNK and all(
                    take == size == self.max_batch for _, take, size in chunk):
                for _ in chunk:           # the reference's lax.scan chunk
                    run.step()
                bi += self.SCAN_CHUNK
                run.sync()
            else:
                run.step()
                bi += 1
                if bi % self.STEP_SYNC == 0:
                    run.sync()
        with trace.span("hnsw.build.finish"):
            self.last_backlink_dropped = run.finish()
            graph.ntotal += sum(take for _, take, _ in batches)
            graph.n_upper += int((plan.sl >= 0).sum())
            self.last_stats = run.stats()
            del run             # frees the staged plan and its captures
            graphs._purge()
        if self.last_backlink_dropped:
            logger.info(
                "back-link repair: %d pairs beyond the r_window=%d cap were "
                "dropped this add() (%.4f%% of ~%d forward links)",
                self.last_backlink_dropped, self.r_window,
                100.0 * self.last_backlink_dropped / max(len(x) * cfg.m, 1),
                len(x) * cfg.m)
