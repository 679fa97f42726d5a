"""On-device batched HNSW construction, ported from ``hnsw_tpu.build``.

faiss inserts one point at a time (greedy descent, beam search per level at
efConstruction, heuristic prune to M, links and locked back-links). Here a
batch of B points is inserted at once:

  1. storage writes (vectors, or their sq8 / PQ codes; levels, upper-slot
     maps);
  2. batched greedy descent to each point's level (shared with search);
  3. per upper level, top down: beam search at efConstruction, the
     select-neighbors prune, forward links, back-links (``ops/repair.py``);
  4. level 0 likewise, with the batch's own brute-force nearest neighbors
     (one [B, B] product) merged into the candidates, since batch members
     cannot find each other in the pre-batch graph.

The host draws the levels from ``np.random.default_rng(cfg.seed)`` (the
same draw as the reference), plans batch sizes that grow with the graph,
and keeps the graph's scalars (entry point, max level, counts). Which batch
rows take part at each upper level is known on the host from the drawn
levels, so no device value is read to decide it. The graph tensors are
updated in place.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .config import IP, L2, HnswConfig
from .graph import GraphArrays
from .graphs import EagerLoop
from .ops import beam as beam_ops
from .ops.distances import decode_rows
from .ops.packed import quantize_codes
from .ops.pq import encode_pq
from .ops.prune import select_neighbors
from .ops.repair import apply_backlinks
from .search import _make_distance_fn, greedy_descend

logger = logging.getLogger("hnsw_tpu_torch.build")


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


def _insert_batch(graph: GraphArrays, vectors: torch.Tensor,
                  xb: torch.Tensor, ids: torch.Tensor, levels: torch.Tensor,
                  slots: torch.Tensor, lv_host: np.ndarray, *,
                  cfg: HnswConfig, ef_construction: int, intra_k: int,
                  r_window: int, n_expand: int = 4, hop_cap: int = 0,
                  sq_params=None, pq_cb=None) -> torch.Tensor:
    """Insert one batch into ``graph``/``vectors`` in place.

    xb f32 [B, d]; ids, levels, slots int32 [B] (slot >= 0 for level>=1
    points); lv_host: the levels on the host, sorted descending. The graph's
    scalars are the pre-batch ones; the caller updates them afterwards.
    Storage codecs: with ``sq_params`` = (offset, scale) (sq8) or ``pq_cb``
    = codebooks (PQ), xb holds x̂ (``HnswIndex`` encodes at the API
    boundary), the write encodes it back to the same codes, and every read
    of a stored row decodes it, so each build distance is exact over x̂.
    Returns the back-link window drops (int64 0-d tensor)."""
    b = xb.shape[0]
    metric = cfg.metric
    efc = ef_construction
    xf = xb.float()
    ids_l = ids.long()

    # ---- 1. storage writes (adjacency untouched: the beams below see the
    # pre-batch graph)
    vectors[ids_l] = _encode_rows(xf, vectors.dtype, sq_params, pq_cb)
    graph.levels[ids_l] = levels
    graph.upper_slot[ids_l] = slots
    n_up = int((lv_host >= 1).sum())
    if n_up:
        graph.upper_node[slots[:n_up].long()] = ids[:n_up]

    def read_rows(node_ids):  # stored rows -> f32 vectors (x̂ for codecs)
        return decode_rows(vectors[node_ids.clamp(min=0).long()], sq_params,
                           pq_cb)

    def distance_fn(queries):
        return _make_distance_fn(vectors, queries, metric,
                                 dequant=sq_params, pq=pq_cb)

    distance_to = distance_fn(xf)
    qsq = (xf * xf).sum(1, keepdim=True)   # surrogate -> true L2

    def to_true(d):
        return d + qsq[:d.shape[0]] if metric == L2 else d

    # ---- 2. greedy descent to each point's level
    max_level = graph.max_level
    ep = torch.full((b,), graph.entry_point, dtype=torch.int32,
                    device=xf.device)
    ep_d = distance_to(ep[:, None], torch.ones_like(ep[:, None],
                                                    dtype=torch.bool))[:, 0]
    to_level = levels.clamp(0, max(max_level, 0))
    # one read of the level counter a step: an insert batch's descent
    # takes a few steps, and a chunk would mostly run masked ones
    e, e_d = greedy_descend(graph, distance_to, ep, ep_d, to_level,
                            cfg.max_level_cap, loop=EagerLoop(1))

    # insert beams stop at a hop cap: 0 = auto (~efc / (2 n_expand) + 12
    # hops), > 0 = explicit, < 0 = enough hops to converge
    if hop_cap == 0:
        max_hops = max(16, (efc // max(n_expand, 1)) // 2 + 12)
    elif hop_cap > 0:
        max_hops = hop_cap
    else:
        max_hops = 4 * efc + 16
    drops = torch.zeros((), dtype=torch.int64, device=xf.device)

    # ---- 3. upper levels, top down; the rows taking part at `level` are
    # the prefix of points with level >= it
    for level in range(min(cfg.max_level_cap, max_level), 0, -1):
        n_l = int((lv_host >= level).sum())
        if n_l == 0:
            continue
        adj_l = graph.upper_neighbors[:, level - 1]              # view [U, m]

        def gather_upper(node_ids, adj_l=adj_l):
            return adj_l[graph.upper_slot[node_ids].clamp(min=0)]

        state = beam_ops.init_beam(e[:n_l], e_d[:n_l], efc)
        state = beam_ops.beam_search(
            state, gather_upper, distance_fn(xf[:n_l]),
            max_hops=max_hops, n_expand=n_expand)
        cand_ids, cand_d = beam_ops.dedup_sorted_buffer(state.buf_ids,
                                                        state.buf_dist)
        kept, _ = select_neighbors(
            cand_ids, to_true(cand_d), read_rows(cand_ids),
            m=cfg.m, metric=metric)
        adj_l[slots[:n_l].long()] = kept                        # forward links
        dst = kept.reshape(-1)
        src = ids[:n_l, None].expand_as(kept).reshape(-1)
        dst_rows = torch.where(dst >= 0, graph.upper_slot[dst.clamp(min=0)],
                               -1)
        _, nd = apply_backlinks(adj_l, dst_rows.clamp(min=0), dst, src,
                                (dst >= 0) & (dst_rows >= 0), vectors,
                                sq_params, pq_cb, r_window=r_window,
                                metric=metric)
        drops += nd
        # the next level starts from the nearest node found at this one
        e[:n_l] = cand_ids[:, 0]
        e_d[:n_l] = cand_d[:, 0]

    # ---- 4. level 0
    neighbors0 = graph.neighbors0
    state = beam_ops.init_beam(e, e_d, efc)
    state = beam_ops.beam_search(state, lambda node_ids: neighbors0[node_ids],
                                 distance_to, max_hops=max_hops,
                                 n_expand=n_expand)

    # the batch's own nearest neighbors: invisible in the pre-batch graph
    t = min(intra_k, b)
    dots = xf @ xf.T
    intra = -dots if metric == IP else (xf * xf).sum(1)[None, :] - 2.0 * dots
    intra.fill_diagonal_(float("inf"))
    intra_d, pos = torch.topk(intra, t, dim=1, largest=False, sorted=True)
    intra_ids = torch.where(torch.isinf(intra_d), -1, ids[pos])

    buf_ids, buf_d = beam_ops.dedup_sorted_buffer(state.buf_ids,
                                                  state.buf_dist)
    cand_ids = torch.cat([buf_ids, intra_ids], 1)
    cand_true = torch.cat([to_true(buf_d), to_true(intra_d)], 1)
    # faiss parity: M forward links at level 0 (m0 = 2M is back-link room)
    kept0, _ = select_neighbors(cand_ids, cand_true, read_rows(cand_ids),
                                m=cfg.m, metric=metric)
    row = torch.full((b, cfg.m0), -1, dtype=torch.int32, device=xf.device)
    row[:, :cfg.m] = kept0
    neighbors0[ids_l] = row
    dst = kept0.reshape(-1)
    src = ids[:, None].expand_as(kept0).reshape(-1)
    _, nd = apply_backlinks(neighbors0, dst.clamp(min=0), dst, src, dst >= 0,
                            vectors, sq_params, pq_cb, r_window=r_window,
                            metric=metric)
    return drops + nd


def _encode_rows(x: torch.Tensor, dtype: torch.dtype, sq_params, pq_cb):
    """f32 rows (x̂ for a codec) -> what the storage holds: sq8 or PQ codes
    (the encode of x̂ gives back its own codes), else ``x`` in ``dtype``."""
    if sq_params is not None:
        return quantize_codes(x, sq_params[0], sq_params[1], 8)
    if pq_cb is not None:
        return encode_pq(x, pq_cb)
    return x.to(dtype)


class DeviceBuilder:
    """Host orchestration of the batched build: the seeded level draw and
    the batch schedule. Deterministic given the seed."""

    BATCH_SIZES = (32, 128, 512, 1024)

    def __init__(self, cfg: HnswConfig, *, max_batch: int = 2048,
                 intra_k: int = 32, r_window: int = 16, n_expand: int = 4,
                 hop_cap: int = 0, sq_params=None, pq_cb=None):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.max_batch = max_batch
        self.intra_k = intra_k
        self.r_window = r_window
        self.n_expand = n_expand
        self.hop_cap = hop_cap
        # storage codecs, fixed once trained: sq8 (offset [d], scale [d])
        # and PQ codebooks [m_sub, ksub, dsub], as f32 numpy arrays
        self.sq_params = None if sq_params is None else tuple(
            np.asarray(a, np.float32) for a in sq_params)
        self.pq_cb = None if pq_cb is None else np.asarray(pq_cb, np.float32)
        # back-link pairs beyond the repair window, lost per add() / total
        self.last_backlink_dropped = 0
        self.backlink_dropped_total = 0

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

    def _codecs(self, device):
        """(sq_params, pq_cb) as tensors on ``device`` (None where unset)."""
        sq = None if self.sq_params is None else tuple(
            torch.from_numpy(a).to(device) for a in self.sq_params)
        pq = None if self.pq_cb is None else \
            torch.from_numpy(self.pq_cb).to(device)
        return sq, pq

    def _seed_first(self, graph: GraphArrays, vectors: torch.Tensor,
                    x0: np.ndarray, level: int) -> None:
        """Insert the very first point (x̂0 for a codec): no search
        needed."""
        x0 = torch.from_numpy(x0).to(vectors.device)[None]
        vectors[0] = _encode_rows(x0, vectors.dtype,
                                  *self._codecs(vectors.device))[0]
        graph.levels[0] = level
        if level >= 1:
            graph.upper_slot[0] = 0
            graph.upper_node[0] = 0
            graph.n_upper = 1
        graph.entry_point, graph.max_level, graph.ntotal = 0, level, 1

    def _plan(self, n0: int, n_upper: int, x: np.ndarray,
              all_levels: np.ndarray):
        """The whole insert schedule on the host: arrays in batch order
        (level-sorted within each batch) and the (offset, take) of each
        batch. A batch never exceeds the current graph's size class."""
        cfg = self.cfg
        n = len(x)
        x_sched = np.empty_like(x)
        ids_sched = np.empty((n,), np.int32)
        lv_sched = np.empty((n,), np.int32)
        sl_sched = np.full((n,), -1, np.int32)
        batches = []
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
            x_sched[i:i + take] = x[i:i + take][perm]
            ids_sched[i:i + take] = pids
            lv_sched[i:i + take] = lv[perm]
            ups = np.flatnonzero(lv_sched[i:i + take] >= 1)
            if n_upper + len(ups) > cfg.upper_capacity:
                raise ValueError("upper_capacity exceeded; raise it in "
                                 "HnswConfig")
            sl_sched[i + ups] = np.arange(n_upper, n_upper + len(ups),
                                          dtype=np.int32)
            n_upper += len(ups)
            batches.append((i, take))
            n0 += take
            i += take
        return x_sched, ids_sched, lv_sched, sl_sched, batches

    def add(self, graph: GraphArrays, vectors: torch.Tensor, x: np.ndarray,
            *, ef_construction: int | None = None) -> None:
        """Insert ``x`` (f32 [n, d], host) with ids ntotal.. in place."""
        cfg = self.cfg
        efc = int(ef_construction or cfg.ef_construction)
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        all_levels = self._draw_levels(len(x))
        i = 0
        if graph.ntotal == 0 and len(x):
            self._seed_first(graph, vectors, x[0], int(all_levels[0]))
            i = 1
        xs_np, ids_np, lv_np, sl_np, batches = self._plan(
            graph.ntotal, graph.n_upper, x[i:], all_levels[i:])
        if not batches:
            return
        dev = vectors.device
        xs = torch.from_numpy(xs_np).to(dev)      # one host-to-device copy
        ids_s = torch.from_numpy(ids_np).to(dev)
        lv_s = torch.from_numpy(lv_np).to(dev)
        sl_s = torch.from_numpy(sl_np).to(dev)
        sq_params, pq_cb = self._codecs(dev)
        drops = torch.zeros((), dtype=torch.int64, device=dev)
        for off, take in batches:
            part = slice(off, off + take)
            lv = lv_np[part]
            drops += _insert_batch(
                graph, vectors, xs[part], ids_s[part], lv_s[part],
                sl_s[part], lv, cfg=cfg, ef_construction=efc,
                intra_k=self.intra_k, r_window=self.r_window,
                n_expand=self.n_expand, hop_cap=self.hop_cap,
                sq_params=sq_params, pq_cb=pq_cb)
            # scalar bookkeeping: the batch's first point has its max level
            if int(lv[0]) > graph.max_level:
                graph.entry_point = int(ids_np[off])
                graph.max_level = int(lv[0])
            graph.ntotal += take
            graph.n_upper += int((sl_np[part] >= 0).sum())
        self.last_backlink_dropped = int(drops)
        self.backlink_dropped_total += self.last_backlink_dropped
        if self.last_backlink_dropped:
            logger.info(
                "back-link repair: %d pairs beyond the r_window=%d cap were "
                "dropped this add() (%.4f%% of ~%d forward links)",
                self.last_backlink_dropped, self.r_window,
                100.0 * self.last_backlink_dropped / max(len(x) * cfg.m, 1),
                len(x) * cfg.m)
