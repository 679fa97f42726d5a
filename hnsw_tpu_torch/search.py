"""Batched HNSW query pipeline, ported from ``hnsw_tpu.search``.

``IndexHNSW::search`` as batched tensor steps:

  1. entry: a dense scan of a strided sample of the live nodes
     (``_sample_seeds``; entry_mode "sample" / "seed") or the greedy
     upper-level descent (``greedy_descend``; "descend"), then an exact
     rescore of the seeds;
  2. level 0, one of two engines, chosen as the reference chooses them:
       * fused (the default): ``beam_search_fused``; each hop computes
         the expanded node's candidates' distances (K2 or K4 from its
         packed code row, K3 from the vectors of its adjacency row), then
         K1's hop entry reads the adjacency row and updates the beam: on
         the card K2 or K3 and K1 are the whole hop, two launches;
       * legacy (``beam_search``), whenever the search asks for a filter
         (``allowed``), ``n_expand > 1``, ``visited_mode="bitmap"``,
         ``HNSW_TPU_PALLAS_HOP=1`` or ``HNSW_TPU_BEAM_KERNEL=0``: a
         multi-op hop with bf16 or f32 merge keys (``beam_keys``), and a
         separate top-k of allowed ids when filtered;
  3. an exact rerank with K3 of the final [Q, ef] buffer (or, filtered,
     of the [Q, k] result buffer), duplicate collapse, top-k, and the true
     squared L2 restored.

Distances use the L2 surrogate ||x||² − 2 q·x in the loop; ||q||² is added
back on the final top-k only. Under ``HNSW_TPU_PALLAS_HOP=1`` every
distance before the rerank (entry rescore, descent, hops) goes through K5
``fused_gather_distances``, and the packed expand is unchanged.

The stored rows and their codec come as one ``ops/storage.Storage``, which
picks each exact distance's kernel: K3 on f32, bf16 and sq8 rows (K5 for
f32 and bf16 under ``HNSW_TPU_PALLAS_HOP=1``), ADC table lookups on PQ
codes. Every distance is then exact over the stored x̂.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from . import graphs, trace
from .config import L2
from .graph import GraphArrays
from .graphs import EagerLoop
from .ops import beam as beam_ops
from .ops.entry_kernel import entry_scan
from .ops.packed import (PackedNeighbors, PackedPQ, make_packed_dist,
                         make_packed_expand, make_packed_pq_dist,
                         make_packed_pq_expand)
from .ops.storage import Storage

INF = float("inf")


class SearchStats(NamedTuple):
    hops: int            # level-0 loop iterations for the batch
    ndis: torch.Tensor   # int32 [Q] distance computations per query
    # device ms of the phases "entry", "hops" and "rerank" on a CUDA
    # device (trace.Phases), None elsewhere
    phase_ms: dict | None = None


def _use_pallas_hop() -> bool:
    """The reference's switch, read from the same variable: every distance
    of the search before the rerank goes through K5."""
    return os.environ.get("HNSW_TPU_PALLAS_HOP", "") == "1"


def _beam_kernel_off() -> bool:
    """The reference's kill-switch ``HNSW_TPU_BEAM_KERNEL=0``: the legacy
    beam on every device. Any other value keeps the fused beam (the
    reference's choice on its own chip)."""
    return os.environ.get("HNSW_TPU_BEAM_KERNEL", "") == "0"


def greedy_descend(graph: GraphArrays, distance_to, entry: torch.Tensor,
                   entry_dist: torch.Tensor, to_level: torch.Tensor,
                   max_level_cap: int, *, max_level=None,
                   active: torch.Tensor | None = None, loop=None):
    """Batched faiss ``greedy_update_nearest``: an ef=1 walk per level from
    the graph's max level down to (exclusive) each query's ``to_level``.
    The reference's one ``lax.while_loop`` over a scalar level counter
    ``l``: the whole batch steps down a level once no query improves at
    it, and the loop ends at ``l == 0``. ``l`` and ``moved`` live on the
    device and ``loop`` (``graphs.EagerLoop`` by default) reads the
    condition once a chunk of steps; a step at ``l == 0`` changes nothing.
    ``max_level``: the graph's max level as a 0-d tensor (a captured
    search reads it at replay), else ``graph.max_level``. ``active``
    (bool [Q]): queries that walk (padded rows do not). Returns (node [Q],
    dist [Q])."""
    dev = entry.device
    if max_level is None:
        if min(graph.max_level, max_level_cap) <= 0:
            return entry, entry_dist        # no upper level to walk
        max_level = torch.tensor(graph.max_level, dtype=torch.int64,
                                 device=dev)
    if active is None:
        active = torch.ones_like(entry, dtype=torch.bool)
    s = {"l": torch.clamp(max_level.to(torch.int64), 0, max_level_cap),
         "cur": entry, "curd": entry_dist, "moved": active}

    def cond(s):
        return s["l"] > 0

    def step(s):
        lvl, cur, curd, moved = s["l"], s["cur"], s["curd"], s["moved"]
        run = lvl > 0
        act = (lvl > to_level) & moved & run
        slot = graph.upper_slot[cur.long()].clamp(min=0).long()
        nbrs = graph.upper_neighbors[
            slot, (lvl - 1).clamp(min=0).expand_as(slot)]         # [Q, m]
        valid = (nbrs >= 0) & act[:, None]
        dn = torch.where(valid, distance_to(nbrs, valid), INF)
        mini = torch.argmin(dn, dim=1, keepdim=True)
        mind = torch.gather(dn, 1, mini)[:, 0]
        better = mind < curd
        any_better = better.any()
        return {"l": torch.where(any_better | ~run, lvl, lvl - 1),
                "cur": torch.where(better, torch.gather(nbrs, 1, mini)[:, 0],
                                   cur),
                "curd": torch.where(better, mind, curd),
                "moved": torch.where(run, torch.where(any_better, better,
                                                      active), moved)}

    s = (loop or EagerLoop()).run(cond, step, s)
    return s["cur"], s["curd"]


def _sample_seeds(graph: GraphArrays, storage: Storage,
                  queries: torch.Tensor, metric: str, *,
                  n_sample: int, n_seeds: int, ntotal=None) -> torch.Tensor:
    """Entry seeds from one dense scan over an evenly strided sample of
    ``n_sample`` ids in [0, ntotal): the sample is cut into ``n_seeds``
    equal contiguous strata and each stratum's argmin is returned, int32
    [Q, n_seeds] (-1 where a stratum had no live candidate). Sampled ids
    must be inserted and non-isolated; their rows are decoded to x̂.
    ``ntotal``: a 0-d tensor (a captured search reads it at
    replay), else ``graph.ntotal``. The scan is K6 ``entry_scan`` on the
    card (``ops/entry_kernel.py``); the caller rescores the seeds
    exactly."""
    dev = storage.rows.device
    if ntotal is None:
        ntotal = torch.tensor(graph.ntotal, dtype=torch.int64, device=dev)
    nt = ntotal.to(torch.int64).clamp(min=1)
    a = torch.arange(n_sample, dtype=torch.int64, device=dev)
    step, rem = nt // n_sample, nt % n_sample
    ids = torch.minimum(a * step + (a * rem) // n_sample, nt - 1)
    ok = (graph.levels[ids] >= 0) & (graph.neighbors0[ids, 0] >= 0)
    sv = storage.read(ids)                                       # [S, d]
    svsq = (sv * sv).sum(1)
    j = entry_scan(queries, sv, svsq, ok, n_seeds, metric)      # [Q, E]
    base = torch.arange(n_seeds, device=dev)[None, :] * (n_sample // n_seeds)
    return torch.where(j >= 0, ids[base + j.clamp(min=0)], -1).to(
        torch.int32)


def entry_sample_size(capacity: int) -> int:
    """Sample width for entry_mode "sample": the largest power of two <=
    capacity/32, clamped to [128, 32768] (~1/M density, like the level-1 set
    the greedy descent would converge on)."""
    return min(32768, max(128, 1 << max(capacity // 32, 1).bit_length() - 1))


def ef_bucket(ef: int) -> int:
    """Beam-buffer width for a requested efSearch: the next power of two
    >= ef (min 32). The true ef masks the tail (``ef_live``)."""
    return max(32, 1 << (int(ef) - 1).bit_length())


class _Statics(NamedTuple):
    """What a search's program is made from, besides the index tensors:
    the reference's ``_SEARCH_STATICS`` and the shapes a capture fixes."""
    k: int
    ef_buf: int
    metric: str
    max_level_cap: int
    n_expand: int
    with_stats: bool
    visited_mode: str
    pallas_hop: bool
    key_dtype: str          # the legacy beam's merge keys
    fused: bool             # the beam engine (HNSW_TPU_BEAM_KERNEL)
    entry_mode: str
    n_sample: int
    n_seeds: int
    q_rows: int             # padded query rows
    filtered: bool          # ``allowed`` given
    bounded: bool           # default hop cap: the loop fits ef_buf + 8 hops
    ef_full: bool           # ef == ef_buf: no slot past ef_live
    chunk: int              # graphs.LOOP_CHUNK


def hnsw_search(graph: GraphArrays, storage: Storage,
                queries: torch.Tensor, *, k: int, ef_search: int,
                metric: str = L2, max_level_cap: int = 6, max_hops: int = 0,
                n_expand: int = 1, with_stats: bool = False,
                visited_mode: str = "buffer",
                allowed: torch.Tensor | None = None,
                packed: PackedNeighbors | PackedPQ | None = None,
                beam_keys: str = "auto", entry_mode: str = "auto"):
    """Batched k-NN. Returns (dists [Q, k] f32, ids [Q, k] int32), ascending;
    ids are -1 (dist inf) past the reachable set. ``with_stats`` adds
    ``SearchStats``.

    ``ef_search`` is a runtime value inside a power-of-two buffer
    (``ef_bucket``). ``max_hops``: 0 caps the level-0 loop at ef + 8 hops
    (filtered: runs to convergence); > 0 sets the cap; < 0 runs to
    convergence. ``packed``: route on the packed 8/4-bit code rows or on
    PQ-coded rows (``ops/packed.py``); the final buffer is re-ranked with
    storage-grade distances either way. ``storage``: the stored rows and
    their codec (``ops/storage.py``); every distance is exact over x̂.
    ``entry_mode``: "sample" (default via "auto"), "seed" (the fused beam
    starts from up to 16 stratified seeds; the legacy beam from the best)
    or "descend" (faiss's greedy upper-level walk). PQ storage always
    descends, as the reference does: a dense ADC scan of the sample would
    cost more than it saves.

    ``allowed`` (bool [capacity]): filtered search (faiss IDSelector): the
    graph is traversed unfiltered, only allowed ids are returned.
    ``n_expand``: buffer entries expanded per hop (legacy beam when > 1).
    ``visited_mode``: "buffer" or "bitmap" (the exact visited set; legacy
    beam). ``beam_keys``: the legacy beam's merge keys, "auto" (bf16 when
    routing is already quantized, i.e. packed; f32 otherwise), "bf16" or
    "f32"; the fused beam always merges in f32.

    The search is one device program (``graphs.py``): its loops evaluate
    their conditions on the device and the host reads them once a chunk
    of ``graphs.LOOP_CHUNK`` steps. On a CUDA device the queries are
    padded to a multiple of 512 rows and the program is replayed from a
    CUDA graph captured on the key's first search (``search_key``).

    Its phases, entry, hops and rerank, are spans while tracing is on
    (``trace.py``). With ``with_stats`` on a CUDA device each phase's
    device ms are timed by events between its graphs (the capture is
    split at the phases), returned as ``SearchStats.phase_ms`` and, while
    tracing is on, added to the trace's device times; the first host read
    then waits in ``hnsw.search.wait``."""
    with trace.span("hnsw.search.plan"):
        st, key, refs, inputs = _plan(
            graph, storage, queries, k=k, ef_search=ef_search,
            metric=metric, max_level_cap=max_level_cap, max_hops=max_hops,
            n_expand=n_expand, with_stats=with_stats,
            visited_mode=visited_mode, allowed=allowed, packed=packed,
            beam_keys=beam_keys, entry_mode=entry_mode)

    def body(inputs, loop):
        return _search_body(inputs, loop, st, graph, storage, packed)

    dev = storage.rows.device
    on_card = dev.type == "cuda"
    if st.fused:
        trace.count("searches.kernel_hop" if on_card
                    else "searches.composed_hop")
    if st.n_sample:
        trace.count("searches.kernel_entry" if on_card
                    else "searches.composed_entry")
    with trace.Phases("hnsw.search", dev, with_stats) as ph:
        if graphs.capturing_enabled(dev):
            out = graphs.replay_or_capture(key, refs, inputs, body,
                                           split=with_stats, phases=ph)
        else:
            out = body(inputs, EagerLoop(st.chunk, ph))
    qn = queries.shape[0]
    out_d, out_i = out["d"][:qn], out["i"][:qn]
    if with_stats:
        trace.wait(out["hops"])
        hops = int(graphs.host_read(out["hops"]))
        phase_ms = ph.ms()
        trace.add_device("hnsw.search", phase_ms)
        return out_d, out_i, SearchStats(hops, out["ndis"][:qn], phase_ms)
    return out_d, out_i


def search_key(graph: GraphArrays, storage: Storage,
               queries: torch.Tensor, **kw) -> tuple:
    """The capture key of ``hnsw_search(graph, storage, queries, **kw)``:
    its statics and the identity (pointer, shape, dtype, strides) of every
    index tensor the search reads. Runtime values are not in it: the
    queries (beyond their padded shape), ef within its bucket, hop_limit,
    the graph's scalars and the filter's contents."""
    return _plan(graph, storage, queries, **kw)[1]


def _plan(graph, storage, queries, *, k, ef_search, metric=L2,
          max_level_cap=6, max_hops=0, n_expand=1, with_stats=False,
          visited_mode="buffer", allowed=None, packed=None, beam_keys="auto",
          entry_mode="auto"):
    """(statics, key, index tensors, runtime inputs) of one search."""
    if beam_keys not in ("auto", "bf16", "f32"):
        raise ValueError(f"beam_keys must be auto|bf16|f32, got {beam_keys!r}")
    if visited_mode not in ("buffer", "bitmap"):
        raise ValueError(f"visited_mode must be buffer|bitmap, got "
                         f"{visited_mode!r}")
    if entry_mode not in ("auto", "sample", "seed", "descend"):
        raise ValueError(
            f"entry_mode must be auto|sample|seed|descend, got {entry_mode!r}")
    pq_rows = storage.pq is not None
    if pq_rows:
        entry_mode = "descend"
    elif entry_mode == "auto":
        entry_mode = "sample"
    ef = max(int(ef_search), k)
    if max_hops == 0:
        hop_limit = (ef + 8) if allowed is None else 1 << 30
    elif max_hops > 0:
        hop_limit = max_hops
    else:
        hop_limit = 1 << 30
    ef_buf = ef_bucket(ef)
    pallas_hop = _use_pallas_hop()
    fused = (n_expand == 1 and allowed is None and visited_mode == "buffer"
             and not pallas_hop and not _beam_kernel_off())
    if beam_keys == "auto":
        # bf16 keys where routing is quantized already (packed rows, PQ's
        # ADC)
        key_dtype = "bfloat16" if (packed is not None or pq_rows) \
            else "float32"
    else:
        key_dtype = "bfloat16" if beam_keys == "bf16" else "float32"
    n_sample = n_seeds = 0
    if entry_mode in ("sample", "seed"):
        n_sample = entry_sample_size(storage.rows.shape[0])
        n_seeds = (min(16, ef_buf // 2) if entry_mode == "seed"
                   else max(1, n_sample // 4096))
    dev = storage.rows.device
    qn, d = queries.shape
    q_rows = graphs.padded_rows(qn, dev)
    st = _Statics(
        k=k, ef_buf=ef_buf, metric=metric, max_level_cap=max_level_cap,
        n_expand=n_expand, with_stats=with_stats, visited_mode=visited_mode,
        pallas_hop=pallas_hop, key_dtype=key_dtype, fused=fused,
        entry_mode=entry_mode, n_sample=n_sample, n_seeds=n_seeds,
        q_rows=q_rows, filtered=allowed is not None,
        bounded=max_hops == 0 and allowed is None, ef_full=ef == ef_buf,
        chunk=graphs.LOOP_CHUNK)

    refs = [graph.neighbors0, graph.levels, graph.upper_slot,
            graph.upper_node, graph.upper_neighbors, *storage.refs()]
    if isinstance(packed, PackedPQ):
        refs += [packed.nbr_codes, packed.cb]
    elif packed is not None:
        refs += [packed.nbr_codes, packed.nbr_sq, packed.scale,
                 packed.offset]
    key = (st, type(packed).__name__,
           None if not isinstance(packed, PackedPQ) else packed.pq_bits, d,
           tuple(graphs.tensor_identity(t) for t in refs))

    q = queries.to(dev, torch.float32)
    if q_rows > qn:
        q = torch.cat([q, q.new_zeros(q_rows - qn, d)])
    inputs = {"queries": q.contiguous(), "scalars": torch.tensor(
        [ef, hop_limit, graph.entry_point, graph.max_level, graph.ntotal, qn],
        dtype=torch.int64).to(dev)}
    if allowed is not None:
        inputs["allowed"] = allowed.to(dev, torch.bool)
    return st, key, refs, inputs


def _search_body(inputs: dict, loop, st: _Statics, graph: GraphArrays,
                 storage: Storage, packed) -> dict:
    """The search as one program over ``inputs`` (padded queries; the
    runtime scalars ef_live, hop_limit, entry point, max level, ntotal and
    the real query count; the filter), with its loops run and its phases
    marked (entry, hops, rerank) by ``loop``. Returns {"d", "i"} [q_rows,
    k], "hops" (0-d) and "ndis" [q_rows]."""
    loop.phase("entry")
    queries = inputs["queries"]
    allowed = inputs.get("allowed")
    sc = inputs["scalars"]
    ef_live, hop_limit, entry_point = sc[0], sc[1], sc[2]
    max_level, ntotal, n_queries = sc[3], sc[4], sc[5]
    metric, ef_buf = st.metric, st.ef_buf
    qn = queries.shape[0]
    dev = queries.device
    active = torch.arange(qn, device=dev) < n_queries    # padded rows: False
    distance_to = storage.distance_fn(queries, metric, st.pallas_hop)

    ep = entry_point.to(torch.int32).expand(qn).contiguous()
    if st.entry_mode in ("sample", "seed"):
        seeds = _sample_seeds(graph, storage, queries, metric,
                              n_sample=st.n_sample, n_seeds=st.n_seeds,
                              ntotal=ntotal)
        # seeds + the global entry point (the fallback when every sampled
        # id is masked), rescored exactly; no seed may repeat the entry
        seeds = torch.where(seeds == ep[:, None], -1, seeds)
        cand = torch.cat([seeds, ep[:, None]], 1)                # [Q, E+1]
        valid = cand >= 0
        cd = torch.where(valid, distance_to(cand, valid), INF)
        ep0_dist, o = torch.sort(cd, dim=1, stable=True)
        ep0 = torch.gather(cand, 1, o)
        if ep0.shape[1] > 2:
            # two strata can argmin the same node when ntotal < n_sample
            dup = torch.cat([torch.zeros_like(ep0[:, :1], dtype=torch.bool),
                             ep0[:, 1:] == ep0[:, :-1]], 1) & (ep0 >= 0)
            ep0 = torch.where(dup, -1, ep0)
            ep0_dist, o = torch.sort(torch.where(dup, INF, ep0_dist), dim=1,
                                     stable=True)
            ep0 = torch.gather(ep0, 1, o)
        if st.entry_mode == "sample":
            ep0, ep0_dist = ep0[:, :1], ep0_dist[:, :1]
    else:
        ep_dist = distance_to(ep[:, None], torch.ones_like(ep[:, None],
                                                           dtype=torch.bool))
        e, e_d = greedy_descend(graph, distance_to, ep, ep_dist[:, 0],
                                torch.zeros_like(ep), st.max_level_cap,
                                max_level=max_level, active=active,
                                loop=loop)
        ep0, ep0_dist = e[:, None], e_d[:, None]
    # padded rows enter with -1 and never expand
    ep0 = torch.where(active[:, None], ep0, -1)
    ep0_dist = torch.where(active[:, None], ep0_dist, INF)

    loop.phase("hops")
    neighbors0 = graph.neighbors0
    hop_dist = expand = None
    if packed is not None:
        # sq rows route on a scale shifted by q·offset (shift the exactly
        # scored entries onto it); PQ rows carry the whole surrogate. The
        # fused beam takes the distances by node, the legacy beam an expand
        pq_rows = isinstance(packed, PackedPQ)
        if st.fused:
            make = make_packed_pq_dist if pq_rows else make_packed_dist
            hop_dist, shift = make(packed, neighbors0.shape[1], queries,
                                   metric)
        else:
            make = make_packed_pq_expand if pq_rows else make_packed_expand
            expand, shift = make(packed, neighbors0, queries, metric)
        ep0_dist = ep0_dist + shift[:, None]
    live_width = None if st.ef_full else ef_live
    bound = ef_buf + 8 if st.bounded else None
    if st.fused:
        if hop_dist is None:
            hop_dist = storage.hop_distances(queries, neighbors0, metric,
                                             distance_to)
        state = beam_ops.beam_search_fused(
            ep0, ep0_dist, neighbors0, hop_dist, ef=ef_buf,
            max_hops=4 * ef_buf + 16, ef_live=live_width,
            hop_limit=hop_limit, bound=bound, loop=loop)
    else:
        # the legacy beam starts from the single best entry ("seed" is a
        # fused-beam feature)
        state = beam_ops.init_beam(ep0[:, 0], ep0_dist[:, 0], ef_buf,
                                   storage.rows.shape[0], ep0[:, 0] >= 0,
                                   visited_mode=st.visited_mode,
                                   key_dtype=getattr(torch, st.key_dtype))
        if allowed is not None:
            state = beam_ops.attach_result_buffer(state, st.k, allowed)
        state = beam_ops.beam_search(
            state, lambda ids: neighbors0[ids], distance_to,
            max_hops=4 * ef_buf + 16, n_expand=st.n_expand,
            visited_mode=st.visited_mode, allowed=allowed,
            ef_live=live_width, hop_limit=hop_limit, expand=expand,
            early_exit=True, bound=bound, loop=loop)

    loop.phase("rerank")
    # rerank of the final buffer (filtered: of the result buffer) with
    # storage-grade distances, exact f32 / sq8 x̂ (K3 with the affine) /
    # exact ADC: routing may have been quantized, the returned distances
    # are exact over the stored vectors
    src = state.res_ids if allowed is not None else state.buf_ids
    ex = storage.rerank(src, queries, metric)
    ids, dist = beam_ops.dedup_sorted_buffer(
        src, torch.where(src >= 0, ex, INF))
    out_d, out_i = dist[:, :st.k], ids[:, :st.k]
    if metric == L2:
        out_d = out_d + (queries * queries).sum(1, keepdim=True)
    out_d = torch.where(out_i >= 0, out_d, INF)
    return {"d": out_d, "i": out_i, "hops": state.hops, "ndis": state.ndis}
