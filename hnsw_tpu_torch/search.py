"""Batched HNSW query pipeline, ported from ``hnsw_tpu.search``.

``IndexHNSW::search`` as batched tensor steps:

  1. entry: a dense scan of a strided sample of the live nodes
     (``_sample_seeds``; entry_mode "sample" / "seed") or the greedy
     upper-level descent (``greedy_descend``; "descend"), then an exact
     rescore of the seeds;
  2. level 0, one of two engines, chosen as the reference chooses them:
       * fused (the default): ``beam_search_fused``; each hop gathers the
         adjacency row and computes the candidates' distances (K2 or K4
         from the packed code row, or K3 from the vectors), then K1
         updates the beam;
       * legacy (``beam_search``), whenever the search asks for a filter
         (``allowed``), ``n_expand > 1``, ``visited_mode="bitmap"`` or
         ``HNSW_TPU_PALLAS_HOP=1``: a multi-op hop with bf16 or f32 merge
         keys (``beam_keys``), and a separate top-k of allowed ids when
         filtered;
  3. an exact rerank with K3 of the final [Q, ef] buffer (or, filtered,
     of the [Q, k] result buffer), duplicate collapse, top-k, and the true
     squared L2 restored.

Distances use the L2 surrogate ||x||² − 2 q·x in the loop; ||q||² is added
back on the final top-k only. Under ``HNSW_TPU_PALLAS_HOP=1`` every
distance before the rerank (entry rescore, descent, hops) goes through K5
``fused_gather_distances``, and the packed expand is unchanged.

Storage codecs: bf16 rows go through K3 (K5 under
``HNSW_TPU_PALLAS_HOP=1``) and sq8 rows (uint8 + the per-dim affine,
``dequant``) through K3 everywhere; PQ codes (``pq``) through ADC table
lookups (``ops/pq.py``). Every distance is then exact over the stored x̂.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from .config import IP, L2
from .graph import GraphArrays
from .ops import beam as beam_ops
from .ops.dist_kernel import gathered_vec_dist_ids
from .ops.distances import decode_rows
from .ops.hop_kernel import fused_gather_distances
from .ops.packed import (PackedNeighbors, PackedPQ, make_packed_expand,
                         make_packed_pq_expand)

INF = float("inf")


class SearchStats(NamedTuple):
    hops: int            # level-0 loop iterations for the batch
    ndis: torch.Tensor   # int32 [Q] distance computations per query


def _use_pallas_hop() -> bool:
    """The reference's switch, read from the same variable: every distance
    of the search before the rerank goes through K5."""
    return os.environ.get("HNSW_TPU_PALLAS_HOP", "") == "1"


def _make_distance_fn(vectors: torch.Tensor, queries: torch.Tensor,
                      metric: str, pallas_hop: bool = False, dequant=None,
                      pq=None):
    """distance_to(ids [Q, K], mask) -> f32 [Q, K] surrogate distances,
    exact over the stored vectors (x̂ for a codec):

      * f32 / bf16 rows: K3, or K5 with ``pallas_hop`` (for every d: the
        reference's d % 128 gate is a TPU lane limit; K5 widens bf16 rows
        in registers where the reference copies the table to f32);
      * sq8 rows (``dequant`` = (offset, scale)): K3 on the uint8 rows with
        the affine in the kernel, under ``pallas_hop`` too, as the
        reference's dequant path;
      * PQ codes (``pq`` = codebooks): ADC of the gathered code rows by
        lookups in per-query tables built once here (``ops/pq.py``,
        PyTorch ops, as the reference's ADC is XLA).

    On CPU tensors each kernel runs its plain version. Masked ids read row
    0 and are to be ignored by the caller."""
    qf = queries.float().contiguous()
    if pq is not None:
        from .ops.pq import adc_distance, pq_lut
        lut = pq_lut(qf, pq, metric)                             # [Q, m, ksub]

        def distance_to(ids: torch.Tensor, mask: torch.Tensor):
            codes = vectors[torch.where(mask, ids, 0).long()]    # [Q, K, m]
            return adc_distance(lut, codes)

        return distance_to
    if pallas_hop and dequant is None:
        def distance_to(ids: torch.Tensor, mask: torch.Tensor):
            safe = torch.where(mask, ids, 0).to(torch.int32)
            return fused_gather_distances(vectors, safe, qf, metric=metric)

        return distance_to

    def distance_to(ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        safe = torch.where(mask, ids, 0).to(torch.int32)
        return gathered_vec_dist_ids(vectors, safe, qf, dequant,
                                     metric=metric)

    return distance_to


def greedy_descend(graph: GraphArrays, distance_to, entry: torch.Tensor,
                   entry_dist: torch.Tensor, to_level: torch.Tensor,
                   max_level_cap: int):
    """Batched faiss ``greedy_update_nearest``: an ef=1 walk per level from
    the graph's max level down to (exclusive) each query's ``to_level``.
    The whole batch steps down a level once no query improves at it (one
    host read per step). Returns (node [Q], dist [Q])."""
    lvl = min(max(graph.max_level, 0), max_level_cap)
    cur, curd = entry, entry_dist
    moved = torch.ones_like(entry, dtype=torch.bool)
    while lvl > 0:
        act = (lvl > to_level) & moved
        slot = graph.upper_slot[cur].clamp(min=0)
        nbrs = graph.upper_neighbors[slot, lvl - 1]               # [Q, m]
        valid = (nbrs >= 0) & act[:, None]
        dn = torch.where(valid, distance_to(nbrs, valid), INF)
        mini = torch.argmin(dn, dim=1, keepdim=True)
        mind = torch.gather(dn, 1, mini)[:, 0]
        better = mind < curd
        cur = torch.where(better, torch.gather(nbrs, 1, mini)[:, 0], cur)
        curd = torch.where(better, mind, curd)
        if bool(better.any()):
            moved = better
        else:
            lvl -= 1
            moved = torch.ones_like(moved)
    return cur, curd


def _sample_seeds(graph: GraphArrays, vectors: torch.Tensor,
                  queries: torch.Tensor, metric: str, dequant=None, *,
                  n_sample: int, n_seeds: int,
                  tile_q: int = 2048) -> torch.Tensor:
    """Entry seeds from one dense scan over an evenly strided sample of
    ``n_sample`` ids in [0, ntotal): the sample is cut into ``n_seeds``
    equal contiguous strata and each stratum's argmin is returned, int32
    [Q, n_seeds] (-1 where a stratum had no live candidate). Sampled ids
    must be inserted and non-isolated. sq8 rows are dequantized with
    ``dequant``. The [tile_q, n_sample] distance block bounds the memory;
    the caller rescores the seeds exactly."""
    dev = vectors.device
    nt = max(graph.ntotal, 1)
    a = torch.arange(n_sample, dtype=torch.int64, device=dev)
    step, rem = nt // n_sample, nt % n_sample
    ids = torch.clamp(a * step + (a * rem) // n_sample, max=nt - 1)
    ok = (graph.levels[ids] >= 0) & (graph.neighbors0[ids, 0] >= 0)
    sv = decode_rows(vectors[ids], dequant)                      # [S, d]
    svsq = (sv * sv).sum(1)
    ss = n_sample // n_seeds
    base = torch.arange(n_seeds, device=dev)[None, :] * ss
    out = []
    for q0 in range(0, queries.shape[0], tile_q):
        dots = queries[q0:q0 + tile_q].float() @ sv.T
        dist = -dots if metric == IP else svsq[None, :] - 2.0 * dots
        dist = torch.where(ok[None, :], dist, INF).view(-1, n_seeds, ss)
        j = torch.argmin(dist, dim=2)                            # first on ties
        cd = torch.gather(dist, 2, j[..., None])[..., 0]
        out.append(torch.where(torch.isfinite(cd), ids[base + j], -1))
    return torch.cat(out).to(torch.int32)


def entry_sample_size(capacity: int) -> int:
    """Sample width for entry_mode "sample": the largest power of two <=
    capacity/32, clamped to [128, 32768] (~1/M density, like the level-1 set
    the greedy descent would converge on)."""
    return min(32768, max(128, 1 << max(capacity // 32, 1).bit_length() - 1))


def ef_bucket(ef: int) -> int:
    """Beam-buffer width for a requested efSearch: the next power of two
    >= ef (min 32). The true ef masks the tail (``ef_live``)."""
    return max(32, 1 << (int(ef) - 1).bit_length())


def compute_sqnorms(vectors: torch.Tensor, dequant=None) -> torch.Tensor:
    """||x||² per row; with ``dequant`` = (offset, scale), ||x̂||² of the
    dequantized codes."""
    v = decode_rows(vectors, dequant)
    return (v * v).sum(-1)


def hnsw_search(graph: GraphArrays, vectors: torch.Tensor,
                queries: torch.Tensor, *, k: int, ef_search: int,
                metric: str = L2, max_level_cap: int = 6, max_hops: int = 0,
                n_expand: int = 1, with_stats: bool = False,
                visited_mode: str = "buffer",
                allowed: torch.Tensor | None = None,
                packed: PackedNeighbors | PackedPQ | None = None,
                dequant=None, pq=None,
                beam_keys: str = "auto", entry_mode: str = "auto"):
    """Batched k-NN. Returns (dists [Q, k] f32, ids [Q, k] int32), ascending;
    ids are -1 (dist inf) past the reachable set. ``with_stats`` adds
    ``SearchStats``.

    ``ef_search`` is a runtime value inside a power-of-two buffer
    (``ef_bucket``). ``max_hops``: 0 caps the level-0 loop at ef + 8 hops
    (filtered: runs to convergence); > 0 sets the cap; < 0 runs to
    convergence. ``packed``: route on the packed 8/4-bit code rows or on
    PQ-coded rows (``ops/packed.py``); the final buffer is re-ranked with
    storage-grade distances either way. ``dequant`` = (offset, scale) for
    sq8 storage (uint8 ``vectors``), ``pq`` = codebooks for PQ storage
    (``vectors`` holds the codes): every distance is then exact over x̂.
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
    "f32"; the fused beam always merges in f32."""
    if beam_keys not in ("auto", "bf16", "f32"):
        raise ValueError(f"beam_keys must be auto|bf16|f32, got {beam_keys!r}")
    if visited_mode not in ("buffer", "bitmap"):
        raise ValueError(f"visited_mode must be buffer|bitmap, got "
                         f"{visited_mode!r}")
    if entry_mode not in ("auto", "sample", "seed", "descend"):
        raise ValueError(
            f"entry_mode must be auto|sample|seed|descend, got {entry_mode!r}")
    if pq is not None:
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
    queries = queries.float().contiguous()
    qn = queries.shape[0]
    pallas_hop = _use_pallas_hop()
    fused = (n_expand == 1 and allowed is None and visited_mode == "buffer"
             and not pallas_hop)
    distance_to = _make_distance_fn(vectors, queries, metric, pallas_hop,
                                    dequant, pq)

    ep = torch.full((qn,), graph.entry_point, dtype=torch.int32,
                    device=queries.device)
    if entry_mode in ("sample", "seed"):
        n_sample = entry_sample_size(vectors.shape[0])
        n_seeds = (min(16, ef_buf // 2) if entry_mode == "seed"
                   else max(1, n_sample // 4096))
        seeds = _sample_seeds(graph, vectors, queries, metric, dequant,
                              n_sample=n_sample, n_seeds=n_seeds)
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
        if entry_mode == "sample":
            ep0, ep0_dist = ep0[:, :1], ep0_dist[:, :1]
    else:
        ep_dist = distance_to(ep[:, None], torch.ones_like(ep[:, None],
                                                           dtype=torch.bool))
        e, e_d = greedy_descend(graph, distance_to, ep, ep_dist[:, 0],
                                torch.zeros_like(ep), max_level_cap)
        ep0, ep0_dist = e[:, None], e_d[:, None]

    neighbors0 = graph.neighbors0
    expand = None
    if packed is not None:
        # sq rows route on a scale shifted by q·offset (shift the exactly
        # scored entries onto it); PQ rows carry the whole surrogate
        make = make_packed_pq_expand if isinstance(packed, PackedPQ) \
            else make_packed_expand
        expand, shift = make(packed, neighbors0, queries, metric)
        ep0_dist = ep0_dist + shift[:, None]
    if fused:
        if expand is None:
            def expand(cur, step_ok):
                nbrs = neighbors0[cur]                           # [Q, T, m0]
                valid = (nbrs >= 0) & step_ok[..., None]
                return nbrs, distance_to(nbrs.reshape(qn, -1),
                                         valid.reshape(qn, -1))

        state = beam_ops.beam_search_fused(
            ep0, ep0_dist, expand, ef=ef_buf, max_hops=4 * ef_buf + 16,
            ef_live=ef, hop_limit=hop_limit)
    else:
        if beam_keys == "auto":
            # bf16 keys where routing is quantized already (packed rows,
            # PQ's ADC)
            key_dtype = torch.bfloat16 if (packed is not None
                                           or pq is not None) \
                else torch.float32
        else:
            key_dtype = torch.bfloat16 if beam_keys == "bf16" \
                else torch.float32
        # the legacy beam starts from the single best entry ("seed" is a
        # fused-beam feature)
        state = beam_ops.init_beam(ep0[:, 0], ep0_dist[:, 0], ef_buf,
                                   vectors.shape[0],
                                   visited_mode=visited_mode,
                                   key_dtype=key_dtype)
        if allowed is not None:
            state = beam_ops.attach_result_buffer(state, k, allowed)
        state = beam_ops.beam_search(
            state, lambda ids: neighbors0[ids], distance_to,
            max_hops=4 * ef_buf + 16, n_expand=n_expand,
            visited_mode=visited_mode, allowed=allowed, ef_live=ef,
            hop_limit=hop_limit, expand=expand, early_exit=True)

    # rerank of the final buffer (filtered: of the result buffer) with
    # storage-grade distances, exact f32 / sq8 x̂ (K3 with the affine) /
    # exact ADC: routing may have been quantized, the returned distances
    # are exact over the stored vectors
    src = state.res_ids if allowed is not None else state.buf_ids
    if pq is not None:
        from .ops.pq import adc_distance, pq_lut
        ex = adc_distance(pq_lut(queries, pq, metric),
                          vectors[src.clamp(min=0).long()])
    else:
        ex = gathered_vec_dist_ids(vectors, src.clamp(min=0), queries,
                                   dequant, metric=metric)
    ids, dist = beam_ops.dedup_sorted_buffer(
        src, torch.where(src >= 0, ex, INF))
    out_d, out_i = dist[:, :k], ids[:, :k]
    if metric == L2:
        out_d = out_d + (queries * queries).sum(1, keepdim=True)
    out_d = torch.where(out_i >= 0, out_d, INF)
    if with_stats:
        return out_d, out_i, SearchStats(state.hops, state.ndis)
    return out_d, out_i
