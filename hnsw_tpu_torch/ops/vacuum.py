"""Graph vacuum, ported from ``hnsw_tpu.ops.vacuum``: remove tombstoned
nodes from routing.

``HnswIndex.remove_ids`` tombstones ids (results are filtered, routing
still passes through them). ``vacuum`` finishes the job in place: every
link INTO a dead node is removed and the hole is patched with candidates
inherited from the dead node's own list, re-pruned with the
select-neighbors heuristic (hnswlib's deletion repair rule); the dead
nodes' own rows are cleared, and the entry point moves to a live node. Ids
stay stable (``HnswIndex.compacted`` renumbers).

Only rows with a dead neighbor are touched; every other row stays bit for
bit what it was (a vacuum with nothing to patch is a no-op). A row's new
list depends on the pre-vacuum rows of its dead neighbors alone, and dead
rows are cleared only after every patch, so the rows may be patched in any
order: the port selects the rows with a dead neighbor first and patches
only those, in chunks and in place (the rows a chunk reads are its own,
not yet written, and dead ones), where the reference computes every row.

Distances from a row's node to its candidates go through the route the
build uses (``Storage.distance_fn``, ``ops/storage.py``: K3 on f32, bf16
and uint8 rows, ADC on PQ codes) plus the node's own ||u||²; the heuristic's
candidate-pair matrix is a matmul (``ops/prune.py``).
"""

from __future__ import annotations

import torch

from ..config import L2
from .beam import _first_occurrence_mask
from .prune import compact_append, select_neighbors
from .storage import Storage


def _repair_rows(rows: torch.Tensor, own: torch.Tensor, table: torch.Tensor,
                 slot_of, storage: Storage, dead: torch.Tensor, *,
                 metric: str) -> torch.Tensor:
    """New lists for rows with a dead neighbor. rows int32 [B, m] (their
    current lists), own int64 [B] (each row's node id), table int32 [T, m]
    (the level's pre-vacuum lists, read for the dead neighbors), slot_of
    (node ids -> row of ``table``). Candidates: the live neighbors, then
    the first 2m live ids inherited from the dead neighbors' lists (not the
    node itself), deduplicated; pruned to m by the select-neighbors
    heuristic on true distances to the node."""
    b, m = rows.shape
    valid = rows >= 0
    safe = rows.clamp(min=0).long()
    nbr_dead = valid & dead[safe]
    live_n = torch.where(valid & ~nbr_dead, rows, -1)
    inh = table[slot_of(torch.where(nbr_dead, safe, 0))]         # [B, m, m]
    inh_ok = nbr_dead[:, :, None] & (inh >= 0)
    inh_ok &= ~dead[inh.clamp(min=0).long()] & (inh != own[:, None, None])
    inh = compact_append(torch.where(inh_ok, inh, -1).reshape(b, m * m),
                         2 * m)
    pool = torch.cat([live_n, inh], 1)                           # [B, 3m]
    pool = torch.where(_first_occurrence_mask(pool), pool, -1)
    vu = storage.read(own)                                       # [B, d]
    ok = pool >= 0
    dist = storage.distance_fn(vu, metric)(pool, ok)
    if metric == L2:
        dist = dist + (vu * vu).sum(1, keepdim=True)
    vc = storage.read(pool.clamp(min=0).long())
    kept, _ = select_neighbors(pool, dist, vc, m=m, metric=metric)
    return kept


def _rows_with_dead(rows: torch.Tensor, row_ok: torch.Tensor,
                    dead: torch.Tensor) -> torch.Tensor:
    """int64 ids of the rows that are ``row_ok`` and hold a dead id."""
    nd = ((rows >= 0) & dead[rows.clamp(min=0).long()]).any(1)
    return torch.nonzero(nd & row_ok).flatten()


def vacuum_level0(neighbors0: torch.Tensor, storage: Storage,
                  dead: torch.Tensor, *, metric: str = L2,
                  chunk: int = 4096) -> int:
    """Patch and purge the level-0 adjacency in place. dead: bool
    [capacity]. Every live row with a dead neighbor gets a new list
    (``_repair_rows``), ``chunk`` rows at a time; then the dead rows are
    cleared to -1. Returns the number of rows patched."""
    todo = _rows_with_dead(neighbors0, ~dead, dead)
    for c in range(0, todo.numel(), chunk):
        ids = todo[c:c + chunk]
        neighbors0[ids] = _repair_rows(
            neighbors0[ids], ids, neighbors0, lambda n: n, storage, dead,
            metric=metric)
    neighbors0[dead] = -1
    return int(todo.numel())


def vacuum_upper(upper_neighbors: torch.Tensor, upper_node: torch.Tensor,
                 upper_slot: torch.Tensor, storage: Storage,
                 dead: torch.Tensor, *, metric: str = L2) -> int:
    """The same repair at every upper level, in place (the tables hold
    ~capacity/m rows, one pass a level). Slot and level maps stay: dead
    nodes keep their slots, their rows are cleared at every level. Returns
    the number of (row, level) lists patched."""
    nodes = upper_node.long()
    node_ok = nodes >= 0
    row_dead = node_ok & dead[nodes.clamp(min=0)]

    def slot_of(n):
        return upper_slot[n].clamp(min=0).long()

    patched = 0
    for lvl in range(upper_neighbors.shape[1]):
        tab = upper_neighbors[:, lvl]                            # view [U, m]
        todo = _rows_with_dead(tab, node_ok & ~row_dead, dead)
        if todo.numel():
            tab[todo] = _repair_rows(tab[todo], nodes[todo], tab, slot_of,
                                     storage, dead, metric=metric)
            patched += todo.numel()
    upper_neighbors[row_dead] = -1
    return patched


def live_entry_point(levels: torch.Tensor, dead: torch.Tensor):
    """(entry point, max level) over live nodes, as host ints: the first
    node of the highest live level (``argmax`` takes the first maximum);
    (-1, -1) when no node is live."""
    live_lv = torch.where((levels >= 0) & ~dead, levels, -1)
    mx = int(live_lv.max())
    if mx < 0:
        return -1, -1
    return int(torch.nonzero(live_lv == mx)[0, 0]), mx
