"""Graph storage: the HNSW multi-level graph as flat int32 tensors.

Same arrays as ``hnsw_tpu.graph`` (faiss ``struct HNSW`` levels / offsets /
neighbors / entry_point / max_level):

  * ``neighbors0``      int32[capacity, m0]        level-0 adjacency, -1 padded
  * ``levels``          int32[capacity]            level of node i, -1 unused
  * ``upper_slot``      int32[capacity]            node -> row in upper tables
  * ``upper_node``      int32[upper_capacity]      row -> node (inverse map)
  * ``upper_neighbors`` int32[upper_cap, L, m]     adjacency at level l (row l-1)

The four scalars (entry point, max level, ntotal, n_upper) are host ints:
the host drives every loop in this package, so keeping them on the host
saves a device read each time one is consulted.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .config import NO_NEIGHBOR, HnswConfig

TENSOR_FIELDS = ("neighbors0", "levels", "upper_slot", "upper_node",
                 "upper_neighbors")
SCALAR_FIELDS = ("entry_point", "max_level", "ntotal", "n_upper")


@dataclasses.dataclass
class GraphArrays:
    neighbors0: torch.Tensor       # int32 [capacity, m0]
    levels: torch.Tensor           # int32 [capacity]
    upper_slot: torch.Tensor       # int32 [capacity]
    upper_node: torch.Tensor       # int32 [upper_capacity]
    upper_neighbors: torch.Tensor  # int32 [upper_capacity, max_level_cap, m]
    entry_point: int = NO_NEIGHBOR
    max_level: int = NO_NEIGHBOR   # -1 == empty graph
    ntotal: int = 0
    n_upper: int = 0

    def numpy(self) -> dict:
        """Host copies of every field, keyed like the reference's npz."""
        out = {k: getattr(self, k).cpu().numpy() for k in TENSOR_FIELDS}
        out.update({k: np.int32(getattr(self, k)) for k in SCALAR_FIELDS})
        return out


def empty_graph(cfg: HnswConfig, device) -> GraphArrays:
    c, u, L = cfg.capacity, cfg.upper_capacity, cfg.max_level_cap

    def full(shape):
        return torch.full(shape, NO_NEIGHBOR, dtype=torch.int32, device=device)

    return GraphArrays(neighbors0=full((c, cfg.m0)), levels=full((c,)),
                       upper_slot=full((c,)), upper_node=full((u,)),
                       upper_neighbors=full((u, L, cfg.m)))


def graph_from_numpy(arrays, device) -> GraphArrays:
    """Build a ``GraphArrays`` from the reference's arrays: a mapping or an
    object with the ``hnsw_tpu.graph.GraphArrays`` field names, whose values
    are numpy arrays (or anything ``np.asarray`` takes, e.g. jax arrays)."""
    get = arrays.__getitem__ if isinstance(arrays, dict) else \
        (lambda k: getattr(arrays, k))
    tensors = {k: torch.tensor(np.asarray(get(k)), dtype=torch.int32,
                               device=device) for k in TENSOR_FIELDS}
    scalars = {k: int(np.asarray(get(k))) for k in SCALAR_FIELDS}
    return GraphArrays(**tensors, **scalars)


def save_graph(path, graph: GraphArrays, vectors: torch.Tensor,
               cfg: HnswConfig, extra: dict | None = None,
               extra_arrays: dict | None = None) -> None:
    """Write the reference's ``.npz`` format key for key: ``vectors``,
    ``config_json``, ``extra_json`` (JSON-serialisable state, e.g. the
    level RNG), ``graph_<field>`` and ``xarr_<name>`` (auxiliary arrays).
    ``path`` is a file name or a binary file object.

    bf16 vectors are written widened to f32 (exact): numpy has no bf16, and
    the reference cannot read back the void ``|V2`` array its own bf16 save
    writes, while it loads f32 vectors under a bfloat16 config."""
    arrs = {f"graph_{k}": np.asarray(v) for k, v in graph.numpy().items()}
    for k, v in (extra_arrays or {}).items():
        arrs[f"xarr_{k}"] = np.asarray(v)
    if vectors.dtype == torch.bfloat16:
        vectors = vectors.float()
    np.savez_compressed(path, vectors=vectors.cpu().numpy(),
                        config_json=np.bytes_(cfg.to_json()),
                        extra_json=np.bytes_(json.dumps(extra or {})),
                        **arrs)


def jsonify(obj):
    """numpy scalars inside np.random state dicts -> plain python (JSON)."""
    if isinstance(obj, dict):
        return {k: jsonify(v) for k, v in obj.items()}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def load_graph(path):
    """Read a ``.npz`` written by either package (``save_graph`` /
    ``HnswIndex.save``). Returns (arrays, vectors, config, extra,
    extra_arrays), all host-side numpy; ``arrays`` maps the
    ``GraphArrays`` field names to numpy arrays. The reference writes bf16
    vectors as 2-byte void items; those come back as int16 holding the bf16
    bits (``ops/storage.py`` ``Storage.load`` makes them bf16 again)."""
    with np.load(path, allow_pickle=False) as z:
        cfg = HnswConfig.from_json(bytes(z["config_json"].item()).decode())
        arrays = {k: z[f"graph_{k}"] for k in TENSOR_FIELDS + SCALAR_FIELDS}
        vectors = z["vectors"]
        if vectors.dtype.kind == "V" and vectors.dtype.itemsize == 2:
            vectors = vectors.view(np.int16)
        extra = {}
        if "extra_json" in z:
            extra = json.loads(bytes(z["extra_json"].item()).decode())
        extra_arrays = {k[5:]: z[k] for k in z.files if k.startswith("xarr_")}
    return arrays, vectors, cfg, extra, extra_arrays



def check_invariants(graph: GraphArrays, cfg: HnswConfig,
                     strict: bool = True, alive=None) -> dict:
    """Validate structural invariants on the host; returns stats and raises
    on violation when ``strict``. The same checks and stats as
    ``hnsw_tpu.graph.check_invariants``. ``alive`` (bool [capacity]) exempts
    tombstoned nodes from the liveness invariants."""
    g = graph.numpy()
    n = int(g["ntotal"])
    errors: list[str] = []
    stats: dict = {"ntotal": n, "max_level": int(g["max_level"])}
    live = (np.ones(n, bool) if alive is None
            else np.asarray(alive)[:n].astype(bool))

    nbr0 = g["neighbors0"][:n]
    valid0 = nbr0 >= 0
    if n:
        if (g["levels"][:n] < 0).any():
            errors.append("unassigned level among first ntotal nodes")
        if (nbr0 >= n).any():
            errors.append("level-0 neighbor id out of range (dangling)")
        self0 = valid0 & (nbr0 == np.arange(n)[:, None])
        if self0.any():
            errors.append("self-link at level 0")
        big = np.iinfo(np.int32).max
        srt = np.sort(np.where(valid0, nbr0, big), axis=1)
        if ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] != big)).any():
            errors.append("duplicate neighbor within a level-0 list")
        deg0 = valid0.sum(1)
        stats["deg0_mean"] = float(deg0.mean())
        stats["deg0_max"] = int(deg0.max())
        stats["isolated0"] = int(((deg0 == 0) & live).sum())
        if live.sum() > 1 and stats["isolated0"] > 0:
            errors.append(f"{stats['isolated0']} isolated nodes at level 0")
        if alive is not None:
            stats["links_to_dead"] = int(
                (valid0 & live[:, None] & ~live[np.maximum(nbr0, 0)]).sum())
        # reciprocity rate (diagnostic, not an error: the heuristic legally
        # prunes one direction); sorted int64 edge keys + searchsorted
        src = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None],
                              nbr0.shape)[valid0]
        dstv = nbr0[valid0].astype(np.int64)
        keys = np.sort(src * n + dstv)
        rev = np.sort(dstv * n + src)
        pos = np.searchsorted(keys, rev)
        found = (pos < len(keys)) & \
            (keys[np.minimum(pos, max(len(keys) - 1, 0))] == rev)
        stats["reciprocity0"] = float(found.mean()) if len(keys) else 1.0

        ep = int(g["entry_point"])
        if not (0 <= ep < n):
            if live.any():
                errors.append(f"entry point {ep} out of range")
        elif g["levels"][ep] != g["max_level"]:
            errors.append("entry point level != max_level")

        nu = int(g["n_upper"])
        up_nodes = g["upper_node"][:nu]
        if (up_nodes < 0).any() or (up_nodes >= n).any():
            errors.append("upper_node table has invalid node id")
        else:
            if not (g["upper_slot"][up_nodes] == np.arange(nu)).all():
                errors.append("upper_slot/upper_node maps are not inverse")
            if int((g["levels"][:n] >= 1).sum()) != nu:
                errors.append("n_upper != #nodes with level>=1")
        if nu and not (up_nodes < 0).any() and not (up_nodes >= n).any():
            node_lv = g["levels"][np.clip(up_nodes, 0, n - 1)]
            for l in range(1, cfg.max_level_cap + 1):
                act = node_lv >= l
                if not act.any():
                    continue
                rows = g["upper_neighbors"][:nu, l - 1][act]
                own = up_nodes[act][:, None]
                v = rows >= 0
                if (rows[v] >= n).any():
                    bad = up_nodes[act][np.any(v & (rows >= n), axis=1)]
                    errors.append(f"dangling upper neighbor at lvl {l} "
                                  f"(e.g. node {int(bad[0])})")
                    continue
                if (g["levels"][rows[v]] < l).any():
                    bad = up_nodes[act][np.any(
                        v & (g["levels"][np.maximum(rows, 0)] < l), axis=1)]
                    errors.append(f"upper neighbor below its level at lvl {l} "
                                  f"(e.g. node {int(bad[0])})")
                    continue
                if (v & (rows == own)).any():
                    bad = up_nodes[act][np.any(v & (rows == own), axis=1)]
                    errors.append(f"self-link at lvl {l} "
                                  f"(e.g. node {int(bad[0])})")

    stats["errors"] = errors
    if strict and errors:
        raise AssertionError("graph invariant violations: " + "; ".join(errors))
    return stats
