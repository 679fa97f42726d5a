"""The repository's entry points, ported from its ``__graft_entry__.py``,
on the card.

* ``entry()`` — a single-device search step over a small prebuilt index:
  the batched HNSW beam-search query pipeline over a 384-point graph from
  the host builder (``reference_impl.NumpyHnsw``). On a CUDA device the
  search is a captured CUDA graph (``graphs.py``): its first call captures,
  later calls replay.
* ``dryrun_multichip(n)`` — an n-device mesh (dataset-shard axis x query
  axis): a sharded build, a fan-out search and its merge, packed bytes and
  words rows, a degrade and restore, and ``remove_ids`` + ``vacuum()``,
  each held to the reference's thresholds. It prints the reference's
  ``[dryrun]`` lines.

Both take the card by default and raise without one. Where the reference
re-runs its dry run on a virtual CPU mesh when fewer devices are attached,
this one places the mesh on the visible cards, a card repeated when there
are fewer cards than shards: one H100 holds every shard of the dry run.
The CPU runs only when the caller asks for it (``device="cpu"``,
``devices=[torch.device("cpu")] * n``), as the tests do.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from .config import HnswConfig
from .graph import graph_from_numpy
from .ops._cuda import default_device
from .ops.storage import Storage
from .parallel.sharded import ShardedHnswIndex, make_mesh
from .reference_impl import NumpyHnsw
from .search import hnsw_search
from .utils.recall import recall_at_k


def _tiny_index(n=384, d=16, m=8, seed=0, device=None):
    """The reference's tiny index: ``n`` x ``d`` normal points through the
    host builder, the graph and vectors carried to ``device`` (default: the
    card). Returns (graph, vectors, rng), the generator past the points."""
    device = default_device() if device is None else torch.device(device)
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, d)).astype(np.float32)
    idx = NumpyHnsw(HnswConfig(dim=d, m=m, capacity=512, ef_construction=40,
                               seed=seed))
    idx.add(base)
    graph = graph_from_numpy(idx.to_graph_arrays(), device)
    vectors = torch.from_numpy(idx.vectors).to(device, copy=True)
    return graph, vectors, rng


def entry(device=None):
    """Returns (fn, example_args): the batched HNSW search step
    ``fn(graph, storage, queries)`` -> (dists [64, 10], ids [64, 10]) and
    its arguments on ``device`` (default: the card), 64 queries drawn after
    the index's points."""
    graph, vectors, rng = _tiny_index(device=device)
    queries = np.asarray(rng.normal(size=(64, vectors.shape[1])), np.float32)

    def fn(graph, storage, queries):
        return hnsw_search(graph, storage, queries, k=10, ef_search=32,
                           metric="l2", max_level_cap=6)

    return fn, (graph, Storage(vectors),
                torch.from_numpy(queries).to(vectors.device))


def _require(ok, msg: str) -> None:
    """A dry-run check: raises when it fails (also under ``python -O``)."""
    if not ok:
        raise AssertionError(msg)


def _mesh_devices(n_devices: int, q_parallel: int, devices) -> list:
    """``devices[:n_devices]``, or the visible cards with shard s on card
    s mod count (a mesh row is one device); no card raises."""
    if devices is not None:
        return [torch.device(d) for d in devices][:n_devices]
    if not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device is available; "
                           "pass devices=[torch.device('cpu')] * n to run "
                           "on the CPU")
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    return [cards[s % len(cards)] for s in range(n_devices // q_parallel)
            for _ in range(q_parallel)]


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """One sharded build and the reference's checks over an
    ``n_devices`` mesh (``q`` = 2 where ``n_devices`` is even). ``devices``:
    the mesh's devices in order (default: the visible cards, repeated).
    Every check that fails raises. Returns what it measured: the recalls,
    ``ntotal``, per-shard ``counts``, the ``mesh`` shape, the fan-out ids,
    the ``victims`` removed, and the ``index`` and ``queries`` it ends
    with. With the reference's sizes, ``n_devices`` of 1, 2 or 4 leaves
    10,007 points to fewer than three shards of 4,096 rows, and ``add()``
    raises, as the reference's dry run does."""
    q_parallel = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_shards = n_devices // q_parallel
    mesh = make_mesh(n_shards=n_shards, q_parallel=q_parallel,
                     devices=_mesh_devices(n_devices, q_parallel, devices))

    rng = np.random.default_rng(7)
    d = 16
    # uneven shard fill on purpose: n is not a multiple of the shard count,
    # so the round-robin remainder path runs end to end
    n = 10_007 if n_devices <= 16 else 1251 * n_devices
    base = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(32, d)).astype(np.float32)

    idx = ShardedHnswIndex(d, 8, "l2", mesh=mesh,
                           capacity_per_shard=1 << 12,
                           ef_construction=40, seed=5)
    idx.add(base)
    _require(idx.ntotal == len(base), f"ntotal {idx.ntotal} after {n} adds")
    _require(n % n_shards != 0, "dryrun must cover uneven shards")
    print(f"[dryrun] build OK: n={n} over {n_shards} uneven shards "
          f"(mesh={dict(mesh.shape)})")

    dmat = ((queries[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(dmat, axis=1)[:, :5]
    recalls = {}

    def check_search(tag, floor=0.95):
        _, ids = idx.search(queries, k=5, ef_search=32)
        _require(ids.shape == (32, 5), f"{tag}: ids of shape {ids.shape}")
        _require((ids < len(base)).all(), f"{tag}: an id past ntotal")
        r = recall_at_k(ids, gt, 5)
        _require(r > floor, f"{tag}: sharded recall@5 {r}")
        print(f"[dryrun] {tag} OK: recall@5={r:.3f}")
        recalls[tag] = r
        return ids

    ids_plain = check_search("fan-out search")

    # packed per-shard serving: bytes and words rows hold the same codes,
    # so they must return the same ids
    idx.enable_packed(bits=8, layout="bytes")
    ids_b = idx.search(queries, k=5, ef_search=32)[1]
    idx.enable_packed(bits=8, layout="words")
    ids_w = idx.search(queries, k=5, ef_search=32)[1]
    _require((ids_b == ids_w).all(), "packed bytes/words layout divergence")
    rp = recall_at_k(ids_w, gt, 5)
    _require(rp > 0.95, f"packed sharded recall@5 {rp}")
    recalls["packed"] = rp
    print(f"[dryrun] packed per-shard serving OK: bytes==words, "
          f"recall@5={rp:.3f}")
    idx.disable_packed()

    # elastic degrade -> restore: losing one shard must keep serving (fewer
    # results allowed), restoring must bring its ids back
    ckpt = io.BytesIO()
    idx.save(ckpt)
    idx.mark_shard_failed(0)
    _, i_deg = idx.search(queries, k=5, ef_search=32)
    _require(i_deg.shape == (32, 5), f"degraded ids of shape {i_deg.shape}")
    lost = np.setdiff1d(np.unique(ids_plain), np.unique(i_deg))
    _require(all(int(g) % n_shards == 0 or g < 0 for g in lost),
             "degraded search lost ids outside the failed shard")
    ckpt.seek(0)
    idx.restore_shards(ckpt, [0])
    _require(idx.failed_shards == [], f"failed after restore: "
             f"{idx.failed_shards}")
    check_search("degrade/restore")
    print("[dryrun] elastic degrade -> restore OK")

    # deletion + sharded vacuum: removed ids never come back
    victims = np.asarray(ids_plain[:, 0][:8])
    victims = np.unique(victims[victims >= 0])
    idx.remove_ids(victims)
    idx.vacuum()
    _, i_after = idx.search(queries, k=5, ef_search=32)
    _require(not np.intersect1d(np.unique(i_after), victims).size,
             "vacuumed ids resurfaced")
    print(f"[dryrun] remove_ids + sharded vacuum OK "
          f"({len(victims)} ids gone)")

    print(f"dryrun_multichip({n_devices}): mesh={dict(mesh.shape)} "
          f"ntotal={idx.ntotal} all sub-checks OK")
    return {"recalls": recalls, "ntotal": idx.ntotal,
            "counts": np.asarray(idx._counts).copy(),
            "mesh": dict(mesh.shape), "fanout_ids": ids_plain,
            "victims": victims, "index": idx, "queries": queries}
