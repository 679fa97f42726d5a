"""Sharded mode across processes: two torch-only ranks under gloo on the
CPU, each owning two of four shards (``make_mesh(4, 2, devices=[cpu] * 4)``
on each rank: the reference's tests/test_multihost.py layout, 8 global
devices), held to the one-process port index on the same data: per-shard
graphs edge for edge, and each rank's (D, I) array for array, unpacked and
packed 8-bit, healthy and with shard 1 failed. The one-process index is
held to the reference by tests/test_torch_sharded.py.

This file is also the child: ``python tests/test_torch_multihost.py RANK
WORLD PORT OUT_DIR`` runs one rank and writes what it saw to
``OUT_DIR/rank<RANK>.npz``."""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

N, D, M, EFC, CAP, SEED = 800, 16, 8, 60, 512, 17
K, EF = 10, 64
SHARD_KEY = r"(spill_)?s\d+_"     # a shard's arrays in what a rank saw


def workload():
    from hnsw_tpu_torch.utils.datasets import synthetic_workload
    return synthetic_workload(N, D, n_queries=32, metric="l2", seed=31)


def drive(idx, wl, load_path=None):
    """The calls every rank (and the one-process index) makes, in order:
    build, search unpacked and packed, degraded search, health, a load of
    ``load_path`` searched, tombstones, vacuum, and an sq8 index on the
    same mesh (its quantizer trained where shard 0 lives), and an index
    whose batches spill (``upper_batch_cap`` patched to 2: the shards'
    counts part ways, and each batch's size follows the smallest). Returns
    the arrays to compare."""
    from hnsw_tpu_torch.parallel import sharded
    from hnsw_tpu_torch.parallel.sharded import ShardedHnswIndex
    out = {}
    idx.add(wl.base)
    out["ntotal"] = np.int64(idx.ntotal)
    out["counts"] = idx._counts
    out["D_unpacked"], out["I_unpacked"] = idx.search(wl.queries, K,
                                                      ef_search=EF)
    idx.enable_packed(bits=8)
    out["D_packed"], out["I_packed"] = idx.search(wl.queries, K,
                                                  ef_search=EF)
    idx.mark_shard_failed(1)
    out["D_degraded"], out["I_degraded"] = idx.search(wl.queries, K,
                                                      ef_search=EF)
    out["failed"] = np.array(idx.failed_shards)
    idx.mark_shard_ok(1)
    out["health_ok"] = np.array([r["ok"] for r in idx.health_check()])
    out["check_errors"] = np.array([len(st["errors"])
                                    for st in idx.check()])
    if load_path is not None:
        other = ShardedHnswIndex.load(load_path, mesh=idx.mesh)
        out["D_loaded"], out["I_loaded"] = other.search(wl.queries, K,
                                                        ef_search=EF)
    out["newly_removed"] = np.int64(idx.remove_ids(np.arange(0, N, 5)))
    out["n_deleted"] = np.int64(idx.n_deleted)
    out["D_filtered"], out["I_filtered"] = idx.search(wl.queries, K,
                                                      ef_search=EF)
    out["vacuumed"] = np.int64(idx.vacuum())
    out["packed_after_vacuum"] = np.bool_(idx.packed_enabled)
    out["D_vacuumed"], out["I_vacuumed"] = idx.search(wl.queries, K,
                                                      ef_search=EF)
    sq = ShardedHnswIndex(D, M, "l2", mesh=idx.mesh, capacity_per_shard=CAP,
                          ef_construction=EFC, seed=SEED, dtype="sq8")
    sq.train(wl.base)
    sq.add(wl.base)
    out["sq_offset"], out["sq_scale"] = sq._sq_np
    out["D_sq8"], out["I_sq8"] = sq.search(wl.queries, K, ef_search=EF)
    cap = sharded.upper_batch_cap
    sharded.upper_batch_cap = lambda size, m: 2
    try:
        spill = ShardedHnswIndex(D, M, "l2", mesh=idx.mesh,
                                 capacity_per_shard=CAP,
                                 ef_construction=EFC, seed=5)
        spill.add(wl.base)
    finally:
        sharded.upper_batch_cap = cap
    out.update(shard_arrays(spill, "spill_"))
    out["spill_counts"] = spill._counts
    return out


def shard_arrays(idx, prefix: str = "") -> dict:
    """This process's shards' graph arrays, vectors and user ids, keyed
    ``<prefix>s<shard>_<field>``."""
    from hnsw_tpu_torch.graph import SCALAR_FIELDS, TENSOR_FIELDS
    out = {}
    for s in idx._local:
        g, p = idx._graphs[s], f"{prefix}s{s}_"
        for f in TENSOR_FIELDS:
            out[p + f] = getattr(g, f).cpu().numpy()
        for f in SCALAR_FIELDS:
            out[p + f] = np.int64(getattr(g, f))
        out[p + "vectors"] = idx._vectors[s].cpu().numpy()
        out[p + "global_ids"] = idx._global_ids[s].cpu().numpy()
    return out


def child(rank: int, world: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist
    from hnsw_tpu_torch.parallel.sharded import ShardedHnswIndex, make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(4, 2, devices=[torch.device("cpu")] * 4)
        idx = ShardedHnswIndex(D, M, "l2", mesh=mesh, capacity_per_shard=CAP,
                               ef_construction=EFC, seed=SEED)
        out = drive(idx, workload(), os.path.join(out_dir, "one.npz"))
        out.update(shard_arrays(idx))
        out["local"] = np.array(idx._local)
        out["jax_imported"] = np.bool_("jax" in sys.modules)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


CHILD_TIMEOUT = 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module (tests/test_torch_mutable.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the one-process index's arrays, its shards, each rank's arrays):
    the one-process index saved first, for the ranks to load."""
    from hnsw_tpu_torch.parallel.sharded import ShardedHnswIndex, make_mesh
    out_dir = str(tmp_path_factory.mktemp("multihost"))
    wl = workload()
    mesh = make_mesh(4, 2, devices=[torch.device("cpu")] * 8)
    one = ShardedHnswIndex(D, M, "l2", mesh=mesh, capacity_per_shard=CAP,
                           ef_construction=EFC, seed=SEED)
    one.add(wl.base)
    one.save(os.path.join(out_dir, "one.npz"))
    ref = ShardedHnswIndex(D, M, "l2", mesh=mesh, capacity_per_shard=CAP,
                           ef_construction=EFC, seed=SEED)
    want = drive(ref, wl, os.path.join(out_dir, "one.npz"))
    shards = shard_arrays(ref)
    shards.update({k: v for k, v in want.items()
                   if re.match(SHARD_KEY, k)})
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_PLATFORM_NAME")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2", str(port),
         out_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("multi-process children timed out:\n" + "\n".join(outs))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-20:])
        assert p.returncode == 0, f"rank {rank} rc={p.returncode}:\n{tail}"
    got = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
           for r in range(2)]
    return want, shards, got, wl


def test_ranks_own_their_blocks_of_shards(runs):
    _, _, got, _ = runs
    assert [g["local"].tolist() for g in got] == [[0, 1], [2, 3]]
    assert not any(bool(g["jax_imported"]) for g in got)


def test_graphs_equal_one_process_edge_for_edge(runs):
    """Each rank's shards equal the one-process index's (the other
    shards' level draws replayed, the lockstep schedule followed), also
    where batches spill."""
    want, shards, got, _ = runs
    for g in got:
        np.testing.assert_array_equal(g["spill_counts"],
                                      want["spill_counts"])
    # the spills happened: their levels are not the unpatched build's
    assert not all(np.array_equal(shards[f"s{s}_levels"],
                                  shards[f"spill_s{s}_levels"])
                   for s in range(4))
    seen = set()
    for g in got:
        for key, arr in g.items():
            if re.match(SHARD_KEY, key):
                np.testing.assert_array_equal(arr, shards[key], err_msg=key)
                seen.add(key)
    assert seen == set(shards)


@pytest.mark.parametrize("case", ["unpacked", "packed", "degraded",
                                  "loaded", "filtered", "vacuumed", "sq8"])
def test_each_rank_returns_the_one_process_result(runs, case):
    want, _, got, _ = runs
    for g in got:
        np.testing.assert_array_equal(g[f"I_{case}"], want[f"I_{case}"])
        np.testing.assert_array_equal(g[f"D_{case}"], want[f"D_{case}"])


def test_counts_health_and_check_agree(runs):
    want, _, got, _ = runs
    for g in got:
        assert int(g["ntotal"]) == N
        np.testing.assert_array_equal(g["counts"], want["counts"])
        assert g["failed"].tolist() == [1]
        assert g["health_ok"].all() and not g["check_errors"].any()


def test_tombstones_vacuum_and_quantizer_agree(runs):
    """Every rank keeps the same tombstones, vacuums its own shards (the
    tables dropped), and trains the sq8 quantizer once, where shard 0
    lives, for every rank."""
    want, _, got, _ = runs
    dead = np.arange(0, N, 5)
    for g in got:
        assert int(g["newly_removed"]) == int(g["n_deleted"]) == len(dead)
        assert int(g["vacuumed"]) == len(dead)
        assert not g["packed_after_vacuum"]
        for key in ("I_filtered", "I_vacuumed"):
            assert not np.isin(g[key][g[key] >= 0], dead).any()
        np.testing.assert_array_equal(g["sq_offset"], want["sq_offset"])
        np.testing.assert_array_equal(g["sq_scale"], want["sq_scale"])


def test_recall_and_degraded_serving(runs):
    """The reference test's bars: recall@10 >= 0.9 over the spanning mesh;
    with shard 1 failed the survivors answer and no id = 1 (mod 4)."""
    from conftest import exact_knn   # not in the children: it imports jax
    from hnsw_tpu_torch.utils.recall import recall_at_k
    _, _, got, wl = runs
    _, gt = exact_knn(wl.base, wl.queries, K, "l2")
    for g in got:
        r = recall_at_k(g["I_unpacked"], gt, K)
        assert r >= 0.9, r
        live = g["I_degraded"][g["I_degraded"] >= 0]
        assert live.size and not (live % 4 == 1).any()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    child(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
