"""The sharded sq8 fan-out search (``hnsw_tpu_torch/parallel/sharded.py``):
the sq8 affine kept once per shard, so that a second search of the same
shapes keys and reads the same tensors as the first (on a card: replays its
capture); the fan-out held to a plain exact top-10 over x̂
(``portbench/reference.py``, plain PyTorch that imports nothing of the
program), also with one shard left out of the merge, which must fail the
bar; and the Shards layer's spans and counter, in one process and across
two gloo ranks.

This file is also the child: ``python tests/test_torch_sharded_fanout.py
RANK WORLD PORT OUT_DIR`` runs one rank of the two-rank search and writes
what it saw to ``OUT_DIR/rank<RANK>.npz``."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401  (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import data, reference  # noqa: E402

S, PER_SHARD, D, M, EFC, SEED = 4, 500, 16, 8, 40, 23
N = S * PER_SHARD
TRAIN, NQ, K, EF = 1000, 64, 10, 64
RECALL_BAR, DIST_RTOL = 0.95, 1e-4
CPU = torch.device("cpu")
SEARCH_SPANS = {"hnsw.shard.search", "hnsw.shard.local", "hnsw.shard.merge",
                "hnsw.shard.download"}
ADD_SPANS = {"hnsw.shard.add", "hnsw.shard.plan", "hnsw.shard.stage"}


def workload():
    """(base [N, D], queries [NQ, D]) float32 numpy, a Gaussian mixture."""
    base, queries = data.gaussian_mixture(N, D, NQ, 2_147_483_711, CPU,
                                          n_clusters=16)
    return base.numpy(), queries.numpy()


def new_index(devices):
    from hnsw_tpu_torch.parallel.sharded import ShardedHnswIndex, make_mesh
    return ShardedHnswIndex(D, M, "l2", mesh=make_mesh(S, 1, devices=devices),
                            capacity_per_shard=PER_SHARD,
                            ef_construction=EFC, ef_search=EF, seed=SEED,
                            dtype="sq8")


def build(devices, base):
    idx = new_index(devices)
    idx.train(base[:TRAIN])
    idx.add(base)
    return idx


@pytest.fixture(scope="module")
def built():
    """(index, base, queries, the build's trace table): 4 shards of 500 on
    the CPU in one process."""
    from hnsw_tpu_torch import trace
    base, queries = workload()
    with trace.collect() as t:
        idx = build([CPU] * S, base)
    return idx, base, queries, t


def xhat(base):
    return reference.stored_rows({"dtype": "sq8", "sq_train_rows": TRAIN},
                                 torch.from_numpy(base))


def judge(base, queries, d, i):
    """(recall@K against the exact top-K over x̂, widest relative gap of a
    returned distance to the float64 squared L2 to its id's x̂, entries
    that are no answer: an id outside [0, N) or twice in a row)."""
    rows = xhat(base)
    q = torch.from_numpy(queries)
    truth, _ = reference.exact_topk(q, rows, K)
    ids = torch.from_numpy(i)
    recall = reference.hits(ids, truth) / ids.numel()
    bad = int(((ids < 0) | (ids >= N)).sum())
    s = torch.sort(ids, 1).values
    bad += int((s[:, 1:] == s[:, :-1]).sum())
    want = reference.pair_dist(q, rows[ids.clamp(0, N - 1)])
    gap = float(((torch.from_numpy(d).double() - want).abs()
                 / want.abs().clamp(min=1e-12)).max())
    return recall, gap, bad


def keys_of_searches(monkeypatch, idx, queries, times=2):
    """The ``search.search_key`` of every shard search each of ``times``
    sharded searches made, one list a search."""
    from hnsw_tpu_torch import search
    from hnsw_tpu_torch.parallel import sharded
    real, got = sharded.hnsw_search, []

    def spy(graph, storage, q, **kw):
        got[-1].append(search.search_key(graph, storage, q, **kw))
        return real(graph, storage, q, **kw)
    monkeypatch.setattr(sharded, "hnsw_search", spy)
    for _ in range(times):
        got.append([])
        idx.search(queries, K, ef_search=EF)
    monkeypatch.setattr(sharded, "hnsw_search", real)
    return got


def test_sq_affine_kept_once_per_shard(monkeypatch, tmp_path):
    """Each shard's ``Storage`` holds the shared sq8 affine as tensors made
    once on its device: the same objects through searches, a second
    ``add``, ``enable_packed``, ``vacuum`` and a save / load round trip
    (the loaded index's own, equal in value and kept alike), and two
    searches of the same shapes key alike (a card replays the first one's
    capture)."""
    base, queries = workload()
    idx = new_index([CPU] * S)
    idx.train(base[:TRAIN])
    idx.add(base[:N // 2])
    held = [idx._storage[s].sq for s in range(S)]
    host = idx._codec.codec_arrays()
    for s, sq in enumerate(held):
        assert sq is not None
        for t, a in zip(sq, (host["sq_offset"], host["sq_scale"])):
            assert t.device == idx._dev[s]
            np.testing.assert_array_equal(t.numpy(), a)
    first, second = keys_of_searches(monkeypatch, idx, queries)
    assert len(first) == S and first == second
    idx.add(base[N // 2:])
    assert all(idx._storage[s].sq is held[s] for s in range(S))
    first, second = keys_of_searches(monkeypatch, idx, queries)
    assert first == second
    path = str(tmp_path / "sharded.npz")
    idx.save(path)
    idx.enable_packed(bits=8)
    assert all(idx._storage[s].sq is held[s] for s in range(S))
    first, second = keys_of_searches(monkeypatch, idx, queries)
    assert first == second
    idx.remove_ids(np.arange(0, N, 7))
    idx.vacuum()
    assert all(idx._storage[s].sq is held[s] for s in range(S))
    from hnsw_tpu_torch.parallel.sharded import ShardedHnswIndex
    loaded = ShardedHnswIndex.load(path, mesh=idx.mesh)
    kept = [loaded._storage[s].sq for s in range(S)]
    for s in range(S):
        assert kept[s] is not None
        for t, u in zip(kept[s], held[s]):
            assert torch.equal(t, u)
    first, second = keys_of_searches(monkeypatch, loaded, queries)
    assert first == second
    assert all(loaded._storage[s].sq is kept[s] for s in range(S))


def test_flat_storage_has_no_affine():
    from hnsw_tpu_torch.parallel.sharded import ShardedHnswIndex, make_mesh
    idx = ShardedHnswIndex(D, M, "l2", mesh=make_mesh(S, 1, [CPU] * S),
                           capacity_per_shard=PER_SHARD)
    assert all(idx._storage[s].sq is None for s in range(S))


def test_fanout_against_exact_topk_over_xhat(built):
    idx, base, queries, _ = built
    d, i = idx.search(queries, K, ef_search=EF)
    recall, gap, bad = judge(base, queries, d, i)
    assert recall >= RECALL_BAR, recall
    assert gap <= DIST_RTOL, gap
    assert bad == 0


def test_a_shard_left_out_of_the_merge_fails_the_bar(built, monkeypatch):
    from hnsw_tpu_torch.parallel import sharded
    idx, base, queries, _ = built
    real = sharded.merge_topk
    monkeypatch.setattr(sharded, "merge_topk",
                        lambda ds, ids, k: real(ds[:-1], ids[:-1], k))
    d, i = idx.search(queries, K, ef_search=EF)
    recall, gap, bad = judge(base, queries, d, i)
    assert recall < RECALL_BAR, recall
    assert gap <= DIST_RTOL and bad == 0     # what it returns is exact


def test_spans_in_one_process(built):
    """One process has no exchange: no ``.gather`` phase, no gathered
    bytes; the search's and the lockstep build's spans nest as named."""
    from hnsw_tpu_torch import trace
    idx, _, queries, build_table = built
    with trace.collect() as t:
        idx.search(queries, K, ef_search=EF)
    for name in SEARCH_SPANS:
        assert t.calls(name) == 1, name
    for name in ("hnsw.shard.local", "hnsw.shard.merge",
                 "hnsw.shard.download"):
        assert t.calls(name, parent="hnsw.shard.search") == 1, name
    assert t.calls("hnsw.search", parent="hnsw.shard.local") == 0
    assert t.calls("hnsw.search.plan") == S
    assert t.calls("hnsw.shard.gather") == 0
    assert "shard.gathered_bytes" not in t.counters
    for name in ADD_SPANS:
        assert build_table.calls(name) == 1, name
    for name in ("hnsw.shard.plan", "hnsw.shard.stage"):
        assert build_table.calls(name, parent="hnsw.shard.add") == 1


def test_tracing_off_records_nothing(built):
    from hnsw_tpu_torch import trace
    idx, _, queries, _ = built
    before = trace.totals()
    idx.search(queries, K, ef_search=EF)
    assert trace.totals().minus(before).spans == {}


def child(rank: int, world: int, port: int, out_dir: str) -> None:
    """One of two gloo ranks, each owning two of the four shards: build,
    one search under ``trace.collect()``; writes the span names, the
    counter, the phases' parent and (D, I)."""
    import torch.distributed as dist
    from hnsw_tpu_torch import trace
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        base, queries = workload()
        idx = build([CPU] * (S // world), base)
        with trace.collect() as t:
            d, i = idx.search(queries, K, ef_search=EF)
        names = sorted({n for n, _ in t.spans})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), d=d, i=i,
                 local=np.array(idx._local),
                 table=np.bytes_(json.dumps({
                     "names": names,
                     "gather_parent": t.calls("hnsw.shard.gather",
                                              parent="hnsw.shard.search"),
                     "counters": t.counters})))
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


def test_spans_across_two_ranks(built, tmp_path):
    """Two gloo ranks: every rank's search has the ``.gather`` phase and
    counts the bytes its ``all_gather`` brought ([2 ranks x 2 shards, 2,
    Q, k] float32), and returns the one-process index's (D, I)."""
    idx, _, queries, _ = built
    want_d, want_i = idx.search(queries, K, ef_search=EF)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_PLATFORM_NAME")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2", str(port),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("the two ranks timed out:\n" + "\n".join(outs))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-20:])
        assert p.returncode == 0, f"rank {rank} rc={p.returncode}:\n{tail}"
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert got["local"].tolist() == [2 * r, 2 * r + 1]
        table = json.loads(bytes(got["table"]).decode())
        assert SEARCH_SPANS | {"hnsw.shard.gather"} <= set(table["names"])
        assert table["gather_parent"] == 1
        assert table["counters"]["shard.gathered_bytes"] == \
            2 * 2 * 2 * NQ * K * 4
        np.testing.assert_array_equal(got["i"], want_i)
        np.testing.assert_array_equal(got["d"], want_d)


if __name__ == "__main__":
    child(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
