"""The repository's entry points in the port (hnsw_tpu_torch.dryrun)
against the reference's (``__graft_entry__.py``), on the CPU.

``entry()``: the port's tiny index is the reference's, edge for edge in
every field, and its search step returns the reference's ids (the
reference's step jitted, its beam kernel in interpret mode as in
tests/test_torch_search.py) on >= 99% of slots, with the distances of those
within rtol 1e-5 + atol 1e-5: the search parity bar of
tests/test_torch_search.py ``_assert_same_search``.

``dryrun_multichip(8)`` (the device count of the recorded TPU runs,
MULTICHIP_r01-r05.json) on ``[cpu] * 8`` passes its own checks, and its
ntotal, per-shard counts and fan-out ids equal those of the reference's
``ShardedHnswIndex`` built in this process on conftest's 8 virtual devices
from the same ``default_rng(7)`` inputs and arguments: the ids exactly,
stricter than tests/test_torch_sharded.py's bar (>= 99% of slots).
``dryrun_multichip(4)`` puts 10,007 points on 2 shards of 4,096 rows: both
packages raise "capacity_per_shard exceeded".

With no card both entry points raise before any work: nothing falls back
to the CPU."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from hnsw_tpu.parallel.sharded import ShardedHnswIndex as RefSharded
from hnsw_tpu.parallel.sharded import make_mesh as ref_mesh
from hnsw_tpu_torch import dryrun
from hnsw_tpu_torch.graph import SCALAR_FIELDS, TENSOR_FIELDS

from torch_threads import one_torch_thread  # noqa: F401  (a fixture)

CPU = torch.device("cpu")


def test_entry_graph_matches_reference():
    """The tiny index: every graph field and the vectors, and the queries
    drawn after it."""
    rg, rv, _, rrng = ref_entry._tiny_index()
    g, v, rng = dryrun._tiny_index(device="cpu")
    for f in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(rg, f)), err_msg=f)
    for f in SCALAR_FIELDS:
        assert getattr(g, f) == int(np.asarray(getattr(rg, f))), f
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    assert v.device == CPU and g.neighbors0.device == CPU
    assert rng.bit_generator.state == rrng.bit_generator.state


def test_entry_search_matches_reference(monkeypatch):
    monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
    ref_fn, ref_args = ref_entry.entry()
    rd, ri = jax.jit(ref_fn)(*ref_args)
    fn, args = dryrun.entry(device="cpu")
    np.testing.assert_array_equal(args[2].numpy(), np.asarray(ref_args[3]))
    d, i = fn(*args)
    rd, ri, d, i = np.asarray(rd), np.asarray(ri), d.numpy(), i.numpy()
    assert i.shape == ri.shape == (64, 10)
    same = i == ri
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(d[same], rd[same], rtol=1e-5, atol=1e-5)
    # a second call is the same step again
    d2, i2 = fn(*args)
    assert torch.equal(i2, torch.from_numpy(i))


def test_dryrun_matches_reference(capsys):
    out = dryrun.dryrun_multichip(8, devices=[CPU] * 8)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == ("[dryrun] build OK: n=10007 over 4 uneven shards "
                          "(mesh={'shard': 4, 'q': 2})")
    assert printed[-1] == ("dryrun_multichip(8): mesh={'shard': 4, 'q': 2} "
                           "ntotal=10007 all sub-checks OK")
    assert [ln.split(":")[0] for ln in printed[1:-1]] == [
        "[dryrun] fan-out search OK", "[dryrun] packed per-shard serving OK",
        "[dryrun] degrade/restore OK",
        "[dryrun] elastic degrade -> restore OK",
        "[dryrun] remove_ids + sharded vacuum OK (8 ids gone)"]
    assert out["mesh"] == {"shard": 4, "q": 2}
    assert min(out["recalls"].values()) > 0.95
    assert all(st.rows.device == CPU for st in out["index"]._storage)

    # the reference's build and fan-out search on the same inputs
    rng = np.random.default_rng(7)
    base = rng.normal(size=(10_007, 16)).astype(np.float32)
    queries = rng.normal(size=(32, 16)).astype(np.float32)
    np.testing.assert_array_equal(out["queries"], queries)
    ref = RefSharded(16, 8, "l2",
                     mesh=ref_mesh(n_shards=4, q_parallel=2,
                                   devices=jax.devices()[:8]),
                     capacity_per_shard=1 << 12, ef_construction=40, seed=5)
    ref.add(base)
    _, ri = ref.search(queries, k=5, ef_search=32)
    assert out["ntotal"] == ref.ntotal == 10_007
    np.testing.assert_array_equal(out["counts"], np.asarray(ref._counts))
    np.testing.assert_array_equal(out["fanout_ids"], np.asarray(ri))
    victims = np.unique(np.asarray(ri)[:8, 0])
    np.testing.assert_array_equal(out["victims"], victims)


def test_dryrun_on_two_shards_raises_as_reference():
    """n=4 is 2 shards x q 2: 5,004 points a shard over 4,096 rows."""
    with pytest.raises(ValueError, match="capacity_per_shard exceeded"):
        ref_entry.dryrun_multichip(4)
    with pytest.raises(ValueError, match="capacity_per_shard exceeded"):
        dryrun.dryrun_multichip(4, devices=[CPU] * 4)


def test_no_card_raises(monkeypatch):
    """Without a card neither entry point runs: no index is made, nothing
    runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def refuse(*a, **k):
        raise AssertionError("built an index without a card")
    monkeypatch.setattr(dryrun, "ShardedHnswIndex", refuse)
    monkeypatch.setattr(dryrun, "NumpyHnsw", refuse)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
