"""The port's persistence and utilities against the reference, on the CPU:
``save`` / ``load`` across the two packages both ways (f32, sq8, PQ and
bf16 storage), ``to_bytes`` / ``from_bytes``, files with tombstones,
``utils/stats.py`` and the dataset readers. Twins of
tests/test_serialization.py, tests/test_stats.py and
tests/test_datasets.py."""

import struct

import numpy as np
import pytest
import torch

import hnsw_tpu
import hnsw_tpu_torch
from hnsw_tpu.utils import datasets as ref_ds
from hnsw_tpu.utils.stats import HnswStats as RefStats
from hnsw_tpu_torch.utils import datasets as ds
from hnsw_tpu_torch.utils.stats import HnswStats, Timer

WL = dict(n=400, d=16, n_queries=40, seed=3)
IDX = dict(capacity=512, ef_construction=40, seed=11)
CODECS = {"float32": {}, "sq8": {}, "pq": dict(pq_m=4), "bfloat16": {}}


@pytest.fixture(scope="module")
def workload():
    return hnsw_tpu_torch.synthetic_workload(WL["n"], WL["d"],
                                             n_queries=WL["n_queries"],
                                             seed=WL["seed"])


def _port_index(dtype, workload):
    idx = hnsw_tpu_torch.HnswIndex(WL["d"], 8, "l2", dtype=dtype,
                                   device="cpu", **IDX, **CODECS[dtype])
    idx.train(workload.base)
    idx.add(workload.base)
    return idx


def _assert_same_arrays(port, ref):
    for k, v in port.graph.numpy().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ref.graph, k)))
    np.testing.assert_array_equal(port.vectors.float().numpy(),
                                  np.asarray(ref.vectors, np.float32))
    for a, b in ((port._sq_np, ref._sq_np), (port._pq_np, ref._pq_np)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("dtype", list(CODECS))
def test_save_load_across_packages(dtype, workload, tmp_path, monkeypatch):
    """A port index saved, loaded by the reference, saved by it, and loaded
    by the port again: identical arrays and codec state at each step; the
    same keys in both packages' files; the reference's search of what it
    loaded returns the port's ids (>= 99%; its Pallas kernels in interpret
    mode, not for bf16, whose f32-widened vectors the reference searches
    as f32); and the port's search after the round trip is the original's,
    ids and distances."""
    port = _port_index(dtype, workload)
    p1, p2 = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    port.save(p1)
    ref = hnsw_tpu.HnswIndex.load(p1)
    assert ref.config.to_json() == port.config.to_json() and ref.is_trained
    _assert_same_arrays(port, ref)
    ref.save(p2)
    with np.load(p1) as a, np.load(p2) as b:
        assert sorted(a.files) == sorted(b.files)
    again = hnsw_tpu_torch.HnswIndex.load(p2, device="cpu")
    _assert_same_arrays(again, ref)
    assert again.vectors.dtype == port.vectors.dtype
    d, i = port.search(workload.queries, 10, ef_search=32)
    d2, i2 = again.search(workload.queries, 10, ef_search=32)
    np.testing.assert_array_equal(i2, i)
    np.testing.assert_array_equal(d2, d)
    # the level RNG carries over both ways
    assert again._builder.rng.random() == port._builder.rng.random()
    if dtype != "bfloat16":
        monkeypatch.setenv("HNSW_TPU_BEAM_KERNEL", "1")
        rd, ri = ref.search(workload.queries, 10, ef_search=32)
        same = ri == i
        assert same.mean() >= 0.99, same.mean()
        np.testing.assert_allclose(d[same], rd[same], rtol=1e-5, atol=1e-5)


def test_to_bytes_from_bytes_roundtrip(workload):
    """faiss serialize / deserialize: a blob in the save format, the same
    search after the round trip, readable by the reference."""
    port = _port_index("sq8", workload)
    blob = port.to_bytes()
    assert isinstance(blob, bytes) and blob[:2] == b"PK"   # a zip (npz)
    back = hnsw_tpu_torch.HnswIndex.from_bytes(blob, device="cpu")
    d, i = port.search(workload.queries, 5)
    d2, i2 = back.search(workload.queries, 5)
    np.testing.assert_array_equal(i2, i)
    np.testing.assert_array_equal(d2, d)
    _assert_same_arrays(back, hnsw_tpu.HnswIndex.from_bytes(blob))


def test_load_of_unported_state_raises(workload, tmp_path):
    """What stays unported is refused by name: a file with tombstones
    (xarr_alive, ROADMAP A9), add() while packed tables are enabled (A4),
    the host builder (A5), and PQ-coded routing rows with 4-bit codes on
    8-bit codebooks."""
    port = _port_index("float32", workload)
    p1, p2 = str(tmp_path / "port.npz"), str(tmp_path / "dead.npz")
    port.save(p1)
    ref = hnsw_tpu.HnswIndex.load(p1)
    ref.remove_ids(np.array([3, 7]))
    ref.save(p2)
    with pytest.raises(NotImplementedError, match="A9"):
        hnsw_tpu_torch.HnswIndex.load(p2, device="cpu")
    port.enable_packed(mode="pq", pq_m=4, train_x=workload.base)
    with pytest.raises(NotImplementedError, match="A4"):
        port.add(workload.base[:2])
    with pytest.raises(NotImplementedError, match="A5"):
        hnsw_tpu_torch.HnswIndex(8, 4, capacity=64, dtype="sq8",
                                 build="host", device="cpu")
    from hnsw_tpu_torch.ops.packed import pack_pq_neighbors
    with pytest.raises(ValueError, match="ksub"):
        pack_pq_neighbors(port.graph.neighbors0, port._route[1],
                          port._route[0], pq_bits=4)


class _FakeStats:
    def __init__(self, hops, ndis):
        self.hops = hops
        self.ndis = ndis


def test_stats_accumulate_and_summary_match_reference():
    """HnswStats on numpy and on tensor ndis, against the reference's."""
    ref, port = RefStats(), HnswStats()
    for hops, nd, wall in ((40, 500, 0.05), (60, 700, 0.07), (9, 3, 0.01)):
        ref.accumulate(100, _FakeStats(hops, np.full(100, nd)), wall=wall)
        port.accumulate(100, _FakeStats(hops, torch.full((100,), nd,
                                                         dtype=torch.int32)),
                        wall=wall)
    assert port.summary() == ref.summary()
    assert port.summary()["ndis_per_query"] == 1203 / 3
    port.reset()
    assert port.nqueries == 0 and port.summary()["qps"] == 0.0
    with Timer() as tm:
        sum(range(1000))
    assert tm.elapsed >= 0.0


def _write_vecs(path, arr, dtype):
    """TEXMEX rows: [int32 d][d values of ``dtype``]."""
    with open(path, "wb") as f:
        for row in arr:
            f.write(struct.pack("<i", len(row)))
            f.write(np.asarray(row, dtype).tobytes())


def test_readers_match_reference(tmp_path):
    """fvecs / ivecs / bvecs / fbin (with and without ``count``) and
    ann-benchmarks HDF5, each on a file the test writes, against the
    reference's reader."""
    rng = np.random.default_rng(0)
    f = rng.normal(size=(17, 9)).astype(np.float32)
    iv = rng.integers(0, 1000, size=(7, 10)).astype(np.int32)
    bv = rng.integers(0, 256, size=(6, 12)).astype(np.uint8)
    _write_vecs(tmp_path / "x.fvecs", f, np.float32)
    _write_vecs(tmp_path / "x.ivecs", iv, np.int32)
    _write_vecs(tmp_path / "x.bvecs", bv, np.uint8)
    with open(tmp_path / "x.fbin", "wb") as fh:
        fh.write(struct.pack("<ii", *f.shape))
        fh.write(f.tobytes())
    for name, reader, want in (("x.fvecs", "read_fvecs", f),
                               ("x.ivecs", "read_ivecs", iv),
                               ("x.bvecs", "read_bvecs", bv),
                               ("x.fbin", "read_fbin", f)):
        p = str(tmp_path / name)
        got = getattr(ds, reader)(p)
        np.testing.assert_array_equal(got, getattr(ref_ds, reader)(p))
        np.testing.assert_array_equal(got, want.astype(got.dtype))
        np.testing.assert_array_equal(getattr(ds, reader)(p, count=3),
                                      getattr(ref_ds, reader)(p, count=3))
    (tmp_path / "empty.fvecs").write_bytes(b"")
    assert ds.read_fvecs(str(tmp_path / "empty.fvecs")).shape == (0, 0)
    bad = tmp_path / "bad.fvecs"
    _write_vecs(bad, f, np.float32)
    raw = bytearray(bad.read_bytes())
    raw[40:44] = struct.pack("<i", 3)         # row 1's dim field
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="inconsistent"):
        ds.read_fvecs(str(bad))
    import h5py
    h = str(tmp_path / "g.hdf5")
    with h5py.File(h, "w") as fh:
        fh["train"], fh["test"] = f, f[:3]
        fh["neighbors"] = iv[:3]
        fh.attrs["distance"] = "angular"
    got, want = ds.read_ann_benchmarks_hdf5(h), \
        ref_ds.read_ann_benchmarks_hdf5(h)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert got[3] == want[3] == "angular"


def test_eval_workload_matches_reference(tmp_path, monkeypatch):
    """load_eval_workload: real files shape-checked (a wrong row count is
    refused), loaded as the reference loads them; absent files fall back
    to the same synthetic workload; the named configs are the
    reference's."""
    assert ds._EVAL_CONFIGS == ref_ds._EVAL_CONFIGS
    rng = np.random.default_rng(3)
    base = rng.normal(size=(50, 128)).astype(np.float32)
    q = rng.normal(size=(5, 128)).astype(np.float32)
    gt = np.tile(np.arange(10, dtype=np.int32), (5, 1))
    d = tmp_path / "siftsmall"
    d.mkdir()
    _write_vecs(d / "siftsmall_base.fvecs", base, np.float32)
    _write_vecs(d / "siftsmall_query.fvecs", q, np.float32)
    _write_vecs(d / "siftsmall_groundtruth.ivecs", gt, np.int32)
    with pytest.raises(ValueError, match="expected 10000 rows"):
        ds.load_eval_workload("sift10k", data_dir=str(tmp_path))
    with pytest.raises(ValueError, match="expected dim 96"):
        ds._validate_shape("deep10m", "base", base, None, 96)
    monkeypatch.setitem(ds._EVAL_CONFIGS["sift10k"], "n", 50)
    monkeypatch.setitem(ref_ds._EVAL_CONFIGS["sift10k"], "n", 50)
    wl = ds.load_eval_workload("sift10k", data_dir=str(tmp_path))
    rw = ref_ds.load_eval_workload("sift10k", data_dir=str(tmp_path))
    assert wl.name == rw.name == "sift10k" and wl.metric == rw.metric
    for a, b in ((wl.base, rw.base), (wl.queries, rw.queries),
                 (wl.ground_truth, rw.ground_truth)):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setitem(ds._EVAL_CONFIGS["sift10k"], "n", 300)
    monkeypatch.setitem(ref_ds._EVAL_CONFIGS["sift10k"], "n", 300)
    wl = ds.load_eval_workload("sift10k", data_dir=str(tmp_path / "no"),
                               n_queries=20)
    rw = ref_ds.load_eval_workload("sift10k", data_dir=str(tmp_path / "no"),
                                   n_queries=20)
    assert wl.name == rw.name == "sift10k-synthetic"
    np.testing.assert_array_equal(wl.base, rw.base)
    np.testing.assert_array_equal(wl.queries, rw.queries)
