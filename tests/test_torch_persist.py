"""The port's persistence and utilities against the reference, on the CPU:
``save`` / ``load`` across the two packages both ways (f32, sq8, PQ and
bf16 storage), ``to_bytes`` / ``from_bytes``, what stays unported,
``utils/stats.py`` and the dataset readers (files with tombstones:
tests/test_torch_mutable.py). Twins of
tests/test_serialization.py, tests/test_stats.py and
tests/test_datasets.py."""

import struct

import numpy as np
import pytest
import torch

import hnsw_tpu
import hnsw_tpu_torch
from hnsw_tpu.utils import datasets as ref_ds
from hnsw_tpu.utils.recall import recall_at_k
from hnsw_tpu.utils.stats import HnswStats as RefStats
from hnsw_tpu_torch.utils import datasets as ds
from hnsw_tpu_torch.utils.stats import HnswStats, Timer

from conftest import exact_knn
from torch_threads import one_torch_thread  # noqa: F401  (a fixture)

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
    want = {}
    if ref._sq_np is not None:
        want["sq_offset"], want["sq_scale"] = ref._sq_np
    if ref._pq_np is not None:
        want["pq_codebooks"] = ref._pq_np
    got = port._storage.codec_arrays()
    assert got.keys() == want.keys()
    for k, b in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(b))


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


def test_id_filter_matches_reference_on_a_full_index(workload, tmp_path):
    """On a full index (ntotal == capacity, so id capacity - 1 is stored),
    an int id filter selects the reference's ids. Ids [-1, 2, capacity,
    -capacity, -capacity - 1] as a tensor (the reference: a jax.Array,
    scattered with mode="drop") select capacity - 1, 2 and 0 and drop the
    rest; the in-range list [-1, 2] selects capacity - 1 and 2 as a numpy
    list in both packages and as a tensor in the port. Self-queries of the
    selected ids, so each search finds them first (-1 pads a row where
    fewer than k allowed ids were found)."""
    import jax.numpy as jnp
    n = WL["n"]
    port = hnsw_tpu_torch.HnswIndex(WL["d"], 8, "l2", device="cpu",
                                    capacity=n, ef_construction=40, seed=11)
    port.add(workload.base)
    assert port.ntotal == port.config.capacity == n
    path = str(tmp_path / "full.npz")
    port.save(path)
    ref = hnsw_tpu.HnswIndex.load(path)
    q = workload.base[[n - 1, 2, 0, 7]]
    wide = [-1, 2, n, -n, -n - 1]
    rd, ri = ref.search(q, 2, ef_search=32,
                        allowed=jnp.asarray(wide, jnp.int32))
    d, i = port.search(q, 2, ef_search=32, allowed=torch.tensor(wide))
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(d, rd, rtol=1e-5, atol=1e-5)
    assert set(i.ravel()) <= {n - 1, 2, 0, -1}    # -1: fewer than k found
    assert list(i[:3, 0]) == [n - 1, 2, 0]
    narrow = np.array([-1, 2])
    rd, ri = ref.search(q, 2, ef_search=32, allowed=narrow)
    for allowed in (narrow, torch.from_numpy(narrow)):
        d, i = port.search(q, 2, ef_search=32, allowed=allowed)
        np.testing.assert_array_equal(i, ri)
        np.testing.assert_allclose(d, rd, rtol=1e-5, atol=1e-5)
        assert set(i.ravel()) <= {n - 1, 2, -1}
        assert list(i[:2, 0]) == [n - 1, 2]


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
    """What stays refused is refused as the reference refuses it: sq8
    storage under the host builder (f32-only), naming build='device'; and
    PQ-coded routing rows with 4-bit codes on 8-bit codebooks."""
    port = _port_index("float32", workload)
    with pytest.raises(ValueError, match="build='device'"):
        hnsw_tpu_torch.HnswIndex(8, 4, capacity=64, dtype="sq8",
                                 build="host", device="cpu")
    port.enable_packed(mode="pq", pq_m=4, train_x=workload.base)
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


# ----- mid-build resume: twins of tests/test_checkpoint_resume.py and
# tests/test_staged_build.py::test_incremental_adds_match_single_add
RESUME = dict(capacity=1024, ef_construction=40, seed=77)


def _graph_arrays(idx):
    return {k: np.asarray(v) for k, v in (
        idx.graph.numpy() if isinstance(idx, hnsw_tpu_torch.HnswIndex)
        else idx.graph._asdict()).items()}


def test_resume_matches_reference(tmp_path):
    """A mid-build save, loaded and resumed twice by the port and once by
    the reference: the resumes are deterministic and equal the reference's
    edge for edge; the level stream continues the uninterrupted build's;
    the graph is healthy and its recall within 0.03 of that build's."""
    wl = hnsw_tpu_torch.synthetic_workload(900, 16, n_queries=80, seed=44)
    full = hnsw_tpu_torch.HnswIndex(16, 8, device="cpu", **RESUME)
    full.add(wl.base)
    part = hnsw_tpu_torch.HnswIndex(16, 8, device="cpu", **RESUME)
    part.add(wl.base[:500])
    p = str(tmp_path / "ckpt.npz")
    part.save(p)
    resumed = []
    for _ in range(2):
        r = hnsw_tpu_torch.HnswIndex.load(p, device="cpu")
        assert r.ntotal == 500 and r.r_window == 16
        r.add(wl.base[500:])
        resumed.append(r)
    a, b = resumed
    ref = hnsw_tpu.HnswIndex.load(p)
    ref.add(wl.base[500:])
    assert torch.equal(a.graph.neighbors0, b.graph.neighbors0)
    for k, v in _graph_arrays(a).items():
        np.testing.assert_array_equal(v, _graph_arrays(ref)[k], err_msg=k)
    assert torch.equal(a.graph.levels[:900], full.graph.levels[:900])
    assert a.check()["errors"] == []
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    _, i_full = full.search(wl.queries, k=10, ef_search=64)
    _, i_res = a.search(wl.queries, k=10, ef_search=64)
    assert recall_at_k(i_res, gt, 10) >= recall_at_k(i_full, gt, 10) - 0.03


def test_incremental_adds_match_single_add():
    """One add() against two: the same counters and healthy graphs, both
    finding the true neighbours; the two-add graph equals the reference's
    two-add graph edge for edge."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(900, 16)).astype(np.float32)
    kw = dict(capacity=2048, ef_construction=40, seed=2)
    a = hnsw_tpu_torch.HnswIndex(16, 8, device="cpu", **kw)
    a.add(x)
    b = hnsw_tpu_torch.HnswIndex(16, 8, device="cpu", **kw)
    ref = hnsw_tpu.HnswIndex(16, 8, **kw)
    for idx in (b, ref):
        idx.add(x[:500])
        idx.add(x[500:])
    assert a.ntotal == b.ntotal == ref.ntotal == 900
    a.check(strict=True)
    b.check(strict=True)
    for k, v in _graph_arrays(b).items():
        np.testing.assert_array_equal(v, _graph_arrays(ref)[k], err_msg=k)
    q = rng.normal(size=(32, 16)).astype(np.float32)
    _, gt = exact_knn(x, q, 5, "l2")
    for idx in (a, b):
        _, i = idx.search(q, k=5, ef_search=48)
        assert recall_at_k(i, gt, 5) > 0.9


def test_resume_keeps_a_non_default_r_window(tmp_path):
    """The back-link window is saved and loaded (the reference's load
    resets it to 16): a resume from the file equals the build that never
    left memory, and differs from a resume at the default window."""
    wl = hnsw_tpu_torch.synthetic_workload(900, 16, n_queries=8, seed=44)
    part = hnsw_tpu_torch.HnswIndex(16, 8, device="cpu", **RESUME)
    part.r_window = 2
    part.add(wl.base[:500])
    p = str(tmp_path / "ckpt.npz")
    part.save(p)
    back = hnsw_tpu_torch.HnswIndex.load(p, device="cpu")
    assert back.r_window == back._builder.r_window == 2
    default = hnsw_tpu_torch.HnswIndex.load(p, device="cpu")
    default.r_window = default._builder.r_window = 16
    for idx in (part, back, default):
        idx.add(wl.base[500:])
    assert part._builder.last_backlink_dropped > 0
    for k, v in part.graph.numpy().items():
        np.testing.assert_array_equal(back.graph.numpy()[k], v, err_msg=k)
    assert not torch.equal(default.graph.neighbors0, part.graph.neighbors0)
