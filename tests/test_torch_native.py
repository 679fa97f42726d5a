"""The port's serial C++ baseline (``hnsw_tpu_torch.native.cpu_baseline``)
against the reference's: the cases of tests/test_cpu_baseline.py with the
ids of both engines equal (one source, one seed), the twin of
tests/test_parity.py (the port's device build on the CPU within 0.03
recall of the port's ``CpuHnsw``), and the build's own rules: into the
git-ignored ``_build/``, rebuilt when the source is newer, a failed
build raises."""

import os
import shutil
import subprocess
import tempfile

import numpy as np
import pytest

import hnsw_tpu_torch
from hnsw_tpu.native import cpu_baseline as ref_native
from hnsw_tpu.utils.datasets import synthetic_workload
from hnsw_tpu.utils.recall import recall_at_k
from hnsw_tpu_torch.native import cpu_baseline

from conftest import exact_knn
from torch_threads import one_torch_thread  # noqa: F401  (a fixture)


@pytest.fixture(scope="module")
def ref_library():
    """The reference's library, built here under a temporary name and
    renamed when missing or stale, so this module never loads a file that
    another test process is writing."""
    so, cpp = ref_native._SO, os.path.join(ref_native._DIR, "hnsw_cpu.cpp")
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(cpp):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=ref_native._DIR)
        os.close(fd)
        try:
            subprocess.run(["make", "-s", "-B", f"TARGET={tmp}"],
                           cwd=ref_native._DIR, check=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ref_native


def both(ref_library, dim, m, metric="l2", seed=42):
    return (cpu_baseline.CpuHnsw(dim, m, metric=metric, seed=seed),
            ref_library.CpuHnsw(dim, m, metric=metric, seed=seed))


@pytest.mark.parametrize("case", ["l2", "ip"])
def test_cpu_engine_recall_and_ids(ref_library, case):
    """test_cpu_engine_recall / test_cpu_engine_ip: the same recall bars,
    and the same ids and distances as the reference's engine."""
    if case == "l2":
        wl = synthetic_workload(3000, 24, n_queries=150, seed=6)
        eng, ref = both(ref_library, 24, 12)
        bar = 0.95
    else:
        wl = synthetic_workload(2000, 16, n_queries=100, metric="ip", seed=7)
        eng, ref = both(ref_library, 16, 12, metric="ip")
        bar = 0.93
    for e in (eng, ref):
        e.add(wl.base, ef_construction=80)
    assert eng.ntotal == ref.ntotal == len(wl.base)
    _, gt = exact_knn(wl.base, wl.queries, 10, case)
    ids, d = eng.search(wl.queries, 10, ef_search=64, return_dists=True)
    rids, rd = ref.search(wl.queries, 10, ef_search=64, return_dists=True)
    assert recall_at_k(ids, gt, 10) >= bar
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(d, rd)


def test_cpu_engine_self_and_dists(ref_library):
    wl = synthetic_workload(500, 8, n_queries=1, seed=8)
    eng, ref = both(ref_library, 8, 8)
    for e in (eng, ref):
        e.add(wl.base, ef_construction=60)
    ids, d = eng.search(wl.base[:20], 1, ef_search=32, return_dists=True)
    assert (ids[:, 0] == np.arange(20)).all()
    assert (d[:, 0] < 1e-5).all()
    assert ids.dtype == np.int64 and d.dtype == np.float32
    np.testing.assert_array_equal(ids, ref.search(wl.base[:20], 1,
                                                  ef_search=32))


@pytest.fixture(scope="module")
def frontier():
    """tests/test_parity.py's build on the port: the device build on the
    CPU and the serial engine, equal hyperparameters."""
    wl = synthetic_workload(3000, 24, n_queries=200, seed=33)
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    dev = hnsw_tpu_torch.HnswIndex(24, 8, "l2", capacity=4096,
                                   build="device", ef_construction=80,
                                   seed=1, device="cpu")
    dev.add(wl.base)
    cpu = cpu_baseline.CpuHnsw(24, 8, seed=1)
    cpu.add(wl.base, ef_construction=80)
    return dev, cpu, wl, gt


@pytest.mark.parametrize("ef", [16, 32, 64])
def test_recall_frontier_parity(frontier, ef):
    """The batched device build lands within 0.03 recall of the serial
    build at each ef."""
    dev, cpu, wl, gt = frontier
    _, i_dev = dev.search(wl.queries, k=10, ef_search=ef)
    r_dev = recall_at_k(i_dev, gt, 10)
    r_cpu = recall_at_k(cpu.search(wl.queries, 10, ef_search=ef), gt, 10)
    assert r_dev >= r_cpu - 0.03, (ef, r_dev, r_cpu)


def test_library_lives_in_the_build_dir():
    """Built into the git-ignored ``_build/``, named for the host CPU;
    nothing is written beside the source."""
    cpu_baseline.CpuHnsw(4, 4)
    pkg = os.path.dirname(hnsw_tpu_torch.__file__)
    path = cpu_baseline.library_path()
    assert path.parent == cpu_baseline.BUILD_DIR
    assert str(cpu_baseline.BUILD_DIR) == os.path.join(pkg, "_build")
    assert path.exists()
    native = os.path.join(pkg, "native")
    assert sorted(f for f in os.listdir(native) if not f.startswith("__")) \
        == ["Makefile", "cpu_baseline.py", "hnsw_cpu.cpp"]


def _private_copy(tmp_path, monkeypatch):
    """The native sources in a directory of their own, the module pointed
    at it, its loaded library forgotten."""
    src = tmp_path / "native"
    src.mkdir()
    for f in ("hnsw_cpu.cpp", "Makefile"):
        shutil.copy(os.path.join(os.path.dirname(cpu_baseline.__file__), f),
                    src / f)
    monkeypatch.setattr(cpu_baseline, "_DIR", src)
    monkeypatch.setattr(cpu_baseline, "_SRC", src / "hnsw_cpu.cpp")
    monkeypatch.setattr(cpu_baseline, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cpu_baseline, "_lib", None)
    return src


def test_rebuilds_when_the_source_is_newer(tmp_path, monkeypatch):
    """No library: built (no temporary file left); again: reused; the
    source touched later than the library: rebuilt."""
    src = _private_copy(tmp_path, monkeypatch)
    out = cpu_baseline.build_library()
    assert out.exists() and os.listdir(out.parent) == [out.name]
    first = out.stat().st_mtime_ns
    assert cpu_baseline.build_library() == out
    assert out.stat().st_mtime_ns == first
    later = out.stat().st_mtime + 10
    os.utime(src / "hnsw_cpu.cpp", (later, later))
    cpu_baseline.build_library()
    assert out.stat().st_mtime_ns != first
    assert os.listdir(out.parent) == [out.name]


def test_failed_build_raises(tmp_path, monkeypatch):
    src = _private_copy(tmp_path, monkeypatch)
    (src / "hnsw_cpu.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed"):
        cpu_baseline.CpuHnsw(4, 4)
    assert not any((tmp_path / "_build").iterdir())


def test_shape_errors():
    eng = cpu_baseline.CpuHnsw(8, 4)
    with pytest.raises(ValueError, match="8"):
        eng.add(np.zeros((3, 5), np.float32))
    eng.add(np.eye(8, dtype=np.float32))
    with pytest.raises(ValueError, match="8"):
        eng.search(np.zeros(8, np.float32), 1)
