"""ctypes wrapper over the bundled serial C++ HNSW (``hnsw_cpu.cpp``).

``CpuHnsw`` is the host baseline by design: one core, faiss's insertion
and search semantics, the measured single-core denominator of a benchmark
and a recall oracle in the tests. It is the one entry point of the package
that runs on the CPU without being asked, and no device path calls it.

The library is built on the first ``CpuHnsw()``, never at import, by the
Makefile beside the source (g++, ``-march=native``), into the git-ignored
``hnsw_tpu_torch/_build/``. Its name carries the host CPU's model and
flags, so a tree copied to another machine never loads a library built
for another instruction set; it is rebuilt when ``hnsw_cpu.cpp`` is
newer. The build writes a temporary name and renames it, so processes
building at once (test workers) never load a half-written file. A failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "hnsw_cpu.cpp"
BUILD_DIR = _DIR.parent / "_build"
_lib = None


def _cpuinfo() -> dict:
    """The first value of each key of ``/proc/cpuinfo`` ({} without it)."""
    info: dict = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                info.setdefault(key.strip(), val.strip())
    except OSError:
        pass
    return info


def cpu_model() -> str:
    """The host CPU as ``/proc/cpuinfo`` names it: its model name, with the
    vendor, family and model numbers beside it (a virtual machine may
    report the name "unknown")."""
    info = _cpuinfo()
    name = info.get("model name") or platform.processor() or \
        platform.machine()
    ids = ", ".join(f"{k} {info[k]}" for k in ("vendor_id", "cpu family",
                                              "model") if k in info)
    return f"{name} ({ids})" if ids else name


def library_path() -> Path:
    """Named for the host CPU's model and instruction set flags (the
    library is built with ``-march=native``)."""
    key = cpu_model() + _cpuinfo().get("flags", "")
    return BUILD_DIR / \
        f"libhnsw_cpu_{hashlib.sha256(key.encode()).hexdigest()[:12]}.so"


def build_library() -> Path:
    """``make`` the library unless it exists and is newer than the
    source."""
    out = library_path()
    if out.exists() and out.stat().st_mtime >= _SRC.stat().st_mtime:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(["make", "-s", "-B", f"TARGET={tmp}"], cwd=_DIR,
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {out.name} failed "
                               f"({res.returncode}):\n{res.stdout}"
                               f"{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    lib.hnsw_cpu_create.restype = ctypes.c_void_p
    lib.hnsw_cpu_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_uint64]
    lib.hnsw_cpu_free.argtypes = [ctypes.c_void_p]
    lib.hnsw_cpu_add.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_int]
    lib.hnsw_cpu_search.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p]
    lib.hnsw_cpu_ntotal.argtypes = [ctypes.c_void_p]
    lib.hnsw_cpu_ntotal.restype = ctypes.c_int
    _lib = lib
    return lib


class CpuHnsw:
    """Serial HNSW on one host core (faiss ``IndexHNSWFlat`` semantics):
    ``add`` inserts one point at a time, ``search`` answers one query at a
    time. Ids are insertion order. The host baseline: it never touches a
    device."""

    def __init__(self, dim: int, m: int = 16, metric: str = "l2",
                 seed: int = 42):
        self._lib = _load()
        self.dim = dim
        self._h = self._lib.hnsw_cpu_create(dim, m, 1 if metric == "ip" else 0,
                                            seed)

    def __del__(self):
        if getattr(self, "_h", None) and self._lib:
            self._lib.hnsw_cpu_free(self._h)
            self._h = None

    @property
    def ntotal(self) -> int:
        return self._lib.hnsw_cpu_ntotal(self._h)

    def add(self, x: np.ndarray, ef_construction: int = 200) -> None:
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}], got {x.shape}")
        self._lib.hnsw_cpu_add(self._h, x.ctypes.data, len(x),
                               ef_construction)

    def search(self, q: np.ndarray, k: int, ef_search: int = 64,
               return_dists: bool = False):
        """ids [n, k] int64 (and distances [n, k] float32 with
        ``return_dists``: squared L2, or -inner product for "ip")."""
        q = np.ascontiguousarray(q, np.float32)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}], got {q.shape}")
        ids = np.empty((len(q), k), np.int32)
        d = np.empty((len(q), k), np.float32)
        self._lib.hnsw_cpu_search(self._h, q.ctypes.data, len(q), k,
                                  ef_search, ids.ctypes.data, d.ctypes.data)
        return (ids.astype(np.int64), d) if return_dists else \
            ids.astype(np.int64)
