"""Build, load and launch the package's hand-written CUDA kernels.

The sources under ``hnsw_tpu_torch/csrc/`` have a plain C interface. On
first use they are compiled by ``nvcc`` for ``sm_90a`` (Hopper), one
``nvcc`` process per source, all started together, and linked into one
shared library under ``hnsw_tpu_torch/_build/``, loaded with ``ctypes``.
The library's file name carries a hash of the sources and flags, so an edit
to any source builds a new one. Nothing here runs at import: the CPU-only
tests import every module.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``CudaKernel.launch`` raises if that is not 0 and
otherwise counts the launch. The counts show that a run went through the
kernels (``launch_counts``). A launch into a CUDA graph capture executes
nothing: between ``start_recording`` and ``stop_recording`` launches are
recorded, not counted, and ``add_recorded`` adds a graph's record on each
replay (``graphs.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# argument types of each C entry point, the trailing stream included
_SIGNATURES = {
    # table, dtype, n_rows, d, ids, q, k, qs, offset, scale, ip, out, stream
    "hnsw_vec_dist": (_P, _I, _I64, _I, _P, _I, _I, _P, _P, _P, _I, _P, _P),
    # table, dtype, n_rows, d, nbrs, cur, q, k, qs, offset, scale, ip, out,
    # stream
    "hnsw_vec_dist_cur": (_P, _I, _I64, _I, _P, _P, _I, _I, _P, _P, _P, _I,
                          _P, _P),
    # codes, n_rows, row_w, nbr_sq, k, d, bits, cur, q, t, qs, ip, out, stream
    "hnsw_packed_dist": (_P, _I64, _I64, _P, _I, _I, _I, _P, _I, _I, _P, _I,
                         _P, _P),
    # words, n_rows, row_w, k, wp, d, bits, cur, q, t, qs, out, stream
    "hnsw_words_dist": (_P, _I64, _I64, _I, _I, _I, _I, _P, _I, _I, _P, _P,
                        _P),
    # vectors, dtype, cap, d, ids, q, k, queries, ip, out, stream
    "hnsw_gather_dist": (_P, _I, _I64, _I, _P, _I, _I, _P, _I, _P, _P),
    # buf_d, buf_p, cand_i, cand_d, q, ef, k, ef_live,
    # out_d, out_p, cur, ndis, stream
    "hnsw_beam_update": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    # buf_d, buf_p, nbrs, n_rows, cand_d, q, ef, k, ef_live, limit,
    # cur, ndis, steps, stream
    "hnsw_beam_hop": (_P, _P, _P, _I64, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                      _P),
    # queries, q, d, sv, svsq, ok, s, n_seeds, ip, keys, out, stream
    "hnsw_entry_scan": (_P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P),
}

# shared memory a launch may ask for without opting in to more
SMEM_LIMIT = 48 * 1024

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhnsw_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the kernels if this exact source set has no library yet: each
    ``.cu`` to an object in its own ``nvcc`` process (all run at once),
    then one link. Writes to a temporary name and renames, so concurrent
    builders never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    nvcc = _nvcc()
    try:
        jobs, objs = [], []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            objs.append(str(work / f"{src.stem}.o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for cmd, proc in jobs:        # wait for every job before raising
            so, se = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{so}{se}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = work / out.name
        cmd = [nvcc, "-shared", "-o", str(tmp), *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.hnsw_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hnsw_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


class CudaKernel:
    """One kernel's C entry point plus its launch count (and, where the
    wrapper tags its launches, e.g. with the row dtype, the count by tag).
    A kernel with a second entry point (K3 by node, K1's hop) launches it
    with ``launch(..., symbol=)``, counted as the kernel's."""

    def __init__(self, name: str, symbol: str):
        self.name = name
        self.symbol = symbol
        self.launches = 0
        self.by_tag: dict[str, int] = {}
        KERNELS[name] = self

    def launch(self, *args, symbol: str | None = None) -> None:
        lib = library()
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, symbol or self.symbol)(*args, stream)
        if err != 0:
            msg = lib.hnsw_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name}: launch failed: CUDA error "
                               f"{err} ({msg})")
        if _recording:
            rec = _recording[-1]
            rec[(self.name, None)] = rec.get((self.name, None), 0) + 1
        else:
            self.launches += 1

    def count_tag(self, tag: str) -> None:
        """Count the launch just made under ``tag``."""
        if _recording:
            rec = _recording[-1]
            rec[(self.name, tag)] = rec.get((self.name, tag), 0) + 1
        else:
            self.by_tag[tag] = self.by_tag.get(tag, 0) + 1


KERNELS: dict[str, CudaKernel] = {}


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def tagged_launch_counts() -> dict[str, dict[str, int]]:
    """{kernel: {tag: launches}} for the kernels whose launches carry a
    tag."""
    return {name: dict(k.by_tag) for name, k in KERNELS.items() if k.by_tag}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.by_tag.clear()


# records of the graph captures in progress: {(kernel, tag or None): n}
_recording: list[dict] = []


def start_recording() -> None:
    """Launches from here to ``stop_recording`` go into a capture: record
    them instead of counting them."""
    _recording.append({})


def stop_recording() -> dict:
    return _recording.pop()


def add_recorded(rec: dict) -> None:
    """Count a captured graph's launches once (one replay)."""
    for (name, tag), n in rec.items():
        k = KERNELS[name]
        if tag is None:
            k.launches += n
        else:
            k.by_tag[tag] = k.by_tag.get(tag, 0) + n


def default_device() -> torch.device:
    """The first CUDA device, the default of every entry point that takes a
    ``device``. Never a silent fall back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU (the wrapper then runs the plain
    PyTorch version), False when all are on one CUDA device (it launches the
    kernel). Anything else raises: no other device has these kernels."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs "
                             f"{dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev.type == "cpu"


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple):
    """Raise unless ``t`` has ``dtype``, ``shape`` (None = any size on that
    axis) and a contiguous layout."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != ts for s, ts in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
