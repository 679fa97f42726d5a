"""Hold this checkout's K3 ``gathered_vec_dist`` and K2 ``packed_row_dist``
CUDA kernels (``hnsw_tpu_torch``) against another checkout's, on one GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 scripts/torch_kernel_ab.py --other DIR

DIR is another checkout of the repository, for example the parent commit
unpacked with ``git archive`` into a git-ignored directory. Its
``hnsw_tpu_torch/csrc/dist_kernel.cu`` is compiled by nvcc (the package's
flags) into a library under DIR and loaded beside this checkout's. For each
case both kernels get the same inputs on the card, at the shapes the main
path gives them (K3: the serving hop and rerank, and the build's level-0
hop, upper-level beam, descent and entry; K2: the packed hop at 8 and 4
bits, IP, two expansions, Q = 8191, and rows of other widths). Their
outputs must be equal bit for bit (``torch.equal``); every case is also
compared with the plain PyTorch version (chip_smoke.py's tolerances). Each
case is then timed in turns, other / this / this / other, with
``chip_smoke.time_ms``, and printed beside its bound. Each K3 case is also
timed against a gather ceiling: a kernel (compiled from the source below)
that reads the same rows by the same ids with 16-byte loads and does no
arithmetic, the least time this card takes to fetch them. Exits non-zero
if any output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from hnsw_tpu_torch.ops import _cuda  # noqa: E402
from hnsw_tpu_torch.ops import dist_kernel as dk  # noqa: E402


# K3's reads without its sums: warp w reads the rows of query w / chunks,
# candidates (w % chunks) * 8 ... + 7, one 16-byte load a lane and pass, and
# stores nothing unless a row holds a NaN (so the loads stay).
CEILING_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(128)
gather_ceiling(const float* __restrict__ table, int64_t n_rows, int d,
               const int32_t* __restrict__ ids, int k, int chunks,
               int64_t n_work, float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * 4 + threadIdx.x / 32;
  if (w >= n_work) return;
  const int64_t qi = w / chunks;
  const int c0 = static_cast<int>(w % chunks) * 8;
  const int live = min(8, k - c0);
  const int32_t id = lane < live ? __ldg(ids + qi * k + c0 + lane) : 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    int64_t r = __shfl_sync(0xffffffffu, id, u);
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    const float4* row = reinterpret_cast<const float4*>(table + r * d);
    float s = 0.f;
    for (int j = lane; u < live && 4 * j < d; j += 32) {
      const float4 v = __ldg(row + j);
      s += v.x + v.y + v.z + v.w;
    }
    if (s != s) out[qi * k + c0 + u] = s;
  }
}
extern "C" int gather_ceiling_run(const void* table, int64_t n_rows, int d,
                                  const void* ids, int q, int k, void* out,
                                  void* stream) {
  const int chunks = (k + 7) / 8;
  const int64_t work = static_cast<int64_t>(q) * chunks;
  gather_ceiling<<<static_cast<unsigned>((work + 3) / 4), 128, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), n_rows, d,
      static_cast<const int32_t*>(ids), k, chunks, work,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


def build_ceiling(work: Path) -> ctypes.CDLL:
    src = work / "gather_ceiling.cu"
    src.write_text(CEILING_SRC)
    out = work / "libgather_ceiling.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o",
                    str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gather_ceiling_run.argtypes = [P, I64, I, P, I, I, P, P]
    lib.gather_ceiling_run.restype = ctypes.c_int
    return lib


def build_other(other: Path) -> ctypes.CDLL:
    src = other / "hnsw_tpu_torch" / "csrc" / "dist_kernel.cu"
    out = other / "_ab_build" / "libother_dist.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(out),
           str(src)]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(str(out))
    for name in ("hnsw_vec_dist", "hnsw_packed_dist"):
        fn = getattr(lib, name)
        fn.argtypes = list(_cuda._SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib


def call(lib, name: str, *args) -> None:
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")


def vec_case(lib, ceil_lib, tag, table, ids, qs, metric):
    """K3: this kernel vs the other, bit for bit; vs plain; timed, and the
    gather ceiling timed on the same rows."""
    q, k = ids.shape
    n, d = table.shape
    ip = int(metric == "ip")
    sink = torch.empty((q, k), device=table.device)

    def ceiling():
        call(ceil_lib, "gather_ceiling_run", table.data_ptr(), n, d,
             ids.data_ptr(), q, k, sink.data_ptr())

    cs.log(f"{tag}: gather ceiling {cs.time_ms(ceiling):.4f} ms")

    def other():
        out = torch.empty((q, k), device=table.device)
        call(lib, "hnsw_vec_dist", table.data_ptr(), 0, n, d, ids.data_ptr(),
             q, k, qs.data_ptr(), None, None, ip, out.data_ptr())
        return out

    def this():
        return dk.gathered_vec_dist_ids(table, ids, qs, metric=metric)

    b = cs.gather_bound(ids, d, ip=bool(ip))
    zero = float((ids == 0).float().mean())
    return report(tag, this, other,
                  lambda: dk.gathered_vec_dist_plain(table, ids, qs,
                                                     metric=metric),
                  1e-3, b, f"row-0 share {zero:.3f}")


def packed_case(lib, tag, codes, nbr_sq, cur, qs, bits, metric):
    """K2: this kernel vs the other, bit for bit; vs plain; timed."""
    (n, row_w), k, (q, d) = codes.shape, nbr_sq.shape[1], qs.shape
    t = 1 if cur.dim() == 1 else cur.shape[1]
    ip = int(metric == "ip")

    def other():
        out = torch.empty((q, t * k), device=codes.device)
        call(lib, "hnsw_packed_dist", codes.data_ptr(), n, row_w,
             nbr_sq.data_ptr(), k, d, bits, cur.data_ptr(), q, t,
             qs.data_ptr(), ip, out.data_ptr())
        return out

    def this():
        return dk.packed_row_dist_ids(codes, nbr_sq, cur, qs, bits=bits,
                                      metric=metric)

    rows = torch.unique(cur).numel()
    b = cs.bound(rows * (row_w + (0 if ip else k * 4)) + cur.numel() * 4
                 + q * d * 4 + q * t * k * 4, q * t * k * d * 2)
    return report(tag, this, other,
                  lambda: dk.packed_row_dist_plain(codes, nbr_sq, cur, qs,
                                                   bits=bits, metric=metric),
                  1e-2, b, f"{rows} distinct rows")


def report(tag, this, other, plain, atol, b, note):
    got, ref = this(), other()
    torch.cuda.synchronize()
    same = torch.equal(got, ref)
    cs.compare(f"{tag} vs plain", got, plain(), rtol=1e-5, atol=atol)
    o1 = cs.time_ms(other)
    n1 = cs.time_ms(this)
    n2 = cs.time_ms(this)
    o2 = cs.time_ms(other)
    old, new = (o1 + o2) / 2, (n1 + n2) / 2
    cs.log(f"{tag}: other {old:.4f} ms ({o1:.4f}, {o2:.4f}), this "
           f"{new:.4f} ms ({n1:.4f}, {n2:.4f}), bound {b['bound_ms']:.4f} "
           f"ms by {b['bound_by']} ({b['bytes'] / 1e6:.1f} MB, {note}); "
           f"share of bound {b['bound_ms'] / old:.3f} -> "
           f"{b['bound_ms'] / new:.3f}; equal bit for bit: {same}")
    return same


def masked_ids(q, k, n, zero_share, gen, dev):
    ids = torch.randint(0, n, (q, k), generator=gen, device=dev,
                        dtype=torch.int32)
    mask = torch.rand((q, k), generator=gen, device=dev) < zero_share
    return torch.where(mask, 0, ids)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="another checkout of the repository")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(f"card: {card}")
    torch.set_float32_matmul_precision("highest")
    t0 = time.time()
    _cuda.library()
    lib = build_other(args.other.resolve())
    ceil_lib = build_ceiling(args.other.resolve() / "_ab_build")
    cs.log(f"built both libraries in {time.time() - t0:.1f} s")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    same = []

    n = cs.NORTH_STAR_N
    for d in (128, 100):
        table = torch.randn((n, d), generator=gen, device=dev)
        # (tag, Q, K, share of ids masked to row 0): the serving hop, and
        # the build's calls at the shapes and row-0 shares that
        # chip_smoke.py's measure_build_k3 reports for the 1M build
        for tag, q, k, zero in (("serving hop", 8192, 64, 0.0),
                                ("build level-0 hop", 2048, 256, 0.41),
                                ("build upper beam", 86, 128, 0.84),
                                ("build descent", 2048, 32, 1.0),
                                ("build entry", 2048, 1, 0.0)):
            if d != 128 and tag != "serving hop":
                continue
            ids = masked_ids(q, k, n, zero, gen, dev)
            qs = torch.randn((q, d), generator=gen, device=dev)
            for metric in ("l2", "ip") if k == 64 else ("l2",):
                same.append(vec_case(lib, ceil_lib, f"K3 {tag} Q={q} K={k} "
                                          f"d={d} {metric}", table, ids, qs,
                                     metric))
        del table
    table = torch.randn((100_000, 960), generator=gen, device=dev)
    ids = torch.randint(0, 100_000, (512, 64), generator=gen, device=dev,
                        dtype=torch.int32)
    qs = torch.randn((512, 960), generator=gen, device=dev)
    same.append(vec_case(lib, ceil_lib, "K3 Q=512 K=64 d=960 l2", table, ids,
                         qs, "l2"))
    del table

    q, k, big = cs.N_QUERIES, cs.HOP_K, cs.PACKED_ROWS
    for d, bits, rows in ((128, 8, big), (128, 4, big), (100, 8, 20_000),
                          (127, 4, 20_000), (101, 8, 20_000)):
        db = d if bits == 8 else (d + 1) // 2
        codes = torch.randint(0, 256, (rows, k * db), generator=gen,
                              device=dev, dtype=torch.uint8)
        nbr_sq = 100 * torch.rand((rows, k), generator=gen, device=dev)
        cur = torch.randint(0, rows, (q,), generator=gen, device=dev,
                            dtype=torch.int32)
        cur[:64] = torch.arange(rows - 64, rows, device=dev,
                                dtype=torch.int32)
        qs = torch.randn((q, d), generator=gen, device=dev)
        tag = f"K2 {bits}-bit d={d} rows={rows}"
        same.append(packed_case(lib, f"{tag} l2", codes, nbr_sq, cur, qs,
                                bits, "l2"))
        if (d, bits) == (128, 8):
            same.append(packed_case(lib, f"{tag} ip", codes, nbr_sq, cur, qs,
                                    bits, "ip"))
            same.append(packed_case(lib, f"{tag} two expansions", codes,
                                    nbr_sq, cur.view(q // 2, 2), qs[:q // 2],
                                    bits, "l2"))
            same.append(packed_case(lib, f"{tag} Q={q - 1}", codes, nbr_sq,
                                    cur[:q - 1], qs[:q - 1], bits, "l2"))
        del codes, nbr_sq
    if not all(same):
        raise SystemExit(f"torch_kernel_ab: {same.count(False)} of "
                         f"{len(same)} cases differ from the other kernel")
    cs.log(f"all {len(same)} cases equal the other checkout's kernels bit "
           f"for bit")


if __name__ == "__main__":
    main()
