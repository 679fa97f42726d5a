"""Hold this checkout's K3 ``gathered_vec_dist``, K2 ``packed_row_dist`` and
K5 ``fused_gather_distances`` CUDA kernels (``hnsw_tpu_torch``) against
another checkout's, on one GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 scripts/torch_kernel_ab.py --other DIR

DIR is another checkout of the repository, for example the parent commit
unpacked with ``git archive`` into a git-ignored directory. Its
``hnsw_tpu_torch/csrc/dist_kernel.cu`` and ``hop_kernel.cu`` are compiled
by nvcc (the package's flags) into a library under DIR and loaded beside
this checkout's. For each case both kernels get the same inputs on the
card, at the shapes the main path gives them (K3: the serving hop and
rerank, and the build's level-0 hop, upper-level beam, descent and entry,
on f32 rows and on the storage codecs' rows: uint8 + dequant (sq8) at d =
96 and bf16 at d = 128, and both at d = 100; K5: the hop under
``HNSW_TPU_PALLAS_HOP=1`` (K = 64), the greedy descent (K = 32) and the
entry rescore (K = 5), f32 and bf16 rows, d = 128 and 100, with
``chip_smoke.gather_ids``' ids; K2: the packed hop at 8 and 4 bits, IP,
two expansions, Q = 8191, and rows of other widths). Their outputs must be
equal bit for bit (``torch.equal``), except K3 on bf16 rows, which sums in
another order than the first port's, and K5, whose first port summed in
another order than K3's row engines: those are held within rtol 1e-5 +
atol 1e-3, and each K5 case must equal this checkout's K3 on the same
inputs bit for bit; every case is also compared with the plain PyTorch
version (chip_smoke.py's tolerances). Each case is then timed in turns,
other / this / this / other, with ``chip_smoke.time_ms``, and printed
beside its bound. Each K3 and K5 case is also timed against a gather
ceiling: a kernel (compiled from the source below) that reads the same
rows by the same ids with 16-byte loads (4- or 1-byte loads where rows
are not whole 16-byte units) and does no arithmetic, the least time this
card takes to fetch them. Exits non-zero if any output differs.
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
from hnsw_tpu_torch.ops import hop_kernel as hk  # noqa: E402


# K3's reads without its sums: warp w reads the rows of query w / chunks,
# candidates (w % chunks) * 8 ... + 7 (rows of row_bytes bytes), one W-byte
# load a lane and pass (W = 16 where rows are whole 16-byte units, else 4,
# else 1), and stores nothing unless a row holds a NaN (so the loads stay).
CEILING_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// a load's bits as a finite, non-negative float (so a row's sum is never
// NaN, which the compiler cannot know)
template <typename V> __device__ __forceinline__ float fold(V v);
template <> __device__ __forceinline__ float fold(uint4 v) {
  return __uint_as_float((v.x ^ v.y ^ v.z ^ v.w) & 0x3fffffffu);
}
template <> __device__ __forceinline__ float fold(uint32_t v) {
  return __uint_as_float(v & 0x3fffffffu);
}
template <> __device__ __forceinline__ float fold(uint8_t v) {
  return __uint_as_float(v);
}
template <typename V>
__global__ void __launch_bounds__(128)
gather_ceiling(const char* __restrict__ table, int64_t n_rows,
               int64_t row_bytes, const int32_t* __restrict__ ids, int k,
               int chunks, int64_t n_work, float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * 4 + threadIdx.x / 32;
  if (w >= n_work) return;
  const int64_t qi = w / chunks;
  const int c0 = static_cast<int>(w % chunks) * 8;
  const int live = min(8, k - c0);
  const int32_t id = lane < live ? __ldg(ids + qi * k + c0 + lane) : 0;
  const int64_t n = row_bytes / static_cast<int64_t>(sizeof(V));
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    int64_t r = __shfl_sync(0xffffffffu, id, u);
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    const V* row = reinterpret_cast<const V*>(table + r * row_bytes);
    float s = 0.f;
    for (int64_t j = lane; u < live && j < n; j += 32) s += fold(__ldg(row + j));
    if (s != s) out[qi * k + c0 + u] = s;
  }
}
// width: bytes a lane loads (16, 4 or 1), or 0 for the widest the rows take
extern "C" int gather_ceiling_run(const void* table, int64_t n_rows,
                                  int64_t row_bytes, const void* ids, int q,
                                  int k, int width, void* out, void* stream) {
  const int chunks = (k + 7) / 8;
  const int64_t work = static_cast<int64_t>(q) * chunks;
  const unsigned grid = static_cast<unsigned>((work + 3) / 4);
  const auto t = static_cast<const char*>(table);
  const auto i = static_cast<const int32_t*>(ids);
  const auto o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(t) | row_bytes;
  if (width == 0) width = align % 16 == 0 ? 16 : (align % 4 == 0 ? 4 : 1);
  if (align % width != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (width == 16)
    gather_ceiling<uint4><<<grid, 128, 0, st>>>(t, n_rows, row_bytes, i, k, chunks, work, o);
  else if (width == 4)
    gather_ceiling<uint32_t><<<grid, 128, 0, st>>>(t, n_rows, row_bytes, i, k, chunks, work, o);
  else
    gather_ceiling<uint8_t><<<grid, 128, 0, st>>>(t, n_rows, row_bytes, i, k, chunks, work, o);
  return static_cast<int>(cudaGetLastError());
}
"""


def build_ceiling(work: Path) -> ctypes.CDLL:
    work.mkdir(parents=True, exist_ok=True)
    src = work / "gather_ceiling.cu"
    src.write_text(CEILING_SRC)
    out = work / "libgather_ceiling.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o",
                    str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gather_ceiling_run.argtypes = [P, I64, I64, P, I, I, I, P, P]
    lib.gather_ceiling_run.restype = ctypes.c_int
    return lib


def ceiling_ms(ceil_lib, table: torch.Tensor, ids: torch.Tensor,
               width: int = 0) -> float:
    """The gather ceiling's time over ``table``'s rows (any dtype) by
    ``ids``, ``width`` bytes a load (0: the widest the rows take)."""
    q, k = ids.shape
    sink = torch.empty((q, k), device=table.device)
    row_bytes = table.shape[1] * table.element_size()
    return cs.time_ms(lambda: call(
        ceil_lib, "gather_ceiling_run", table.data_ptr(), table.shape[0],
        row_bytes, ids.data_ptr(), q, k, width, sink.data_ptr()))


def build_other(other: Path) -> ctypes.CDLL:
    csrc = other / "hnsw_tpu_torch" / "csrc"
    out = other / "_ab_build" / "libother_dist.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(out),
           str(csrc / "dist_kernel.cu"), str(csrc / "hop_kernel.cu")]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(str(out))
    for name in ("hnsw_vec_dist", "hnsw_packed_dist", "hnsw_gather_dist"):
        fn = getattr(lib, name)
        fn.argtypes = list(_cuda._SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib


def call(lib, name: str, *args) -> None:
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")


def vec_case(lib, ceil_lib, tag, table, ids, qs, metric, dequant=None):
    """K3: this kernel vs the other, bit for bit; vs plain; timed, and the
    gather ceiling timed on the same rows (f32, bf16 or uint8; ``dequant``:
    uint8 rows' (offset, scale))."""
    q, k = ids.shape
    n, d = table.shape
    ip = int(metric == "ip")
    cs.log(f"{tag}: gather ceiling {ceiling_ms(ceil_lib, table, ids):.4f} "
           f"ms")
    off, sc = (None, None) if dequant is None else \
        (dequant[0].data_ptr(), dequant[1].data_ptr())

    def other():
        out = torch.empty((q, k), device=table.device)
        call(lib, "hnsw_vec_dist", table.data_ptr(),
             dk._ROW_DTYPES[table.dtype], n, d, ids.data_ptr(), q, k,
             qs.data_ptr(), off, sc, ip, out.data_ptr())
        return out

    def this():
        return dk.gathered_vec_dist_ids(table, ids, qs, dequant,
                                        metric=metric)

    b = cs.gather_bound(ids, d, ip=bool(ip), row_elem=table.element_size(),
                        dequant=dequant is not None)
    zero = float((ids == 0).float().mean())
    return report(tag, this, other,
                  lambda: dk.gathered_vec_dist_plain(table, ids, qs, dequant,
                                                     metric=metric),
                  1e-3, b, f"row-0 share {zero:.3f}",
                  exact=table.dtype != torch.bfloat16)


def gather_case(lib, ceil_lib, tag, table, ids, qs, metric):
    """K5: this kernel vs the other, within the tolerance (the first port's
    K5 summed in another order); vs this checkout's K3 on the same inputs,
    bit for bit; vs plain; timed, beside the gather ceiling. Returns both
    verdicts."""
    q, k = ids.shape
    n, d = table.shape
    ip = int(metric == "ip")
    cs.log(f"{tag}: gather ceiling {ceiling_ms(ceil_lib, table, ids):.4f} "
           f"ms")

    def other():
        out = torch.empty((q, k), device=table.device)
        call(lib, "hnsw_gather_dist", table.data_ptr(),
             hk._ROW_DTYPES[table.dtype], n, d, ids.data_ptr(), q, k,
             qs.data_ptr(), ip, out.data_ptr())
        return out

    def this():
        return hk.fused_gather_distances(table, ids, qs, metric)

    as_k3 = torch.equal(this(), dk.gathered_vec_dist_ids(table, ids, qs,
                                                          metric=metric))
    cs.log(f"{tag}: equal to K3 bit for bit: {as_k3}")
    b = cs.gather_bound(ids.clamp(0, n - 1), d, ip=bool(ip),
                        row_elem=table.element_size())
    same = report(tag, this, other,
                  lambda: hk.fused_gather_distances_plain(table, ids, qs,
                                                          metric),
                  1e-3, b, f"{torch.unique(ids.clamp(0, n - 1)).numel()} "
                  f"distinct rows", exact=False)
    return [same, as_k3]


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


def report(tag, this, other, plain, atol, b, note, exact=True):
    """Both kernels against plain, then timed in turns. ``exact``: this
    kernel must equal the other bit for bit; else (a kernel that sums in
    another order) within rtol 1e-5 + ``atol``."""
    got, ref = this(), other()
    torch.cuda.synchronize()
    same = torch.equal(got, ref) if exact else \
        torch.allclose(got, ref, rtol=1e-5, atol=atol)
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
           f"{b['bound_ms'] / new:.3f}; equal "
           f"{'bit for bit' if exact else f'within rtol 1e-5 + atol {atol}'}"
           f": {same}")
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

    # the codec rows: uint8 + dequant (sq8; 0.45 of the build's level-0 ids
    # masked to row 0) and bf16 (0.49), at the serving hop and the build's
    # four shapes, and at d = 100 (rows of whole 4-byte words, not 16-byte
    # units) and 960 at the serving hop
    for dtype, d, hop_zero in ((torch.uint8, 96, 0.45),
                               (torch.bfloat16, 128, 0.49),
                               (torch.uint8, 100, None),
                               (torch.bfloat16, 100, None),
                               (torch.uint8, 960, None)):
        rows = n if d < 960 else 100_000
        if dtype == torch.uint8:
            table = torch.randint(0, 256, (rows, d), generator=gen,
                                  device=dev, dtype=torch.uint8)
            deq = (torch.randn(d, generator=gen, device=dev),
                   0.01 + 0.02 * torch.rand(d, generator=gen, device=dev))
        else:
            table = torch.randn((rows, d), generator=gen,
                                device=dev).to(dtype)
            deq = None
        name = str(dtype).removeprefix("torch.") + \
            (" + dequant" if deq is not None else "")
        shapes = [("serving hop", 8192 if d < 960 else 512, 64, 0.0)]
        if hop_zero is not None:
            shapes += [("build level-0 hop", 2048, 256, hop_zero),
                       ("build upper beam", 86, 128, 0.84),
                       ("build descent", 2048, 32, 1.0),
                       ("build entry", 2048, 1, 0.0)]
        for tag, q, k, zero in shapes:
            ids = masked_ids(q, k, rows, zero, gen, dev)
            qs = torch.randn((q, d), generator=gen, device=dev)
            metrics = ("l2", "ip") if k == 64 and d < 960 else ("l2",)
            for metric in metrics:
                same.append(vec_case(lib, ceil_lib, f"K3 {name} {tag} Q={q} "
                                          f"K={k} d={d} {metric}", table,
                                     ids, qs, metric, deq))
        del table

    # K5 at the flagged search's shapes: the hop, the greedy descent and
    # the entry rescore (4 seeds + the entry point at 1M)
    for d in (128, 100):
        table = torch.randn((n, d), generator=gen, device=dev)
        for rows in (table, table.to(torch.bfloat16)):
            name = str(rows.dtype).removeprefix("torch.")
            for tag, k in (("hop", cs.HOP_K), ("descent", 32),
                           ("entry", 5)):
                ids = cs.gather_ids(cs.N_QUERIES, k, n, gen, dev)
                qs = torch.randn((cs.N_QUERIES, d), generator=gen,
                                 device=dev)
                metrics = ("l2", "ip") if tag == "hop" and d == 128 \
                    else ("l2",)
                for metric in metrics:
                    same += gather_case(lib, ceil_lib, f"K5 {name} {tag} "
                                        f"Q={cs.N_QUERIES} K={k} d={d} "
                                        f"{metric}", rows, ids, qs, metric)
        del table, rows

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
                         f"{len(same)} checks differ")
    cs.log(f"all {len(same)} checks equal (bit for bit but K3 on bf16 rows "
           f"and K5 against the other checkout's kernels: within the "
           f"tolerance; K5 against this checkout's K3: bit for bit)")


if __name__ == "__main__":
    main()
