"""Two designs of K5 ``fused_gather_distances`` on f32 rows, timed in turns
on one GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 scripts/torch_k5_probe.py --other DIR

DIR is another checkout of the repository (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory); its
``hnsw_tpu_torch/csrc/hop_kernel.cu`` is built as the "other" K5. At the
hop's shape (Q = 8192, K = 64, d = 128 over 1M f32 rows, the ids that
``chip_smoke.py`` ``check_gather_dist`` draws: ~1% negative, ~1% past the
end), and at the descent's (K = 32) and the entry rescore's (K = 5), and
at d = 100, it times in turns (other, a, b, b, a, other):

  * (a) the package's K5, which runs K3's row engines (``csrc/vec_dist.cuh``;
    4-byte loads, lane j summing dims j, j + 32, ...), held bit for bit
    against K3 (``gathered_vec_dist_ids``) on the same inputs;
  * (b) ``f4_dist_kernel`` below: the same flat grid of (query, chunk of 8
    candidates) warps and every row load of a pass issued evict-first
    before the first FMA, but 16-byte loads, lane i reading float4 i of
    each 128-dim pass and summing it in the other checkout's order (its
    ``gather_dist_kernel``'s), held bit for bit against the other K5;
  * the other checkout's K5;
  * the gather ceiling of ``scripts/torch_kernel_ab.py`` (16-byte loads, no
    arithmetic), once;

each beside its bound (``chip_smoke.gather_bound``), and all against the
plain version (rtol 1e-5 + atol 1e-3). The last line names the design to
keep: (a), unless (b) is more than 5% faster at the hop's shape, d = 128.
The sources are built in ``chip_scratch/k5_probe/`` (git-ignored).
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
sys.path.insert(0, str(REPO / "scripts"))

import chip_smoke as cs  # noqa: E402
import torch_kernel_ab as ab  # noqa: E402
from hnsw_tpu_torch.ops import _cuda  # noqa: E402
from hnsw_tpu_torch.ops import dist_kernel as dk  # noqa: E402
from hnsw_tpu_torch.ops import hop_kernel as hk  # noqa: E402

WORK = REPO / "chip_scratch" / "k5_probe"

# design (b); clamp_row, reduce_scatter and the chunk constants come from
# the package's headers
PROBE_SRC = r"""
#include "vec_dist.cuh"

namespace hnsw {
namespace {

template <bool kIP>
__global__ void __launch_bounds__(kVecWarps * kWarp)
f4_dist_kernel(const float4* __restrict__ table, int64_t n_rows, int units,
               const int32_t* __restrict__ ids, int k, int chunks, int64_t n_work,
               const float4* __restrict__ qs, float* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kVecWarps + threadIdx.x / kWarp;
  if (w >= n_work) return;  // warp-uniform
  const int64_t qi = w / chunks;
  const int c0 = static_cast<int>(w % chunks) * kVecChunk;
  const int live = min(kVecChunk, k - c0);
  const int32_t id = lane < live ? __ldg(ids + qi * k + c0 + lane) : 0;
  const float4* row[kVecChunk];
#pragma unroll
  for (int u = 0; u < kVecChunk; ++u)
    row[u] = table + clamp_row(__shfl_sync(kFull, id, u), n_rows) * static_cast<int64_t>(units);
  const float4* q = qs + qi * units;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float dot[kVecChunk], sq[kVecChunk];
#pragma unroll
  for (int u = 0; u < kVecChunk; ++u) dot[u] = sq[u] = 0.f;
  for (int i0 = 0; i0 < units; i0 += kWarp) {  // 128-dim passes, warp-uniform
    const int i = i0 + lane;
    const bool in = i < units;
    float4 x[kVecChunk];
#pragma unroll
    for (int u = 0; u < kVecChunk; ++u) x[u] = in && u < live ? __ldcs(row[u] + i) : zero;
    const float4 y = in ? __ldg(q + i) : zero;
#pragma unroll
    for (int u = 0; u < kVecChunk; ++u) {
      const float4 v = x[u];
      dot[u] += v.x * y.x + v.y * y.y + v.z * y.z + v.w * y.w;
      if (!kIP) sq[u] += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
  }
  const float dsum = reduce_scatter<kVecChunk>(dot, lane, kWarp);
  const float ssum = kIP ? 0.f : reduce_scatter<kVecChunk>(sq, lane, kWarp);
  constexpr int kSpan = kWarp / kVecChunk;
  const int c = lane / kSpan;
  if (lane % kSpan == 0 && c < live) out[qi * k + c0 + c] = kIP ? -dsum : ssum - 2.f * dsum;
}

}  // namespace
}  // namespace hnsw

// f32 rows of whole float4 units (d % 4 == 0, both bases 16-byte aligned)
extern "C" int k5_f4_run(const void* table, int64_t n_rows, int d, const void* ids, int q,
                         int k, const void* qs, int ip, void* out, void* stream) {
  using namespace hnsw;
  if (d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (k + kVecChunk - 1) / kVecChunk;
  const int64_t work = static_cast<int64_t>(q) * chunks;
  const auto grid = static_cast<unsigned>((work + kVecWarps - 1) / kVecWarps);
  auto t = static_cast<const float4*>(table);
  auto i = static_cast<const int32_t*>(ids);
  auto qf = static_cast<const float4*>(qs);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (ip)
    f4_dist_kernel<true><<<grid, kVecWarps * kWarp, 0, s>>>(t, n_rows, d / 4, i, k, chunks, work,
                                                            qf, o);
  else
    f4_dist_kernel<false><<<grid, kVecWarps * kWarp, 0, s>>>(t, n_rows, d / 4, i, k, chunks, work,
                                                             qf, o);
  return static_cast<int>(cudaGetLastError());
}
"""


def build(other: Path) -> tuple[ctypes.CDLL, ctypes.CDLL]:
    """(design (b)'s library, the other checkout's K5), nvcc at once."""
    WORK.mkdir(parents=True, exist_ok=True)
    src = WORK / "k5_probe.cu"
    src.write_text(PROBE_SRC)
    jobs = {
        "b": (WORK / "libk5_f4.so",
              ["-I", str(_cuda.CSRC_DIR), str(src)]),
        "other": (WORK / "libk5_other.so",
                  [str(other / "hnsw_tpu_torch" / "csrc" / "hop_kernel.cu")]),
    }
    procs = {name: subprocess.Popen(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(out), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (out, args) in jobs.items()}
    failed = []
    for name, proc in procs.items():
        so, se = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc ({name}) failed:\n{so}{se}")
    if failed:
        raise RuntimeError("\n".join(failed))
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    f4 = ctypes.CDLL(str(jobs["b"][0]))
    f4.k5_f4_run.argtypes = [P, I64, I, P, I, I, P, I, P, P]
    f4.k5_f4_run.restype = ctypes.c_int
    oth = ctypes.CDLL(str(jobs["other"][0]))
    oth.hnsw_gather_dist.argtypes = list(_cuda._SIGNATURES["hnsw_gather_dist"])
    oth.hnsw_gather_dist.restype = ctypes.c_int
    return f4, oth


def probe_shape(tag, f4, oth, ceil_lib, table, ids, qs) -> dict:
    """Times of (a), (b) and the other K5 at one shape (L2), in turns."""
    q, k = ids.shape
    n, d = table.shape

    def design_a():
        return hk.fused_gather_distances(table, ids, qs, "l2")

    def design_b():
        out = torch.empty((q, k), device=table.device)
        ab.call(f4, "k5_f4_run", table.data_ptr(), n, d, ids.data_ptr(), q,
                k, qs.data_ptr(), 0, out.data_ptr())
        return out

    def other():
        out = torch.empty((q, k), device=table.device)
        ab.call(oth, "hnsw_gather_dist", table.data_ptr(), 0, n, d,
                ids.data_ptr(), q, k, qs.data_ptr(), 0, out.data_ptr())
        return out

    plain = hk.fused_gather_distances_plain(table, ids, qs, "l2")
    for name, fn in (("(a)", design_a), ("(b)", design_b),
                     ("other", other)):
        cs.compare(f"{tag} {name} vs plain", fn(), plain, rtol=1e-5,
                   atol=1e-3)
    a_k3 = torch.equal(design_a(), dk.gathered_vec_dist_ids(
        table, ids, qs, metric="l2"))
    b_other = torch.equal(design_b(), other())
    b = cs.gather_bound(ids.clamp(0, n - 1), d, ip=False)
    ceiling = ab.ceiling_ms(ceil_lib, table, ids)
    cases = (("other", other), ("(a)", design_a), ("(b)", design_b))
    times = {}
    for name, fn in cases + cases[::-1]:
        times.setdefault(name, []).append(cs.time_ms(fn))
    ms = {name: sum(ts) / len(ts) for name, ts in times.items()}
    cs.log(f"{tag}: bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
           f"({b['bytes'] / 1e6:.1f} MB), gather ceiling {ceiling:.4f} ms; "
           f"(a) equals K3 bit for bit: {a_k3}; (b) equals the other K5 bit "
           f"for bit: {b_other}")
    for name, ts in times.items():
        cs.log(f"  {tag} {name}: {ms[name]:.4f} ms "
               f"({', '.join(f'{t:.4f}' for t in ts)}), share of bound "
               f"{b['bound_ms'] / ms[name]:.3f}")
    if not (a_k3 and b_other):
        raise SystemExit(f"torch_k5_probe: {tag}: a design differs from "
                         f"the kernel it must equal bit for bit")
    return ms


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="another checkout of the repository")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k5_probe: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(f"card: {card}")
    torch.set_float32_matmul_precision("highest")
    t0 = time.time()
    _cuda.library()
    f4, oth = build(args.other.resolve())
    ceil_lib = ab.build_ceiling(WORK)
    cs.log(f"built in {time.time() - t0:.1f} s")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n = cs.NORTH_STAR_N
    hop = None
    for d in (128, 100):
        table = torch.randn((n, d), generator=gen, device=dev)
        for tag, k in (("hop", cs.HOP_K), ("descent", 32), ("entry", 5)):
            ids = cs.gather_ids(cs.N_QUERIES, k, n, gen, dev)
            qs = torch.randn((cs.N_QUERIES, d), generator=gen, device=dev)
            ms = probe_shape(f"f32 d={d} {tag} Q={cs.N_QUERIES} K={k}", f4,
                             oth, ceil_lib, table, ids, qs)
            if d == 128 and tag == "hop":
                hop = ms
        del table
    gain = 1.0 - hop["(b)"] / hop["(a)"]
    keep = "(b)" if gain > 0.05 else "(a)"
    cs.log(f"hop, d=128: (b) is {gain:+.1%} faster than (a); keep {keep}")


if __name__ == "__main__":
    main()
