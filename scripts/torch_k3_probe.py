"""Where K3 ``gathered_vec_dist`` loses its time on sub-word rows (uint8 +
dequant, bf16), on one GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 scripts/torch_k3_probe.py

It prints, for the package's ``csrc/dist_kernel.cu``:

  1. ``-Xptxas -v`` for each K3 kernel (registers, spills);
  2. from ``cuobjdump -sass`` of the package's library, for each K3 kernel:
     its global loads, int-to-float conversions (I2F), FMAs, shuffles, byte
     permutes and local-memory accesses, and the global loads issued before
     the first FMA (the K3 kernels' SASS goes to
     ``chip_scratch/k3_probe/k3_sass.txt``);

and then times, at the serving hop (Q = 8192, K = 64 over 1M rows), the
build's level-0 hop (Q = 2048, K = 256, 45% of ids masked to row 0; 49%
for bf16), its descent (K = 32, all ids masked) and entry (K = 1):

  * the first port's K3 on uint8 + dequant rows (one 1-byte load a lane and
    dim; a copy below), and the same kernel compiled with switches that
    each remove one candidate cause: the dequant (``-DPROBE_NO_DEQUANT``:
    no affine loads and no FMA), the conversion (``-DPROBE_PERM``: a byte
    permute and a subtract instead of I2F), the sums (``-DPROBE_NO_SUMS``:
    one add a value instead of three FMAs), and all three;
  * the package's kernel (``gathered_vec_dist_ids``): on uint8 rows in the
    first port's order (4-byte loads, shuffles), also with 8 candidates a
    warp at every K; on bf16 rows in another order (16-byte loads);
  * on bf16 rows, the first port's order with 4-byte loads and shuffles
    (``keep_order_bf16_kernel`` below);
  * on uint8 rows, a kernel that sums in another order (``free_kernel``
    below: 16-byte loads, a row over 8 lanes, 4 rows a lane, as the
    package's kernel reads bf16 rows);
  * the gather ceiling of ``scripts/torch_kernel_ab.py`` (the same rows by
    the same ids, no arithmetic) with 1-, 4- and 16-byte loads;

and the same for bf16 rows at d = 128 (the first port's kernel, the
package's, the first port's order with 4-byte loads and shuffles, and the
ceilings). Every kernel that computes the
distances is held against the plain version (rtol 1e-5, atol 1e-3). The
sources are written to and built in ``chip_scratch/k3_probe/`` (git-
ignored), one nvcc process each, all at once.
"""

from __future__ import annotations

import ctypes
import re
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

WORK = REPO / "chip_scratch" / "k3_probe"

# The package's helpers (reduce_scatter, code_value, clamp_row) come from
# including its source; the probe's kernels and launcher follow.
PROBE_SRC = r"""
#include "dist_kernel.cu"

namespace hnsw {
namespace {

// value t (< 4 / sizeof(T)) of a 4-byte word of T values, exactly
template <typename T>
__device__ __forceinline__ float word_value(uint32_t w, int t) {
  if constexpr (sizeof(T) == 1) return code_value<8>(w, t);
  return __uint_as_float(t ? w & 0xffff0000u : w << 16);
}

// The first port's K3 (vec_dist_kernel as it was) on uint8 rows, with the
// probe's switches.
template <bool kDequant>
__global__ void __launch_bounds__(kVecWarps * kWarp)
first_u8_kernel(const uint8_t* __restrict__ table, int64_t n_rows, int d,
                const int32_t* __restrict__ ids, int k, int chunks, int64_t n_work,
                const float* __restrict__ qs, const float* __restrict__ offset,
                const float* __restrict__ scale, float* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kVecWarps + threadIdx.x / kWarp;
  if (w >= n_work) return;
  const int64_t qi = w / chunks;
  const int c0 = static_cast<int>(w % chunks) * kVecChunk;
  const int live = min(kVecChunk, k - c0);
  const int32_t id = lane < live ? __ldg(ids + qi * k + c0 + lane) : 0;
  const uint8_t* row[kVecChunk];
#pragma unroll
  for (int u = 0; u < kVecChunk; ++u)
    row[u] = table + clamp_row(__shfl_sync(kFull, id, u), n_rows) * static_cast<int64_t>(d);
  const float* q = qs + qi * d;
  float dot[kVecChunk], sq[kVecChunk];
#pragma unroll
  for (int u = 0; u < kVecChunk; ++u) dot[u] = sq[u] = 0.f;
  for (int d0 = 0; d0 < d; d0 += kVecPass * kWarp) {
    float qv[kVecPass], ov[kVecPass], sv[kVecPass], x[kVecChunk][kVecPass];
#pragma unroll
    for (int i = 0; i < kVecPass; ++i) {
      const int j = d0 + lane + i * kWarp;
      const bool in = j < d;
      qv[i] = in ? __ldg(q + j) : 0.f;
      if (kDequant) {
        ov[i] = in ? __ldg(offset + j) : 0.f;
        sv[i] = in ? __ldg(scale + j) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kVecChunk; ++u) {
#ifdef PROBE_PERM
        x[u][i] = in && u < live ? code_value<8>(__ldcs(row[u] + j), 0) : 0.f;
#else
        x[u][i] = in && u < live ? static_cast<float>(__ldcs(row[u] + j)) : 0.f;
#endif
      }
    }
#pragma unroll
    for (int u = 0; u < kVecChunk; ++u) {
#pragma unroll
      for (int i = 0; i < kVecPass; ++i) {
        float v = x[u][i];
#ifdef PROBE_NO_SUMS
        dot[u] += v;
#else
        if (kDequant) v = ov[i] + sv[i] * v;
        dot[u] += qv[i] * v;
        sq[u] += v * v;
#endif
      }
    }
  }
  const float dsum = reduce_scatter<kVecChunk>(dot, lane, kWarp);
  const float ssum = reduce_scatter<kVecChunk>(sq, lane, kWarp);
  constexpr int kSpan = kWarp / kVecChunk;
  const int c = lane / kSpan;
  if (lane % kSpan == 0 && c < live) out[qi * k + c0 + c] = ssum - 2.f * dsum;
}

// K3 (L2) on uint8 rows in another order of summation, as the package's
// vec_dist_bf16_kernel reads bf16 rows: 16-byte loads, lpr lanes a row (the
// least power of two >= the row's 16-byte units, 4 to 32), 32 / lpr rows
// side by side and kS = 4 rows a lane, so a warp owns 4 * 32 / lpr
// candidates; each lane sums its own 16-byte units, then the row's lanes
// reduce.
template <typename T, bool kDequant>
__global__ void __launch_bounds__(kVecWarps * kWarp)
free_kernel(const T* __restrict__ table, int64_t n_rows, int d,
            const int32_t* __restrict__ ids, int k, int lpr, int chunks, int64_t n_work,
            const float* __restrict__ qs, const float* __restrict__ offset,
            const float* __restrict__ scale, float* __restrict__ out) {
  constexpr int kS = 4;
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // values in 16 bytes
  constexpr int kWordPer = 4 / static_cast<int>(sizeof(T));
  const int lane = threadIdx.x % kWarp;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kVecWarps + threadIdx.x / kWarp;
  if (w >= n_work) return;
  const int rpw = kWarp / lpr, cpw = kS * rpw;
  const int g = lane / lpr, sl = lane % lpr;
  const int64_t qi = w / chunks;
  const int c0 = static_cast<int>(w % chunks) * cpw;
  const int live = min(cpw, k - c0);
  const int32_t id = lane < live ? __ldg(ids + qi * k + c0 + lane) : 0;
  const int units = d / kPer;
  const uint4* row[kS];
  bool ok[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int c = s * rpw + g;
    ok[s] = c < live;
    row[s] = reinterpret_cast<const uint4*>(table) +
             clamp_row(__shfl_sync(kFull, id, c), n_rows) * static_cast<int64_t>(units);
  }
  const float4* q4 = reinterpret_cast<const float4*>(qs + qi * d);
  const float4* o4 = reinterpret_cast<const float4*>(offset);
  const float4* s4 = reinterpret_cast<const float4*>(scale);
  float dot[kS], sq[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) dot[s] = sq[s] = 0.f;
  for (int e = sl; e < units; e += lpr) {
    uint4 x[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) x[s] = ok[s] ? __ldcs(row[s] + e) : make_uint4(0u, 0u, 0u, 0u);
    float qv[kPer], ov[kPer], sv[kPer];
#pragma unroll
    for (int m = 0; m < kPer / 4; ++m) {
      const float4 a = __ldg(q4 + e * (kPer / 4) + m);
      qv[4 * m] = a.x; qv[4 * m + 1] = a.y; qv[4 * m + 2] = a.z; qv[4 * m + 3] = a.w;
      if (kDequant) {
        const float4 b = __ldg(o4 + e * (kPer / 4) + m), c = __ldg(s4 + e * (kPer / 4) + m);
        ov[4 * m] = b.x; ov[4 * m + 1] = b.y; ov[4 * m + 2] = b.z; ov[4 * m + 3] = b.w;
        sv[4 * m] = c.x; sv[4 * m + 1] = c.y; sv[4 * m + 2] = c.z; sv[4 * m + 3] = c.w;
      }
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const uint32_t wd[4] = {x[s].x, x[s].y, x[s].z, x[s].w};
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        float v = word_value<T>(wd[m / kWordPer], m % kWordPer);
        if (kDequant) v = ov[m] + sv[m] * v;
        dot[s] += qv[m] * v;
        sq[s] += v * v;
      }
    }
  }
  const float ds = reduce_scatter<kS>(dot, sl, lpr);
  const float ss = reduce_scatter<kS>(sq, sl, lpr);
  const int span = lpr / kS;
  const int c = ((sl / span) % kS) * rpw + g;
  if (sl % span == 0 && c < live) out[qi * k + c0 + c] = ss - 2.f * ds;
}

// K3 (L2) on bf16 rows in the first port's order of summation, as
// vec_dist_bytes_kernel reads uint8 rows: 16 candidates a warp, each row's
// 256-byte pass read as two 4-byte words a lane (words l and 32 + l), then
// one shuffle a dim hands lane j its dims j + 32 i (dim j + 32 i is value j
// % 2 of word (j + 32 i) / 2, read by lane ((j + 32 i) / 2) % 32 in load i
// / 2). Not taken: measured against free_kernel, it costs more than 10%.
__global__ void __launch_bounds__(kVecWarps * kWarp)
keep_order_bf16_kernel(const __nv_bfloat16* __restrict__ table, int64_t n_rows, int d,
                       const int32_t* __restrict__ ids, int k, int chunks, int64_t n_work,
                       const float* __restrict__ qs, float* __restrict__ out) {
  constexpr int kC = 16, kG = 2;
  const int lane = threadIdx.x % kWarp;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kVecWarps + threadIdx.x / kWarp;
  if (w >= n_work) return;
  const int64_t qi = w / chunks;
  const int c0 = static_cast<int>(w % chunks) * kC;
  const int live = min(kC, k - c0);
  const int32_t id = lane < live ? __ldg(ids + qi * k + c0 + lane) : 0;
  const int row_words = d / 2;
  const uint32_t* row[kC];
#pragma unroll
  for (int u = 0; u < kC; ++u)
    row[u] = reinterpret_cast<const uint32_t*>(table) +
             clamp_row(__shfl_sync(kFull, id, u), n_rows) * static_cast<int64_t>(row_words);
  const float* q = qs + qi * d;
  float dot[kG][kVecChunk], sq[kG][kVecChunk];
#pragma unroll
  for (int u = 0; u < kC; ++u) dot[u / kVecChunk][u % kVecChunk] = sq[u / kVecChunk][u % kVecChunk] = 0.f;
  for (int d0 = 0; d0 < d; d0 += kVecPass * kWarp) {
    uint32_t x[kC][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int wi = d0 / 2 + h * kWarp + lane;
#pragma unroll
      for (int u = 0; u < kC; ++u) x[u][h] = wi < row_words && u < live ? __ldcs(row[u] + wi) : 0u;
    }
#pragma unroll
    for (int i = 0; i < kVecPass; ++i) {
      if (d0 + i * kWarp < d) {
        const int j = d0 + lane + i * kWarp;
        const float qv = j < d ? __ldg(q + j) : 0.f;
        const int src = (lane + kWarp * (i % 2)) / 2;
#pragma unroll
        for (int u = 0; u < kC; ++u) {
          const float v = word_value<__nv_bfloat16>(__shfl_sync(kFull, x[u][i / 2], src), lane & 1);
          dot[u / kVecChunk][u % kVecChunk] += qv * v;
          sq[u / kVecChunk][u % kVecChunk] += v * v;
        }
      }
    }
  }
  constexpr int kSpan = kWarp / kVecChunk;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const float dsum = reduce_scatter<kVecChunk>(dot[g], lane, kWarp);
    const float ssum = reduce_scatter<kVecChunk>(sq[g], lane, kWarp);
    const int c = g * kVecChunk + lane / kSpan;
    if (lane % kSpan == 0 && c < live) out[qi * k + c0 + c] = ssum - 2.f * dsum;
  }
}

}  // namespace
}  // namespace hnsw

// which: 0 = first_u8_kernel (uint8 rows; dequant when offset is given),
// 1 = the first port's kernel on bf16 rows (vec_dist_kernel<bf16>), 2 =
// free_kernel, 4 = the package's vec_dist_bytes_kernel with 8 candidates a
// warp, 5 = keep_order_bf16_kernel (bf16 rows). L2 only.
extern "C" int probe_run(int which, const void* table, int64_t n_rows, int d,
                         const void* ids, int q, int k, const void* qs,
                         const void* offset, const void* scale, void* out,
                         void* stream) {
  using namespace hnsw;
  auto st = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int32_t*>(ids);
  auto qf = static_cast<const float*>(qs);
  auto off = static_cast<const float*>(offset);
  auto sc = static_cast<const float*>(scale);
  auto o = static_cast<float*>(out);
  if (which >= 4) {
    const int kc = which == 4 ? 8 : 16;
    const int chunks = (k + kc - 1) / kc;
    const int64_t work = static_cast<int64_t>(q) * chunks;
    const auto grid = static_cast<unsigned>((work + kVecWarps - 1) / kVecWarps);
    if (which == 5)
      keep_order_bf16_kernel<<<grid, kVecWarps * kWarp, 0, st>>>(
          static_cast<const __nv_bfloat16*>(table), n_rows, d, i, k, chunks, work, qf, o);
    else if (off)
      vec_dist_bytes_kernel<true, false, 8><<<grid, kVecWarps * kWarp, 0, st>>>(
          static_cast<const uint8_t*>(table), n_rows, d, i, k, chunks, work, qf, off, sc, o);
    else
      vec_dist_bytes_kernel<false, false, 8><<<grid, kVecWarps * kWarp, 0, st>>>(
          static_cast<const uint8_t*>(table), n_rows, d, i, k, chunks, work, qf, off, sc, o);
    return static_cast<int>(cudaGetLastError());
  }
  if (which <= 1) {
#ifdef PROBE_NO_DEQUANT
    off = sc = nullptr;
#endif
    const int chunks = (k + kVecChunk - 1) / kVecChunk;
    const int64_t work = static_cast<int64_t>(q) * chunks;
    const auto grid = static_cast<unsigned>((work + kVecWarps - 1) / kVecWarps);
    if (which == 1)
      vec_dist_kernel<__nv_bfloat16, false, false><<<grid, kVecWarps * kWarp, 0, st>>>(
          static_cast<const __nv_bfloat16*>(table), n_rows, d, i, k, chunks, work, qf, off, sc, o);
    else if (off)
      first_u8_kernel<true><<<grid, kVecWarps * kWarp, 0, st>>>(
          static_cast<const uint8_t*>(table), n_rows, d, i, k, chunks, work, qf, off, sc, o);
    else
      first_u8_kernel<false><<<grid, kVecWarps * kWarp, 0, st>>>(
          static_cast<const uint8_t*>(table), n_rows, d, i, k, chunks, work, qf, off, sc, o);
    return static_cast<int>(cudaGetLastError());
  }
  const int units = d / 16;
  int lpr = 4;
  while (lpr < units && lpr < kWarp) lpr <<= 1;
  const int cpw = 4 * kWarp / lpr;
  const int chunks = (k + cpw - 1) / cpw;
  const int64_t work = static_cast<int64_t>(q) * chunks;
  const auto grid = static_cast<unsigned>((work + kVecWarps - 1) / kVecWarps);
  if (off)
    free_kernel<uint8_t, true><<<grid, kVecWarps * kWarp, 0, st>>>(
        static_cast<const uint8_t*>(table), n_rows, d, i, k, lpr, chunks, work, qf, off, sc, o);
  else
    free_kernel<uint8_t, false><<<grid, kVecWarps * kWarp, 0, st>>>(
        static_cast<const uint8_t*>(table), n_rows, d, i, k, lpr, chunks, work, qf, off, sc, o);
  return static_cast<int>(cudaGetLastError());
}
"""

# -D switches of first_u8_kernel, one library each
VARIANTS = {
    "first port": (),
    "no dequant": ("-DPROBE_NO_DEQUANT",),
    "byte-permute conversion": ("-DPROBE_PERM",),
    "no sums": ("-DPROBE_NO_SUMS",),
    "all three removed": ("-DPROBE_NO_DEQUANT", "-DPROBE_PERM",
                          "-DPROBE_NO_SUMS"),
}
P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
PROBE_ARGS = [I, P, I64, I, P, I, I, P, P, P, P, P]


def build_variants() -> dict:
    """One probe library per variant, nvcc processes all at once."""
    WORK.mkdir(parents=True, exist_ok=True)
    src = WORK / "k3_probe.cu"
    src.write_text(PROBE_SRC)
    jobs = {}
    for name, flags in VARIANTS.items():
        out = WORK / f"libk3_{len(jobs)}.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC_DIR),
               *flags, "-shared", "-o", str(out), str(src)]
        jobs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for name, (out, proc) in jobs.items():
        so, se = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc ({name}) failed:\n{so}{se}")
        lib = ctypes.CDLL(str(out))
        lib.probe_run.argtypes = PROBE_ARGS
        lib.probe_run.restype = ctypes.c_int
        libs[name] = lib
    return libs


def ptxas_report() -> None:
    """-Xptxas -v of dist_kernel.cu: the K3 kernels' registers and spills."""
    out = WORK / "dist_kernel.o"
    res = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v",
                          "-c", "-o", str(out),
                          str(_cuda.CSRC_DIR / "dist_kernel.cu")],
                         capture_output=True, text=True, check=True)
    lines = res.stderr.splitlines()
    for n, line in enumerate(lines):
        if "Compiling entry function" in line and "vec_dist" in line:
            name = demangle(re.search(r"'(\S+)'", line).group(1))
            info = [x.strip() for x in lines[n + 1:n + 4]
                    if "Used" in x or "spill" in x]
            cs.log(f"ptxas {name}: {' | '.join(info)}")


def cuda_tool(name: str) -> str:
    return str(Path(_cuda._nvcc()).parent / name)


def demangle(name: str) -> str:
    try:
        return subprocess.run([cuda_tool("cu++filt"), name],
                              capture_output=True,
                              text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return name


def sass_report(lib_path: Path) -> None:
    """Instruction counts of each K3 kernel in the package's library; the
    K3 kernels' SASS goes to k3_sass.txt in the probe's work directory."""
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True,
                          check=True).stdout
    dump = WORK / "k3_sass.txt"
    parts = [p for p in sass.split("Function : ")[1:]
             if "vec_dist" in p.split("\n", 1)[0]]
    dump.write_text("".join("Function : " + p for p in parts))
    for part in parts:
        name = part.split("\n", 1)[0].strip()
        ops = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", part)
        first_fma = next((n for n, op in enumerate(ops)
                          if op.startswith("FFMA")), len(ops))

        def count(prefix, upto=None):
            return sum(op.startswith(prefix) for op in ops[:upto])

        cs.log(f"sass {demangle(name)}: {len(ops)} instructions, LDG "
               f"{count('LDG')} ({count('LDG', first_fma)} before the first "
               f"FFMA), I2F {count('I2F')}, FFMA {count('FFMA')}, SHFL "
               f"{count('SHFL')}, PRMT {count('PRMT')}, LDL/STL "
               f"{count('LDL') + count('STL')}")


def run(lib, which, table, ids, qs, deq):
    q, k = ids.shape
    out = torch.empty((q, k), device=table.device)
    off, sc = (None, None) if deq is None else \
        (deq[0].data_ptr(), deq[1].data_ptr())
    err = lib.probe_run(which, table.data_ptr(), table.shape[0],
                        table.shape[1], ids.data_ptr(), q, k, qs.data_ptr(),
                        off, sc, out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"probe_run({which}): CUDA error {err}")
    return out


def probe_shape(tag, libs, ceil_lib, table, ids, qs, deq) -> None:
    plain = dk.gathered_vec_dist_plain(table, ids, qs, deq, metric="l2")
    b = cs.gather_bound(ids, table.shape[1], ip=False,
                        row_elem=table.element_size(),
                        dequant=deq is not None)
    cs.log(f"{tag}: bound {b['bound_ms']:.4f} ms ({b['bytes'] / 1e6:.1f} MB, "
           f"row-0 share {float((ids == 0).float().mean()):.3f})")
    u8 = table.dtype == torch.uint8
    cases = []
    if u8:
        for name, lib in libs.items():
            cases.append((f"{name} (1-byte loads)",
                          lambda lib=lib: run(lib, 0, table, ids, qs, deq),
                          name in ("first port", "byte-permute conversion")))
    else:
        cases.append(("first port (2-byte loads)",
                      lambda: run(libs["first port"], 1, table, ids, qs, deq),
                      True))
    cases += [
        ("package kernel", lambda: dk.gathered_vec_dist_ids(
            table, ids, qs, deq, metric="l2"), True),
        ("bytes kernel, 8 candidates a warp" if u8 else
         "first port's order, 4-byte loads and shuffles", lambda: run(
             libs["first port"], 4 if u8 else 5, table, ids, qs, deq), True),
    ]
    if u8:      # on bf16 rows the package's kernel is the free order
        cases.append(("free order (16-byte loads)", lambda: run(
            libs["first port"], 2, table, ids, qs, deq), True))
    for name, fn, checked in cases:
        if checked:
            cs.compare(f"  {tag} {name} vs plain", fn(), plain, rtol=1e-5,
                       atol=1e-3)
    times = {}
    for name, fn, _ in cases + cases[::-1]:     # in turns, there and back
        times.setdefault(name, []).append(cs.time_ms(fn))
    for name, ts in times.items():
        ms = sum(ts) / len(ts)
        cs.log(f"  {tag} {name}: {ms:.4f} ms ({', '.join(f'{t:.4f}' for t in ts)}"
               f"), share of bound {b['bound_ms'] / ms:.3f}")
    for width in (1, 4, 16):
        if table.shape[1] * table.element_size() % width == 0:
            cs.log(f"  {tag} gather ceiling, {width}-byte loads: "
                   f"{ab.ceiling_ms(ceil_lib, table, ids, width):.4f} ms")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_k3_probe: CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(f"card: {card}")
    torch.set_float32_matmul_precision("highest")
    t0 = time.time()
    lib_path = _cuda.build_library()
    _cuda.library()
    libs = build_variants()
    ceil_lib = ab.build_ceiling(WORK)
    cs.log(f"built in {time.time() - t0:.1f} s")
    ptxas_report()
    sass_report(lib_path)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n = cs.NORTH_STAR_N
    for dtype, d, zero in ((torch.uint8, 96, 0.45), (torch.bfloat16, 128,
                                                      0.49)):
        if dtype == torch.uint8:
            table = torch.randint(0, 256, (n, d), generator=gen, device=dev,
                                  dtype=torch.uint8)
            deq = (torch.randn(d, generator=gen, device=dev),
                   0.01 + 0.02 * torch.rand(d, generator=gen, device=dev))
        else:
            table = torch.randn((n, d), generator=gen, device=dev).to(dtype)
            deq = None
        name = str(dtype).removeprefix("torch.")
        for tag, q, k, z in (("serving hop", 8192, 64, 0.0),
                             ("build level-0 hop", 2048, 256, zero),
                             ("build descent", 2048, 32, 1.0),
                             ("build entry", 2048, 1, 0.0)):
            ids = ab.masked_ids(q, k, n, z, gen, dev)
            qs = torch.randn((q, d), generator=gen, device=dev)
            probe_shape(f"{name} d={d} {tag} Q={q} K={k}", libs, ceil_lib,
                        table, ids, qs, deq)
        del table


if __name__ == "__main__":
    main()
