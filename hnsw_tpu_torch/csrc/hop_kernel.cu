// Fused gather + distance for Hopper (sm_90a): K5 of the port.
//
// Replaces the TPU kernel fused_gather_distances (_kernel; pallas_call at
// hnsw_tpu/ops/hop_kernel.py:118), the distance of every hop, the entry
// rescore and the greedy descent when HNSW_TPU_PALLAS_HOP=1.
//
// What bounds it on the H100: bytes of scattered rows. Each query reads K
// rows of d * itemsize bytes from random places in a [capacity, d] table
// (512 B at d = 128 f32, 256 B bf16); at 1-2 FLOP per byte the arithmetic
// is nothing beside the reads.
//
// What the design does about it. The TPU kernel issued one DMA per row
// into double-buffered VMEM scratch, because its scalar core could not
// gather any other way (and needed Q % 8 == 0, d % 128 == 0). On Hopper the
// gather is ordinary loads:
//   * one block per query holds the query row in shared memory;
//   * one warp per (query, candidate) row: 16-byte loads, lane i reading
//     bytes [16 i, 16 i + 16) of the row (4 f32 or 8 bf16 values), so a
//     512-byte row is one fully coalesced warp-wide read with four rows'
//     worth of loads in flight per SM sub-partition; the query is read from
//     shared memory as float4 too (conflict-free);
//   * bf16 rows are widened to f32 in registers (exact: a bf16 is the high
//     half of the f32 of the same value), so the table is never copied to
//     f32 as the TPU kernel's wrapper copies it;
//   * sums stay in registers and reduce with shuffles.
// Rows are read one value a lane when a row is not a whole number of 16-byte
// loads or the table is not 16-byte aligned. Ids are clamped to [0,
// capacity - 1] here, as the TPU kernel's wrapper does. Any Q, any K, any d;
// every offset is int64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace hnsw {
namespace {

constexpr int kHopThreads = 256;

// the dot and (L2) squared norm of four bf16 values (as floats) against
// four query values, summed as the f32 path sums a float4
template <bool kIP>
__device__ __forceinline__ void add4(float& dot, float& sq, float a, float b, float c, float e,
                                     const float4 y) {
  dot += a * y.x + b * y.y + c * y.z + e * y.w;
  if (!kIP) sq += a * a + b * b + c * c + e * e;
}

// kVec: each lane reads 16 bytes a load (4 f32 or 8 bf16 values); else one
// value a lane.
template <typename T, bool kIP, bool kVec>
__global__ void __launch_bounds__(kHopThreads)
gather_dist_kernel(const T* __restrict__ vectors, int64_t cap, int d,
                   const int32_t* __restrict__ ids, int k,
                   const float* __restrict__ queries, float* __restrict__ out) {
  extern __shared__ float4 q4_s[];  // [ceil(d / 4)]
  float* q_s = reinterpret_cast<float*>(q4_s);
  const int64_t qi = blockIdx.x;
  for (int j = threadIdx.x; j < d; j += blockDim.x) q_s[j] = queries[qi * d + j];
  __syncthreads();
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  for (int c = warp; c < k; c += n_warps) {
    const int64_t row = clamp_row(ids[qi * k + c], cap);
    const T* v = vectors + row * static_cast<int64_t>(d);
    float dot = 0.f, sq = 0.f;
    if constexpr (kVec && sizeof(T) == 4) {
      const float4* v4 = reinterpret_cast<const float4*>(v);
      for (int i = lane; i < d / 4; i += kWarp) {
        const float4 x = __ldg(v4 + i);
        const float4 y = q4_s[i];
        dot += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
        if (!kIP) sq += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
      }
    } else if constexpr (kVec) {  // bf16: value 2 m in the low half of word m
      const uint4* v8 = reinterpret_cast<const uint4*>(v);
      for (int i = lane; i < d / 8; i += kWarp) {
        const uint4 x = __ldg(v8 + i);
        add4<kIP>(dot, sq, __uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
                  __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u), q4_s[2 * i]);
        add4<kIP>(dot, sq, __uint_as_float(x.z << 16), __uint_as_float(x.z & 0xffff0000u),
                  __uint_as_float(x.w << 16), __uint_as_float(x.w & 0xffff0000u),
                  q4_s[2 * i + 1]);
      }
    } else {
      for (int j = lane; j < d; j += kWarp) {
        const float x = to_f32(__ldg(v + j));
        dot += q_s[j] * x;
        if (!kIP) sq += x * x;
      }
    }
    dot = warp_sum(dot);
    if (!kIP) sq = warp_sum(sq);
    if (lane == 0) out[qi * k + c] = kIP ? -dot : sq - 2.f * dot;
  }
}

template <typename T, bool kIP>
void launch_gather(const void* vectors, int64_t cap, int d,
                   const int32_t* ids, int q, int k, const float* queries,
                   float* out, cudaStream_t s) {
  const T* v = static_cast<const T*>(vectors);
  const size_t smem = static_cast<size_t>((d + 3) / 4) * sizeof(float4);
  constexpr int kPer = 16 / sizeof(T);  // values a 16-byte load holds
  const bool vec = d % kPer == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (vec)
    gather_dist_kernel<T, kIP, true><<<q, kHopThreads, smem, s>>>(v, cap, d, ids, k, queries, out);
  else
    gather_dist_kernel<T, kIP, false><<<q, kHopThreads, smem, s>>>(v, cap, d, ids, k, queries, out);
}

}  // namespace
}  // namespace hnsw

// vectors: [cap, d] rows of dtype 0 = float32 or 1 = bfloat16; ids: int32
// [q, k] (clamped here); queries: float32 [q, d]; ip: 0 = L2 surrogate,
// 1 = -dot; out: float32 [q, k].
extern "C" int hnsw_gather_dist(const void* vectors, int dtype, int64_t cap,
                                int d, const void* ids, int q, int k,
                                const void* queries, int ip, void* out,
                                void* stream) {
  using namespace hnsw;
  if (q <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int32_t*>(ids);
  auto qf = static_cast<const float*>(queries);
  auto o = static_cast<float*>(out);
  switch (dtype) {
    case 0:
      ip ? launch_gather<float, true>(vectors, cap, d, i, q, k, qf, o, s)
         : launch_gather<float, false>(vectors, cap, d, i, q, k, qf, o, s);
      break;
    case 1:
      ip ? launch_gather<__nv_bfloat16, true>(vectors, cap, d, i, q, k, qf, o, s)
         : launch_gather<__nv_bfloat16, false>(vectors, cap, d, i, q, k, qf, o, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
