// Fused gather + distance for Hopper (sm_90a): K5 of the port.
//
// Replaces the TPU kernel fused_gather_distances (_kernel; pallas_call at
// hnsw_tpu/ops/hop_kernel.py:118), the distance of every hop, the entry
// rescore and the greedy descent when HNSW_TPU_PALLAS_HOP=1.
//
// What bounds it on the H100: bytes of scattered f32 rows. Each query reads
// K rows of d * 4 bytes from random places in a [capacity, d] table (512 B
// at d = 128); at 1 FLOP per byte the arithmetic is nothing beside the
// reads.
//
// What the design does about it. The TPU kernel issued one DMA per row
// into double-buffered VMEM scratch, because its scalar core could not
// gather any other way (and needed Q % 8 == 0, d % 128 == 0). On Hopper the
// gather is ordinary loads:
//   * one block per query holds the query row in shared memory;
//   * one warp per (query, candidate) row: 16-byte loads (float4), lane i
//     reading bytes [16 i, 16 i + 16) of the row, so a 512-byte row is one
//     fully coalesced warp-wide read with four rows' worth of loads in
//     flight per SM sub-partition; the query is read from shared memory as
//     float4 too (conflict-free);
//   * sums stay in registers and reduce with shuffles.
// Rows are read with 4-byte loads when d % 4 != 0 or the table is not
// 16-byte aligned. Ids are clamped to [0, capacity - 1] here, as the TPU
// kernel's wrapper does. Any Q, any K, any d; every offset is int64.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace hnsw {
namespace {

constexpr int kHopThreads = 256;

template <bool kIP, bool kVec4>
__global__ void __launch_bounds__(kHopThreads)
gather_dist_kernel(const float* __restrict__ vectors, int64_t cap, int d,
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
    const float* v = vectors + row * static_cast<int64_t>(d);
    float dot = 0.f, sq = 0.f;
    if (kVec4) {
      const float4* v4 = reinterpret_cast<const float4*>(v);
      for (int i = lane; i < d / 4; i += kWarp) {
        const float4 x = __ldg(v4 + i);
        const float4 y = q4_s[i];
        dot += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
        if (!kIP) sq += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
      }
    } else {
      for (int j = lane; j < d; j += kWarp) {
        const float x = __ldg(v + j);
        dot += q_s[j] * x;
        if (!kIP) sq += x * x;
      }
    }
    dot = warp_sum(dot);
    if (!kIP) sq = warp_sum(sq);
    if (lane == 0) out[qi * k + c] = kIP ? -dot : sq - 2.f * dot;
  }
}

template <bool kIP>
void launch_gather(const float* vectors, int64_t cap, int d,
                   const int32_t* ids, int q, int k, const float* queries,
                   float* out, cudaStream_t s) {
  const size_t smem = static_cast<size_t>((d + 3) / 4) * sizeof(float4);
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(vectors) % 16 == 0;
  if (vec4)
    gather_dist_kernel<kIP, true><<<q, kHopThreads, smem, s>>>(vectors, cap, d, ids, k, queries, out);
  else
    gather_dist_kernel<kIP, false><<<q, kHopThreads, smem, s>>>(vectors, cap, d, ids, k, queries, out);
}

}  // namespace
}  // namespace hnsw

// vectors: float32 [cap, d]; ids: int32 [q, k] (clamped here); queries:
// float32 [q, d]; ip: 0 = L2 surrogate, 1 = -dot; out: float32 [q, k].
extern "C" int hnsw_gather_dist(const void* vectors, int64_t cap, int d,
                                const void* ids, int q, int k,
                                const void* queries, int ip, void* out,
                                void* stream) {
  using namespace hnsw;
  if (q <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto v = static_cast<const float*>(vectors);
  auto i = static_cast<const int32_t*>(ids);
  auto qf = static_cast<const float*>(queries);
  auto o = static_cast<float*>(out);
  if (ip)
    launch_gather<true>(v, cap, d, i, q, k, qf, o, s);
  else
    launch_gather<false>(v, cap, d, i, q, k, qf, o, s);
  return static_cast<int>(cudaGetLastError());
}
