// Fused gather + distance for Hopper (sm_90a): K5 of the port.
//
// Replaces the TPU kernel fused_gather_distances (_kernel; pallas_call at
// hnsw_tpu/ops/hop_kernel.py:118), the distance of every hop, the entry
// rescore and the greedy descent when HNSW_TPU_PALLAS_HOP=1.
//
// What bounds it on the H100: bytes of scattered rows. Each query reads K
// rows of d * itemsize bytes from random places in a [capacity, d] table
// (512 B at d = 128 f32, 256 B bf16); at 1-2 FLOP per byte the arithmetic
// is nothing beside the reads, and HBM reaches its rate only with many rows
// in flight per SM.
//
// The TPU kernel issued one DMA per row into double-buffered VMEM scratch,
// because its scalar core could not gather any other way (and needed Q % 8
// == 0, d % 128 == 0). It computes K3's function (gathered_vec_dist)
// without the dequant affine, so on Hopper it runs K3's row engines
// (vec_dist.cuh): a flat grid of (query, chunk of candidates) warps, every
// row load of a pass issued evict-first before the first FMA, the query in
// registers and no shared memory, bf16 rows widened in registers (never
// copied to an f32 table). Its results equal K3's bit for bit on the same
// rows. The first port's kernel (one block of 8 warps per query, the query
// staged in shared memory, each warp walking its rows one at a time with
// about one row in flight) ran f32 rows at 60% of the bound and bf16 rows at
// 43%. Ids are clamped to [0, capacity - 1] in the kernel, as the TPU
// kernel's wrapper clamps them. Any Q, any K, any d; every offset is int64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "vec_dist.cuh"

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
      launch_vec_src<float, false>(vectors, cap, d, i, nullptr, q, k, qf, nullptr, nullptr, ip, o,
                                   s);
      break;
    case 1:
      launch_vec_src<__nv_bfloat16, false>(vectors, cap, d, i, nullptr, q, k, qf, nullptr, nullptr,
                                           ip, o, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
