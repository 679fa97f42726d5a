// Helpers shared by the kernels of hnsw_tpu_torch (plain C interface, built
// with nvcc for sm_90a and loaded through ctypes; see ops/_cuda.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hnsw {

constexpr int kWarp = 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row ids come from the caller already made safe (-1 mapped to 0); the
// clamp only keeps a bad id from reading outside the table.
__device__ __forceinline__ int64_t clamp_row(int64_t row, int64_t n_rows) {
  return row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
}

}  // namespace hnsw
