// Helpers shared by the kernels of hnsw_tpu_torch (plain C interface, built
// with nvcc for sm_90a and loaded through ctypes; see ops/_cuda.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hnsw {

constexpr int kWarp = 32;

// a row value as f32 (exact for each row type)
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }

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

// --- Hopper's bulk copy engine: mbarriers and cp.async.bulk (sm_90) ---

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that also announces `bytes` of copies still to land
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global to shared memory; completion lands on `bar` as transaction bytes
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A ring of `n` stages of `stage_bytes` in shared memory, filled by one
// producer thread with bulk copies and drained by `consumers` warps: the
// row pipeline of the packed-row kernels. Producer and consumers each walk
// the rows in the same order with a Pos (stage, phase), advanced by
// pos.next(n) after every row:
//   producer: st = acquire(pos, bytes); copy(pos, ...) into st, `bytes` in
//             all;
//   consumer: st = wait(pos); read st; __syncwarp(); lane 0: release(pos).
// full[s] completes a phase when the copies of its current round have
// landed, empty[s] when every consumer warp has released it.
struct RowRing {
  uint64_t* full;   // [n]
  uint64_t* empty;  // [n]
  char* stages;     // [n * stage_bytes], 16-byte aligned
  int n;
  int stage_bytes;

  struct Pos {
    int stage = 0;
    uint32_t phase = 0;  // parity of the round through the ring
    __device__ void next(int n) {
      if (++stage == n) {
        stage = 0;
        phase ^= 1u;
      }
    }
  };

  static constexpr int kBarrierBytes = 128;  // room for 8 stages' barriers

  // carve from `smem`: the barriers first, then the stages
  __device__ RowRing(char* smem, int n_stages, int stage_bytes_)
      : full(reinterpret_cast<uint64_t*>(smem)),
        empty(reinterpret_cast<uint64_t*>(smem) + n_stages),
        stages(smem + kBarrierBytes),
        n(n_stages),
        stage_bytes(stage_bytes_) {}

  __host__ __device__ static size_t smem_bytes(int n_stages, int stage_bytes) {
    return kBarrierBytes + static_cast<size_t>(n_stages) * stage_bytes;
  }

  // one thread, before any other use; the block then syncs
  __device__ void init(int consumers) const {
    for (int s = 0; s < n; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  __device__ char* acquire(const Pos& p, uint32_t bytes) const {
    mbar_wait(empty + p.stage, p.phase ^ 1u);  // round 0 passes at once
    mbar_arrive_expect_tx(full + p.stage, bytes);
    return stages + p.stage * stage_bytes;
  }

  __device__ void copy(const Pos& p, void* dst, const void* src, uint32_t bytes) const {
    bulk_copy_g2s(dst, src, bytes, full + p.stage);
  }

  __device__ const char* wait(const Pos& p) const {
    mbar_wait(full + p.stage, p.phase);
    return stages + p.stage * stage_bytes;
  }

  __device__ void release(const Pos& p) const { mbar_arrive(empty + p.stage); }
};

}  // namespace hnsw
