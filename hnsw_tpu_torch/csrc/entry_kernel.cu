// The search's sampled entry scan for Hopper (sm_90a): K6 of the port.
//
// Replaces no TPU kernel: the reference's _sample_seeds (hnsw_tpu/search.py
// :227) is dense XLA, and the port ran it as plain PyTorch (a cuBLAS f32
// product into a [Q, S] block, then a scale, a broadcast subtract, a where
// and an argmin over that block). For every query q and stratum j of the
// sample (S rows cut into n_seeds equal contiguous strata of ss rows) it
// returns the index within the stratum of the least
//   dist(q, s) = svsq[s] - 2 dot(q, sv[s])     (L2)
//   dist(q, s) = -dot(q, sv[s])                (IP)
// over the rows with ok[s], the first index on a tie, or -1 where no row of
// the stratum gives a finite distance.
//
// What bounds it on the H100: f32 operations. 2 Q S d of them (34.4 GFLOP
// at Q = 8192, S = 16384, d = 128: 0.51 ms at 67 TFLOP/s) against ~12 MB of
// operands that fit in L2 and a [Q, n_seeds] output. The plain composition
// wrote the [Q, S] distance block (128 MB a 2,048-query tile, more than L2
// holds) and read and wrote it four more times.
//
// What the design does about it. One kernel computes the product on the
// FFMA units in full f32 (no TF32) and reduces it in its epilogue, so the
// distance block never leaves registers:
//   * a block owns an output tile of 128 queries x 128 sample rows (256
//     threads), each thread 8 x 8 outputs from fragments read as float4
//     from shared memory. One tile serves every shape: at Q = 512 (the
//     requests cell's padded flush) and S = 16,384 it gives 512 blocks,
//     ~4 an SM. 64-row tiles, with twice the blocks, read 4-6% slower at
//     the cells' shapes and that flush's, and no faster at Q = 512,
//     S = 4,096 (PERF.md, K6). (128 x 256 tiles of 8 x 16 a thread,
//     stages of 16 dims, fragments read a dim ahead or no register cap
//     timed within 3% of this at the cells' shapes; the product alone,
//     with no epilogue, ran at 61-64% of the bound for d from 96 to 1,024);
//   * operands go through shared memory in stages of 8 dims, transposed on
//     the way (dims outer), double-buffered: the next stage's global loads
//     are in flight in registers while the current one is multiplied; dims
//     past d and rows past Q or S load as zeros;
//   * the epilogue forms each distance as the plain code does
//     (fmaf(-2, dot, svsq) rounds as svsq - 2.0 * dot, since 2 dot is
//     exact; -dot under IP), with masked rows and rows past S at +inf, and
//     keeps the running (distance, index) minimum of a query row over the
//     thread's columns in ascending order with a strict <, so the first
//     index wins a tie;
//   * minima merge as 64-bit keys, (order-preserving bits of the distance)
//     << 32 | sample index, whose order is the (distance, index) order, so
//     the result does not depend on the order the blocks run in. Where a
//     stratum spans whole warps (ss a multiple of 32, every cell's sample):
//     warp shuffles, one plain shared store a (warp, row), and one thread a
//     row merging the warps of each stratum into one global atomicMin. A
//     64-bit atomicMin in shared memory is a compare-and-swap loop on this
//     card (it cost the first version ~20% of its time), so only strata
//     narrower than a warp's columns (the seed mode's small samples) merge
//     through shared atomics;
//   * the C entry sets the keys to the largest key (a memset on the same
//     stream, a node of the same CUDA graph), launches the scan, then a
//     small kernel that turns each key into the index within its stratum
//     or -1.
// The sums run in another order than cuBLAS's, so a near-tie may seed
// another row than the plain version does. A NaN distance never wins (the
// plain argmin would pick it, and return -1 for the stratum).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace hnsw {
namespace {

constexpr int kPad = 4;                    // floats of padding a staged dim
constexpr int kMinStratum = 8;             // the least ss taken
constexpr unsigned long long kNoKey = ~0ull;

// A float's bits in an order that sorts as the float does (-0 as +0).
__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long make_key(float dist, uint32_t col) {
  return (static_cast<unsigned long long>(order_bits(dist)) << 32) | col;
}

__device__ __forceinline__ unsigned long long min_key(unsigned long long a,
                                                      unsigned long long b) {
  return a < b ? a : b;
}

// component c of v (c a constant once unrolled)
__device__ __forceinline__ float lane4(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// Four consecutive dims k..k+3 of row `row` (zeros past the rows or d).
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ base, int row, int n_rows,
                                        int k, int d) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < n_rows && k < d) {
    const float* p = base + static_cast<int64_t>(row) * d + k;
    if (kVec) {  // d % 4 == 0 and 16-byte aligned rows: k < d covers k + 3
      v = __ldg(reinterpret_cast<const float4*>(p));
    } else {
      v.x = __ldg(p);
      if (k + 1 < d) v.y = __ldg(p + 1);
      if (k + 2 < d) v.z = __ldg(p + 2);
      if (k + 3 < d) v.w = __ldg(p + 3);
    }
  }
  return v;
}

// A block's shape: BM queries x BN sample rows, BK dims a stage; a thread
// owns 8 x TN outputs (rows in two float4 runs 32 apart, columns in TN / 4
// float4 runs 16 apart), a warp 64 x 4 TN as 8 x 4 lanes.
struct Tile {
  static constexpr int BM = 128, BN = 128, TN = 8, BK = 8;
  static constexpr int kWarpsM = BM / 64, kWarpsN = BN / (4 * TN);
  static constexpr int kThreads = kWarpsM * kWarpsN * kWarp;
  // blocks an SM should hold: 512 threads of 8 x 8 outputs fit in 65,536
  // registers at up to 128 a thread
  static constexpr int kMinBlocks = 512 / kThreads;
  static constexpr int kASlots = BM * BK / 4 / kThreads;  // float4 loads a stage
  static constexpr int kBSlots = BN * BK / 4 / kThreads;
  static constexpr int kMaxStrata = BN / kMinStratum + 1;  // strata a block can touch
  static constexpr int kAS = BM + kPad, kBS = BN + kPad;
  static_assert(kASlots * kThreads * 4 == BM * BK && kBSlots * kThreads * 4 == BN * BK, "loads");
  struct Smem {
    union {
      struct {
        float a[2][BK][kAS];  // queries, dims outer
        float b[2][BK][kBS];  // sample rows, dims outer
      } t;
      unsigned long long wkey[kWarpsN][BM];    // the epilogue's minima by warp,
      unsigned long long key[BM][kMaxStrata];  // or by (row, stratum)
    } u;
    float bias[BN];  // svsq (L2) or 0 (IP) where ok, +inf elsewhere
  };
};

// grid (ceil(S / BN), ceil(Q / BM)). keys [Q, n_seeds] hold kNoKey on entry.
template <bool kVec>
__global__ void __launch_bounds__(Tile::kThreads, Tile::kMinBlocks)
    entry_scan_kernel(const float* __restrict__ queries, const float* __restrict__ sv,
                      const float* __restrict__ svsq, const uint8_t* __restrict__ ok, int nq,
                      int ns, int d, int ss, int n_seeds, int ip,
                      unsigned long long* __restrict__ keys) {
  constexpr int BM = Tile::BM, BN = Tile::BN, TN = Tile::TN, BK = Tile::BK;
  constexpr int kThreads = Tile::kThreads;
  constexpr int kQuads = BK / 4;  // float4 of a row a stage
  __shared__ __align__(16) Tile::Smem sm;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  for (int c = tid; c < BN; c += kThreads) {
    const int col = n0 + c;
    sm.bias[c] = (col < ns && ok[col]) ? (ip ? 0.f : svsq[col]) : INFINITY;
  }

  // a stage: slot -> row slot / kQuads, dims (slot % kQuads) * 4 .. + 3
  float4 ra[Tile::kASlots], rb[Tile::kBSlots];
  auto load_stage = [&](int k0) {
#pragma unroll
    for (int i = 0; i < Tile::kASlots; ++i) {
      const int slot = tid + i * kThreads;
      ra[i] = load4<kVec>(queries, m0 + slot / kQuads, nq, k0 + slot % kQuads * 4, d);
    }
#pragma unroll
    for (int i = 0; i < Tile::kBSlots; ++i) {
      const int slot = tid + i * kThreads;
      rb[i] = load4<kVec>(sv, n0 + slot / kQuads, ns, k0 + slot % kQuads * 4, d);
    }
  };
  auto store_stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < Tile::kASlots; ++i) {
      const int slot = tid + i * kThreads;
      const int r = slot / kQuads, k = slot % kQuads * 4;
      sm.u.t.a[buf][k + 0][r] = ra[i].x;
      sm.u.t.a[buf][k + 1][r] = ra[i].y;
      sm.u.t.a[buf][k + 2][r] = ra[i].z;
      sm.u.t.a[buf][k + 3][r] = ra[i].w;
    }
#pragma unroll
    for (int i = 0; i < Tile::kBSlots; ++i) {
      const int slot = tid + i * kThreads;
      const int r = slot / kQuads, k = slot % kQuads * 4;
      sm.u.t.b[buf][k + 0][r] = rb[i].x;
      sm.u.t.b[buf][k + 1][r] = rb[i].y;
      sm.u.t.b[buf][k + 2][r] = rb[i].z;
      sm.u.t.b[buf][k + 3][r] = rb[i].w;
    }
  };

  // warps tile the block as kWarpsM x kWarpsN of 64 x 4 TN; a lane owns
  // rows lm*4 + {0..3} and + 32, columns ln*4 + 16 c + {0..3} of its warp's
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int wm = warp / Tile::kWarpsN, wn = warp % Tile::kWarpsN;
  const int lm = lane & 7, ln = lane >> 3;
  const int am = wm * 64 + lm * 4;
  const int bn = wn * 4 * TN + ln * 4;

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int n_stages = (d + BK - 1) / BK;
  load_stage(0);
  store_stage(0);
  __syncthreads();
  for (int st = 0; st < n_stages; ++st) {
    const int buf = st & 1;
    if (st + 1 < n_stages) load_stage((st + 1) * BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a4[2] = {*reinterpret_cast<const float4*>(&sm.u.t.a[buf][k][am]),
                            *reinterpret_cast<const float4*>(&sm.u.t.a[buf][k][am + 32])};
      float4 b4[TN / 4];
#pragma unroll
      for (int c = 0; c < TN / 4; ++c)
        b4[c] = *reinterpret_cast<const float4*>(&sm.u.t.b[buf][k][bn + 16 * c]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(lane4(a4[i >> 2], i & 3), lane4(b4[j >> 2], j & 3), acc[i][j]);
    }
    if (st + 1 < n_stages) store_stage(buf ^ 1);
    __syncthreads();
  }

  // --- epilogue: each (row, stratum)'s least key of the block, then one
  // global atomicMin for it ---
  const float scale = ip ? -1.f : -2.f;
  float bias[TN];
  uint32_t col[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = bn + (j >> 2) * 16 + (j & 3);
    bias[j] = sm.bias[c];
    col[j] = static_cast<uint32_t>(n0 + c);
  }
  auto flush = [&](int row, int stratum, unsigned long long key) {
    if (stratum < n_seeds) atomicMin(&keys[static_cast<int64_t>(row) * n_seeds + stratum], key);
  };
  if (ss % (4 * TN) == 0) {
    // every warp's 4 TN columns lie in one stratum: a row's least key of a
    // warp by shuffles, one store a (warp column, row); then a thread a row
    // merges the warps of each stratum
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float best = INFINITY;
      uint32_t at = 0xffffffffu;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float dist = fmaf(scale, acc[i][j], bias[j]);
        if (dist < best) {
          best = dist;
          at = col[j];
        }
      }
      unsigned long long key = make_key(best, at);
      key = min_key(key, __shfl_xor_sync(0xffffffffu, key, 8));
      key = min_key(key, __shfl_xor_sync(0xffffffffu, key, 16));
      if (ln == 0) sm.u.wkey[wn][am + (i >> 2) * 32 + (i & 3)] = key;
    }
    __syncthreads();
    for (int r = tid; r < BM && m0 + r < nq; r += kThreads) {
      int stratum = n0 / ss;
      unsigned long long key = sm.u.wkey[0][r];
#pragma unroll
      for (int w = 1; w < Tile::kWarpsN; ++w) {
        const int sw = (n0 + w * 4 * TN) / ss;
        if (sw != stratum) {
          flush(m0 + r, stratum, key);
          stratum = sw;
          key = sm.u.wkey[w][r];
        } else {
          key = min_key(key, sm.u.wkey[w][r]);
        }
      }
      flush(m0 + r, stratum, key);
    }
    return;
  }
  // strata narrower than a warp's columns (the seed mode's small samples):
  // a thread's runs of columns in one stratum, merged by atomicMin into a
  // slot a (row, stratum) of the block
  constexpr int kMaxStrata = Tile::kMaxStrata;
  const int s_first = n0 / ss;
  const int n_slots = (min(n0 + BN, ns) - 1) / ss - s_first + 1;
  for (int i = tid; i < BM * kMaxStrata; i += kThreads) (&sm.u.key[0][0])[i] = kNoKey;
  int slot[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) slot[j] = static_cast<int>(col[j]) / ss - s_first;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = am + (i >> 2) * 32 + (i & 3);
    float best = INFINITY;
    uint32_t at = 0xffffffffu;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (j > 0 && slot[j] != slot[j - 1]) {
        atomicMin(&sm.u.key[r][slot[j - 1]], make_key(best, at));
        best = INFINITY;
        at = 0xffffffffu;
      }
      const float dist = fmaf(scale, acc[i][j], bias[j]);
      if (dist < best) {
        best = dist;
        at = col[j];
      }
    }
    atomicMin(&sm.u.key[r][slot[TN - 1]], make_key(best, at));
  }
  __syncthreads();
  for (int i = tid; i < BM * n_slots; i += kThreads) {
    const int r = i / n_slots, s = i % n_slots;
    const unsigned long long key = sm.u.key[r][s];
    if (m0 + r < nq && key != kNoKey) flush(m0 + r, s_first + s, key);
  }
}

// keys [n] -> the index within the stratum, or -1 where the least distance
// is not finite (every row masked) or no key arrived.
__global__ void entry_finish_kernel(const unsigned long long* __restrict__ keys, int64_t n,
                                    int ss, int n_seeds, int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = keys[i];
  const uint32_t bits = static_cast<uint32_t>(key >> 32);
  // finite: strictly between the keys of -inf (0x007fffff) and +inf
  const bool finite = bits > 0x007fffffu && bits < 0xff800000u;
  const int stratum = static_cast<int>(i % n_seeds);
  out[i] = finite ? static_cast<int32_t>(static_cast<uint32_t>(key) -
                                         static_cast<uint32_t>(stratum) * ss)
                  : -1;
}

}  // namespace
}  // namespace hnsw

// queries f32 [nq, d], sv f32 [ns, d], svsq f32 [ns], ok bool [ns], all
// contiguous; ns = n_seeds * ss with ss >= 8; ip: 0 = L2 surrogate,
// 1 = -dot. keys int64 [nq, n_seeds] is scratch; out int32 [nq, n_seeds].
extern "C" int hnsw_entry_scan(const void* queries, int nq, int d, const void* sv,
                               const void* svsq, const void* ok, int ns, int n_seeds, int ip,
                               void* keys, void* out, void* stream) {
  using namespace hnsw;
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  if (d <= 0 || n_seeds <= 0 || ns % n_seeds != 0 || ns / n_seeds < kMinStratum)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int ss = ns / n_seeds;
  const int64_t n_out = static_cast<int64_t>(nq) * n_seeds;
  auto k = static_cast<unsigned long long*>(keys);
  cudaError_t err = cudaMemsetAsync(k, 0xff, n_out * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto q = static_cast<const float*>(queries);
  auto v = static_cast<const float*>(sv);
  auto sq = static_cast<const float*>(svsq);
  auto m = static_cast<const uint8_t*>(ok);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 grid((ns + Tile::BN - 1) / Tile::BN, (nq + Tile::BM - 1) / Tile::BM);
  if (vec)
    entry_scan_kernel<true><<<grid, Tile::kThreads, 0, s>>>(q, v, sq, m, nq, ns, d, ss, n_seeds,
                                                             ip, k);
  else
    entry_scan_kernel<false><<<grid, Tile::kThreads, 0, s>>>(q, v, sq, m, nq, ns, d, ss, n_seeds,
                                                              ip, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kFinishThreads = 256;
  entry_finish_kernel<<<static_cast<unsigned>((n_out + kFinishThreads - 1) / kFinishThreads),
                        kFinishThreads, 0, s>>>(k, n_out, ss, n_seeds, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
