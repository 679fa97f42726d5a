// Routing and rerank distances for Hopper (sm_90a): K3, K2 and K4 of the
// port.
//
// Replaces the TPU kernels of hnsw_tpu/ops/dist_kernel.py:
//   * gathered_vec_dist (_vec_dist_kernel; pallas_call at :308) ->
//     the row engines of vec_dist.cuh;
//   * packed_row_dist (_packed_dist_kernel; pallas_call at :129) ->
//     words_dist_kernel below with the L2 or IP epilogue (packed_dist_kernel
//     for rows the word engine cannot read);
//   * packed_row_dist_words (_words_dist_kernel; pallas_call at :227) ->
//     words_dist_kernel below, dots only.
//
// What bounds them on the H100: bytes of scattered rows. Each query reads K
// rows from random places in a table of up to several GB (K3: K vector rows
// of d * itemsize bytes; K2 and K4: one packed code row of K * d * bits/8
// bytes, plus K norms for K2). At 2 FLOP per byte or less the arithmetic is
// nothing beside the reads, and each row is a separate burst of 128 to 8192
// bytes. HBM reaches its 3.35 TB/s only with ~25 KB of such reads in flight
// per SM, so every design below is about keeping rows in flight. Every row
// offset is int64: row * row_w crosses 2^31 at node 262,144 for 8 KB packed
// rows (the reference's round-2 corruption bug). Any d and any K: there is
// no shape padding.
//
// K3 (vec_dist_kernel, vec_dist_bytes_kernel, vec_dist_bf16_kernel): the
// row engines in vec_dist.cuh, shared with K5 (hop_kernel.cu), where their
// design is described.
//
// K4 and K2 (words_dist_kernel). The TPU kernel lane-split each int32 word
// row to [rows, 128], multiplied each byte plane against G-tiled query
// planes and summed each candidate's wp lanes with a 0/1 selector matmul on
// the MXU; it needed m0 % (128 / wp) == 0. On Hopper none of that is
// needed. Each (query, expansion) reads one row (8 KB at d = 128 8-bit, K =
// 64). The first port gave each a block that staged the query behind a
// barrier before its first row load and had each warp walk its candidates
// one 128-byte load and one 5-shuffle reduction at a time: ~8 KB in flight
// per SM, ~1 TB/s. Once the copies overlap, the sums are the next limit:
// 8,192 values a row, each an extract, a convert and an FMA, plus the
// shuffle trees, take about as long as the row copies themselves on the
// H100, so the sums are written to be cheap as well:
//   * persistent grid (SMs x resident blocks); blocks walk rows b =
//     blockIdx.x, b += gridDim.x over the Q * T (query, expansion) pairs;
//   * a RowRing (common.cuh) of two shared-memory stages a block: one
//     producer warp reads 32 cur[] ids at once and, for each row, one lane
//     issues cp.async.bulk copies into the next free stage: the whole word
//     row (pad words included; copied, never summed), the query row b / t
//     and, for K2's L2, the row's K norms; completion lands on the stage's
//     mbarrier, so the next row is in flight while this one is summed (~70
//     KB an SM at d = 128);
//   * eight consumer warps sum from shared memory: lanes per candidate lpc
//     = the least power of two >= the words that carry values (ceil(d *
//     bits / 32), at most 32); where a lane owns at most one word of a
//     candidate (up to d = 128 at 8 bits) its query values stay in
//     registers for the row and a warp loads 8 candidates' words at once;
//     each value becomes an exact float with a byte permute and a subtract
//     (no int-to-float conversion); the 8 candidates' xor trees share their
//     first levels as a reduce-scatter (9 shuffles instead of 40);
//   * order of summation: the first port's, kept on purpose and checked bit
//     for bit on the card (lane sl sums word sl's values in value order,
//     then words sl + lpc, ...; then the same xor tree), so the words
//     search cannot drift from the bytes search. That is why the consumers
//     read 4-byte words: a 16-byte read would make lane i sum words
//     4i..4i+3 and change it;
//   * the query stage is zero past d (written once, before any copy), so
//     dims >= d never meet a query value;
//   * rows the bulk engine cannot take (row bytes, d * 4, K * 4 for the
//     norms or an address not a multiple of 16: odd d, d = 17 at 4-bit,
//     unaligned views) take the plain-load path of the same kernel: the
//     same persistent walk and sums, the query staged by the block, the row
//     read with 4-byte __ldg.
// A row whose cur is -1 (the fused beam's converged queries) reads nothing
// and its K outputs are +inf, in every path below.
// K4 returns dots (its caller applies the metric). K2 is the same kernel
// with an epilogue: a bytes code row whose candidate segments are db = d
// (8-bit) or ceil(d / 2) (4-bit) bytes with db % 4 == 0 is a word row of wp
// = db / 4 words a candidate (8-bit: 4 dims a word, little-endian; 4-bit: 8
// nibbles, even dim low), so the kernel writes nbr_sq - 2 * dot (L2) or
// -dot (IP) from the same sums: bit for bit the first port's K2, whose
// 4-byte path summed in this order. K2 rows with db % 4 != 0 (d = 101) or a
// table not 4-byte aligned keep the first port's packed_dist_kernel (one
// block a row, one warp a candidate, byte loads), unchanged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "vec_dist.cuh"

namespace hnsw {
namespace {

constexpr int kThreads = 256;

// K2 for rows the word engine cannot read (db % 4 != 0, or a table that is
// not 4-byte aligned): out[q, c] = nbr_sq[r, c] - 2 sum_j qs[q, j] u_j (L2)
// or -sum_j qs u (IP) where r = cur[q] and u is candidate c's code segment
// in packed row r: bytes [c * db, (c + 1) * db) with db = d (8-bit) or
// ceil(d / 2) (4-bit: even dim in the low nibble, odd dim in the high
// nibble). Block b = (query b / t, expansion b % t) reads row cur[b] and
// writes out row b (t = expanded nodes per query).
template <int kBits, bool kIP>
__global__ void __launch_bounds__(kThreads)
packed_dist_kernel(const uint8_t* __restrict__ codes, int64_t n_rows,
                   int64_t row_w, const float* __restrict__ nbr_sq, int k,
                   int d, const int32_t* __restrict__ cur, int t,
                   const float* __restrict__ qs, float* __restrict__ out) {
  extern __shared__ float q_s[];  // [d] for 8-bit, [2 * db] for 4-bit
  const int db = kBits == 8 ? d : (d + 1) / 2;
  const int dq = kBits == 8 ? d : 2 * db;
  const int64_t b = blockIdx.x;
  const int64_t qi = b / t;
  const int32_t node = cur[b];  // read while the query is staged
  for (int j = threadIdx.x; j < dq; j += blockDim.x)
    q_s[j] = j < d ? qs[qi * d + j] : 0.f;  // odd d, 4-bit: the pad dim is 0
  __syncthreads();
  if (node < 0) {  // block-uniform: no row to read
    for (int c = threadIdx.x; c < k; c += blockDim.x) out[b * k + c] = INFINITY;
    return;
  }
  const int64_t row = clamp_row(node, n_rows);
  const uint8_t* r = codes + row * row_w;
  const float* sq_row = nbr_sq + row * static_cast<int64_t>(k);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  for (int c = warp; c < k; c += n_warps) {
    const uint8_t* seg = r + static_cast<int64_t>(c) * db;
    float dot = 0.f;
    for (int j = lane; j < db; j += kWarp) {
      const uint32_t u = seg[j];
      if (kBits == 8)
        dot += q_s[j] * static_cast<float>(u);
      else
        dot += q_s[2 * j] * static_cast<float>(u & 0xfu) +
               q_s[2 * j + 1] * static_cast<float>(u >> 4);
    }
    dot = warp_sum(dot);
    if (lane == 0) out[b * k + c] = kIP ? -dot : sq_row[c] - 2.f * dot;
  }
}

template <int kBits, bool kIP>
void launch_packed(const uint8_t* codes, int64_t n_rows, int64_t row_w,
                   const float* nbr_sq, int k, int d, const int32_t* cur,
                   int q, int t, const float* qs, float* out, cudaStream_t s) {
  const int db = kBits == 8 ? d : (d + 1) / 2;
  const int dq = kBits == 8 ? d : 2 * db;
  const size_t smem = static_cast<size_t>(dq) * sizeof(float);
  const unsigned grid = static_cast<unsigned>(q) * static_cast<unsigned>(t);
  packed_dist_kernel<kBits, kIP><<<grid, kThreads, smem, s>>>(codes, n_rows, row_w, nbr_sq, k, d, cur, t, qs, out);
}

// What words_dist_kernel writes from a candidate's dot: the dot itself (K4),
// nbr_sq - 2 * dot (K2, L2) or -dot (K2, IP).
enum Epilogue { kEpiDots, kEpiL2, kEpiIP };

template <int kEpi>
__device__ __forceinline__ float epilogue(float dot, const float* sq_row, int c) {
  if constexpr (kEpi == kEpiL2) return sq_row[c] - 2.f * dot;
  if constexpr (kEpi == kEpiIP) return -dot;
  return dot;
}

// How a warp's lanes split a word row's candidates, fixed for a launch:
// lpc lanes per candidate (the least power of two >= nw, the words that
// carry values, at most 32), cpw = 32 / lpc candidates side by side; lane
// sl of candidate group sub. Warp w owns candidates c = w * cpw + sub, then
// + step = n_warps * cpw, ...
struct WordLanes {
  int nw, lpc, cpw, sub, sl, step;
  __device__ WordLanes(int nw_, int n_warps, int lane) : nw(nw_), lpc(1) {
    while (lpc < nw && lpc < kWarp) lpc <<= 1;
    cpw = kWarp / lpc;
    sub = lane / lpc;
    sl = lane % lpc;
    step = n_warps * cpw;
  }
};

// out_row[c] for the kM candidates c = c0 + u * step + sub from each lane's
// partial sums dot[u], along the xor tree o = lpc / 2, ..., 1 (the first
// port's order, bit for bit; reduce_scatter where lpc >= kM), through the
// epilogue (sq_row: the row's K norms, read for kEpiL2 only).
template <int kM, int kEpi>
__device__ __forceinline__ void store_dots(float (&dot)[kM], const WordLanes& L, int c0, int k,
                                           const float* sq_row, float* __restrict__ out_row) {
  if (L.lpc >= kM) {
    const float s = reduce_scatter<kM>(dot, L.sl, L.lpc);
    const int span = L.lpc / kM;  // lanes that end with the same candidate
    const int c = c0 + ((L.sl / span) % kM) * L.step + L.sub;
    if (L.sl % span == 0 && c < k) out_row[c] = epilogue<kEpi>(s, sq_row, c);
  } else {
    for (int o = L.lpc / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < kM; ++u) dot[u] += __shfl_xor_sync(kFull, dot[u], o);
    }
#pragma unroll
    for (int u = 0; u < kM; ++u) {
      const int c = c0 + u * L.step + L.sub;
      if (L.sl == 0 && c < k) out_row[c] = epilogue<kEpi>(dot[u], sq_row, c);
    }
  }
}

// The dots of kM candidates c = c0 + u * step + sub (u < kM) of word row
// r, stored by store_dots. qv: this lane's query values when nw <= lpc
// (a lane then owns at most word sl of a candidate; the kM words load
// without a branch, and a lane past nw or a candidate past k sums
// 0 * 0 = +0, or is never stored); else the lane walks words sl, sl + lpc,
// ... with the query in q_s.
template <int kBits, bool kGlobal, int kM, int kEpi>
__device__ __forceinline__ void dots_chunk(const uint32_t* r, const float* q_s,
                                           const float (&qv)[32 / kBits], int k, int wp,
                                           const WordLanes& L, int c0, const float* sq_row,
                                           float* __restrict__ out_row) {
  constexpr int kVpw = 32 / kBits;
  float dot[kM];
  if (L.nw <= L.lpc) {
    const bool live = L.sl < L.nw;
    uint32_t w[kM];
#pragma unroll
    for (int u = 0; u < kM; ++u) {
      const int c = c0 + u * L.step + L.sub;
      const uint32_t* p = r + static_cast<int64_t>(c) * wp + L.sl;
      w[u] = 0u;
      if (live && c < k) w[u] = kGlobal ? __ldg(p) : *p;
    }
#pragma unroll
    for (int u = 0; u < kM; ++u) {
      dot[u] = 0.f;
#pragma unroll
      for (int j = 0; j < kVpw; ++j) dot[u] += qv[j] * code_value<kBits>(w[u], j);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kM; ++u) {
      const int c = c0 + u * L.step + L.sub;
      dot[u] = 0.f;
      if (c >= k) continue;
      const uint32_t* seg = r + static_cast<int64_t>(c) * wp;
      for (int i = L.sl; i < L.nw; i += L.lpc) {
        const uint32_t w = kGlobal ? __ldg(seg + i) : seg[i];
        const float* qq = q_s + kVpw * i;
#pragma unroll
        for (int j = 0; j < kVpw; ++j) dot[u] += qq[j] * code_value<kBits>(w, j);
      }
    }
  }
  store_dots<kM, kEpi>(dot, L, c0, k, sq_row, out_row);
}

// Dots of one word row against the query in q_s (zero past d) for the
// candidates this warp owns, through the epilogue. dot[c] = sum_j q_s[j] *
// u_j, u = candidate c's values: value j sits at bits [kBits * (j % vpw),
// +kBits) of word c * wp + j / vpw (vpw = 32 / kBits values per word).
// kGlobal: r is in device memory (read with __ldg), else in shared memory.
//
// Order of summation (the first port's, bit for bit): lane sl sums its
// words sl, sl + lpc, ... value by value, then store_dots adds the lanes up
// along the xor tree. A warp takes its candidates 8 at a time (the main
// path: 8 warps x 8 = K = 64), or 4, 2, 1 where fewer are left, so no
// chunk sums padding.
template <int kBits, bool kGlobal, int kEpi>
__device__ __forceinline__ void word_row_dots(const uint32_t* r, const float* q_s, int k, int wp,
                                              const WordLanes& L, int warp, const float* sq_row,
                                              float* __restrict__ out_row) {
  constexpr int kVpw = 32 / kBits;
  float qv[kVpw];
#pragma unroll
  for (int j = 0; j < kVpw; j += 4) {  // query rows are 16-byte aligned
    const float4 v = L.nw <= L.lpc && L.sl < L.nw
                         ? *reinterpret_cast<const float4*>(q_s + kVpw * L.sl + j)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    qv[j] = v.x; qv[j + 1] = v.y; qv[j + 2] = v.z; qv[j + 3] = v.w;
  }
  for (int c0 = warp * L.cpw; c0 < k;) {  // warp-uniform
    const int left = (k - c0 + L.step - 1) / L.step;  // chunks of candidates left
    if (left >= 8) {
      dots_chunk<kBits, kGlobal, 8, kEpi>(r, q_s, qv, k, wp, L, c0, sq_row, out_row);
      c0 += 8 * L.step;
    } else if (left >= 4) {
      dots_chunk<kBits, kGlobal, 4, kEpi>(r, q_s, qv, k, wp, L, c0, sq_row, out_row);
      c0 += 4 * L.step;
    } else if (left >= 2) {
      dots_chunk<kBits, kGlobal, 2, kEpi>(r, q_s, qv, k, wp, L, c0, sq_row, out_row);
      c0 += 2 * L.step;
    } else {
      dots_chunk<kBits, kGlobal, 1, kEpi>(r, q_s, qv, k, wp, L, c0, sq_row, out_row);
      c0 += L.step;
    }
  }
}

constexpr int kWordsConsumerWarps = kThreads / kWarp;

// out[b, c] = the epilogue of the dots of word row cur[b] against query b /
// t, for every row b < nb = Q * T, walked persistently. kBulk: a producer
// warp (the last one) feeds a RowRing of n_stages stages of stage_bytes
// (the row's row_w * 4 bytes, the query at q_off and, for kEpiL2, the row's k
// norms at n_off); else every warp sums and the block stages the query
// itself (q_s = the start of shared memory) and the norms are read from
// nbr_sq.
template <int kBits, bool kBulk, int kEpi>
__global__ void __launch_bounds__(kThreads + kWarp)
words_dist_kernel(const int32_t* __restrict__ words, int64_t n_rows,
                  int64_t row_w, int k, int wp, int d,
                  const int32_t* __restrict__ cur, int t, int64_t nb,
                  const float* __restrict__ qs, const float* __restrict__ nbr_sq,
                  float* __restrict__ out, int n_stages, int stage_bytes, int q_off,
                  int n_off) {
  constexpr int kVpw = 32 / kBits;
  extern __shared__ __align__(128) char smem_raw[];
  const int nw = (d + kVpw - 1) / kVpw;  // words that carry values
  const int nq = nw * kVpw;              // query values staged, zero past d
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if constexpr (kBulk) {
    const RowRing ring(smem_raw, n_stages, stage_bytes);
    if (threadIdx.x == 0) ring.init(kWordsConsumerWarps);
    for (int s = 0; s < n_stages; ++s) {
      float* q_s = reinterpret_cast<float*>(ring.stages + s * stage_bytes + q_off);
      for (int j = d + threadIdx.x; j < nq; j += blockDim.x) q_s[j] = 0.f;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    RowRing::Pos pos;
    if (warp == kWordsConsumerWarps) {  // producer
      const uint32_t row_bytes = static_cast<uint32_t>(row_w * 4);
      const uint32_t q_bytes = static_cast<uint32_t>(d * 4);
      const uint32_t n_bytes = kEpi == kEpiL2 ? static_cast<uint32_t>(k * 4) : 0u;
      const int64_t stride = gridDim.x;
      for (int64_t base = blockIdx.x; base < nb; base += kWarp * stride) {
        // lane j looks up row base + j * stride: 32 rows' ids at once
        const int64_t mine = base + lane * stride;
        const int32_t node = mine < nb ? cur[mine] : -1;
        const int64_t row = clamp_row(node, n_rows);
        const int64_t qrow = mine < nb ? mine / t : 0;
        const unsigned skip = __ballot_sync(kFull, node < 0);
        for (int j = 0; j < kWarp && base + j * stride < nb; ++j) {  // warp-uniform
          if (skip >> j & 1u) continue;  // the consumers skip it too
          const int64_t rj = __shfl_sync(kFull, row, j);
          const int64_t qj = __shfl_sync(kFull, qrow, j);
          if (lane == 0) {
            char* st = ring.acquire(pos, row_bytes + q_bytes + n_bytes);
            ring.copy(pos, st, words + rj * row_w, row_bytes);
            ring.copy(pos, st + q_off, qs + qj * d, q_bytes);
            if (kEpi == kEpiL2) ring.copy(pos, st + n_off, nbr_sq + rj * k, n_bytes);
          }
          pos.next(n_stages);
        }
      }
      return;
    }
    const WordLanes lanes(nw, kWordsConsumerWarps, lane);
    for (int64_t b = blockIdx.x; b < nb; b += gridDim.x) {
      if (cur[b] < 0) {  // block-uniform: no stage was filled for it
        for (int c = threadIdx.x; c < k; c += kThreads) out[b * k + c] = INFINITY;
        continue;
      }
      const char* st = ring.wait(pos);
      word_row_dots<kBits, false, kEpi>(reinterpret_cast<const uint32_t*>(st),
                                        reinterpret_cast<const float*>(st + q_off), k, wp, lanes,
                                        warp, reinterpret_cast<const float*>(st + n_off),
                                        out + b * k);
      __syncwarp();
      if (lane == 0) ring.release(pos);
      pos.next(n_stages);
    }
  } else {
    float* q_s = reinterpret_cast<float*>(smem_raw);
    const int n_warps = blockDim.x / kWarp;
    const WordLanes lanes(nw, n_warps, lane);
    for (int64_t b = blockIdx.x; b < nb; b += gridDim.x) {
      const int64_t qi = b / t;
      const int32_t node = cur[b];  // read while the query is staged
      for (int j = threadIdx.x; j < nq; j += blockDim.x) q_s[j] = j < d ? qs[qi * d + j] : 0.f;
      __syncthreads();
      if (node < 0) {  // block-uniform: no row to read
        for (int c = threadIdx.x; c < k; c += blockDim.x) out[b * k + c] = INFINITY;
      } else {
        const int64_t row = clamp_row(node, n_rows);
        const float* sq_row = kEpi == kEpiL2 ? nbr_sq + row * k : nullptr;
        word_row_dots<kBits, true, kEpi>(reinterpret_cast<const uint32_t*>(words) + row * row_w,
                                         q_s, k, wp, lanes, warp, sq_row, out + b * k);
      }
      __syncthreads();
    }
  }
}

// The persistent grid of one kernel at one shared-memory size: SMs x the
// blocks that fit on one. The search launches the same shape every hop, so
// each host thread keeps the last answer per kernel instead of querying
// the device attributes and occupancy every launch.
template <typename Kernel>
int64_t persistent_blocks(Kernel kern, int threads, size_t smem) {
  struct Last { const void* kern = nullptr; int dev = -1; size_t smem = 0; int64_t blocks = 0; };
  static thread_local Last last;
  int dev = 0;
  cudaGetDevice(&dev);
  const void* fn = reinterpret_cast<const void*>(kern);
  if (fn != last.kern || dev != last.dev || smem != last.smem) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    last = {fn, dev, smem, int64_t(sms) * std::max(per_sm, 1)};
  }
  return last.blocks;
}

// nbr_sq: float32 [n_rows, k], read for kEpiL2 only.
template <int kBits, int kEpi>
int launch_words(const int32_t* w, int64_t n_rows, int64_t row_w, int k, int wp, int d,
                 const int32_t* r, int64_t nb, int t, const float* qf, const float* nbr_sq,
                 float* o, cudaStream_t s) {
  constexpr int kVpw = 32 / kBits;
  const int nq = (d + kVpw - 1) / kVpw * kVpw;
  const int row_bytes = static_cast<int>(row_w * 4);
  const int q_off = row_bytes;
  const int n_off = q_off + (nq * 4 + 15) / 16 * 16;
  const int stage_bytes = n_off + (kEpi == kEpiL2 ? k * 4 : 0);
  // two stages a block: with ~4 blocks an SM that keeps ~70 KB of rows in
  // flight at d = 128 8-bit; 3 and 4 stages measured no faster on the H100
  constexpr int kStages = 2;
  const size_t smem_bulk = RowRing::smem_bytes(kStages, stage_bytes);
  constexpr size_t kSmemOptIn = 227 * 1024;  // a Hopper block's shared memory, opted in
  const bool norms_ok =
      kEpi != kEpiL2 || (k % 4 == 0 && reinterpret_cast<uintptr_t>(nbr_sq) % 16 == 0);
  const bool bulk = smem_bulk <= kSmemOptIn && row_w % 4 == 0 && d % 4 == 0 && norms_ok &&
                    (reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(qf)) % 16 == 0;
  if (bulk) {
    auto kern = words_dist_kernel<kBits, true, kEpi>;
    if (smem_bulk > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem_bulk));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const auto grid = static_cast<unsigned>(
        std::min(nb, persistent_blocks(kern, kThreads + kWarp, smem_bulk)));
    kern<<<grid, kThreads + kWarp, smem_bulk, s>>>(w, n_rows, row_w, k, wp, d, r, t, nb, qf, nbr_sq,
                                                   o, kStages, stage_bytes, q_off, n_off);
  } else {
    const size_t smem = static_cast<size_t>(nq) * sizeof(float);
    auto kern = words_dist_kernel<kBits, false, kEpi>;
    const auto grid = static_cast<unsigned>(std::min(nb, persistent_blocks(kern, kThreads, smem)));
    kern<<<grid, kThreads, smem, s>>>(w, n_rows, row_w, k, wp, d, r, t, nb, qf, nbr_sq, o, 0, 0, 0,
                                      0);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3 on rows of dtype 0 = float32, 1 = bfloat16 or 2 = uint8.
int launch_vec_dtype(const void* table, int dtype, int64_t n_rows, int d, const int32_t* ids,
                     const int32_t* cur, int q, int k, const void* qs, const void* offset,
                     const void* scale, int ip, void* out, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(qs);
  auto off = static_cast<const float*>(offset);
  auto sc = static_cast<const float*>(scale);
  auto o = static_cast<float*>(out);
  switch (dtype) {
    case 0: launch_vec<float>(table, n_rows, d, ids, cur, q, k, qf, off, sc, ip, o, s); break;
    case 1: launch_vec<__nv_bfloat16>(table, n_rows, d, ids, cur, q, k, qf, off, sc, ip, o, s); break;
    case 2: launch_vec<uint8_t>(table, n_rows, d, ids, cur, q, k, qf, off, sc, ip, o, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hnsw

// dtype: 0 = float32, 1 = bfloat16, 2 = uint8. offset/scale: NULL, or the
// per-dim dequant affine (float32 [d]). ip: 0 = L2 surrogate, 1 = -dot.
extern "C" int hnsw_vec_dist(const void* table, int dtype, int64_t n_rows,
                             int d, const void* ids, int q, int k,
                             const void* qs, const void* offset,
                             const void* scale, int ip, void* out,
                             void* stream) {
  using namespace hnsw;
  if (q <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  return launch_vec_dtype(table, dtype, n_rows, d, static_cast<const int32_t*>(ids), nullptr, q,
                          k, qs, offset, scale, ip, out, stream);
}

// K3 by node (the fused beam's hop): the candidates of query q are the k
// ids of adjacency row nbrs[cur[q]] (int32 [n_nodes, k]; -1 = none); a
// query whose cur is -1 and a candidate whose id is -1 get +inf and read
// no row. The other arguments as hnsw_vec_dist's.
extern "C" int hnsw_vec_dist_cur(const void* table, int dtype, int64_t n_rows,
                                 int d, const void* nbrs, const void* cur,
                                 int q, int k, const void* qs,
                                 const void* offset, const void* scale,
                                 int ip, void* out, void* stream) {
  using namespace hnsw;
  if (q <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  return launch_vec_dtype(table, dtype, n_rows, d, static_cast<const int32_t*>(nbrs),
                          static_cast<const int32_t*>(cur), q, k, qs, offset, scale, ip, out,
                          stream);
}

// bits: 8 or 4. cur: int32 [q, t] packed-row ids. ip: 0 = L2 surrogate,
// 1 = -dot. out: float32 [q, t * k]. Code rows whose segments are a whole
// number of 4-byte words (db % 4 == 0, the table 4-byte aligned) go to the
// word engine with wp = db / 4; the others to packed_dist_kernel.
extern "C" int hnsw_packed_dist(const void* codes, int64_t n_rows,
                                int64_t row_w, const void* nbr_sq, int k,
                                int d, int bits, const void* cur, int q,
                                int t, const void* qs, int ip, void* out,
                                void* stream) {
  using namespace hnsw;
  if (q <= 0 || k <= 0 || t <= 0) return static_cast<int>(cudaGetLastError());
  if (bits != 8 && bits != 4) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const uint8_t*>(codes);
  auto sq = static_cast<const float*>(nbr_sq);
  auto r = static_cast<const int32_t*>(cur);
  auto qf = static_cast<const float*>(qs);
  auto o = static_cast<float*>(out);
  const int db = bits == 8 ? d : (d + 1) / 2;
  if (db % 4 == 0 && row_w % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 4 == 0) {
    auto w = reinterpret_cast<const int32_t*>(c);
    const int64_t nb = static_cast<int64_t>(q) * t;
    const int64_t ww = row_w / 4;
    if (bits == 8)
      return ip ? launch_words<8, kEpiIP>(w, n_rows, ww, k, db / 4, d, r, nb, t, qf, sq, o, s)
                : launch_words<8, kEpiL2>(w, n_rows, ww, k, db / 4, d, r, nb, t, qf, sq, o, s);
    return ip ? launch_words<4, kEpiIP>(w, n_rows, ww, k, db / 4, d, r, nb, t, qf, sq, o, s)
              : launch_words<4, kEpiL2>(w, n_rows, ww, k, db / 4, d, r, nb, t, qf, sq, o, s);
  }
  if (bits == 8) {
    if (ip) launch_packed<8, true>(c, n_rows, row_w, sq, k, d, r, q, t, qf, o, s);
    else launch_packed<8, false>(c, n_rows, row_w, sq, k, d, r, q, t, qf, o, s);
  } else {
    if (ip) launch_packed<4, true>(c, n_rows, row_w, sq, k, d, r, q, t, qf, o, s);
    else launch_packed<4, false>(c, n_rows, row_w, sq, k, d, r, q, t, qf, o, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// words: int32 [n_rows, row_w], row_w = k * wp. bits: 8 or 4. cur: int32
// [q, t] word-row ids. out: float32 [q, t * k] dots.
extern "C" int hnsw_words_dist(const void* words, int64_t n_rows,
                               int64_t row_w, int k, int wp, int d, int bits,
                               const void* cur, int q, int t, const void* qs,
                               void* out, void* stream) {
  using namespace hnsw;
  if (q <= 0 || k <= 0 || t <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const int32_t*>(words);
  auto r = static_cast<const int32_t*>(cur);
  auto qf = static_cast<const float*>(qs);
  auto o = static_cast<float*>(out);
  const int64_t nb = static_cast<int64_t>(q) * t;
  if (bits == 8)
    return launch_words<8, kEpiDots>(w, n_rows, row_w, k, wp, d, r, nb, t, qf, nullptr, o, s);
  if (bits == 4)
    return launch_words<4, kEpiDots>(w, n_rows, row_w, k, wp, d, r, nb, t, qf, nullptr, o, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
