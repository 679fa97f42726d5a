// Routing and rerank distances for Hopper (sm_90a): K3, K2 and K4 of the
// port.
//
// Replaces the TPU kernels of hnsw_tpu/ops/dist_kernel.py:
//   * gathered_vec_dist (_vec_dist_kernel; pallas_call at :308) ->
//     vec_dist_kernel below;
//   * packed_row_dist (_packed_dist_kernel; pallas_call at :129) ->
//     packed_dist_kernel below;
//   * packed_row_dist_words (_words_dist_kernel; pallas_call at :227) ->
//     words_dist_kernel below.
//
// What bounds them on the H100: bytes of scattered rows. Each query reads K
// rows from random places in a table of up to several GB (K3: K vector rows
// of d * itemsize bytes; K2: one packed code row of K * d * bits/8 bytes
// plus K norms). At 2 FLOP per byte or less the arithmetic is nothing beside
// the reads, and each row is a separate burst of 128 to 8192 bytes.
//
// What the design does about it:
//   * the row gather happens inside the kernel, from ids, so the [Q, K, d]
//     intermediate that the TPU path builds in XLA is never written;
//   * one block per query holds that query's vector (and the dequant affine)
//     in shared memory; one warp per candidate row reads the row with
//     consecutive lanes on consecutive addresses and sums with shuffles, so
//     every row is read once, coalesced, and the sums stay in registers;
//   * K2 reads 4 bytes per lane when the code segments are 4-byte aligned
//     (8-bit d = 128: one 128-byte transaction per candidate);
//   * every row offset is int64: row * row_w crosses 2^31 at node 262,144
//     for 8 KB packed rows (the reference's round-2 corruption bug).
// Any d and any K: there is no shape padding.
//
// K4 (words_dist_kernel). The TPU kernel lane-split each int32 word row to
// [rows, 128], multiplied each byte plane against G-tiled query planes and
// summed each candidate's wp lanes with a 0/1 selector matmul on the MXU;
// it needed m0 % (128 / wp) == 0. On Hopper none of that is needed. What
// bounds it is the same as K2: one scattered code row per (query,
// expansion), 8 KB at d = 128 8-bit, read once. The design:
//   * one block per (query, expansion); the block reads word row cur[b]
//     itself (int64 offsets) and the query row b / t into shared memory,
//     zero past d, so dims >= d never meet a query value and the query row
//     is not repeated for n_expand > 1;
//   * lanes per candidate = the least power of two >= the words that carry
//     values (ceil(d * bits / 32), at most 32): one candidate per warp at
//     d = 128 8-bit (one 128-byte read), two at 4-bit; the pad words of a
//     segment are never read;
//   * each lane pulls the 32/bits bytes or nibbles out of its word with
//     shifts and masks in registers and sums; the candidate's lanes reduce
//     with shuffles. It returns dots only: the caller applies the metric.
// Any m0 and any d with word_width(d, bits) words per segment.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace hnsw {
namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }

// out[q, c] = sum_j v_j^2 - 2 sum_j qs[q, j] v_j   (L2 surrogate)
//           = -sum_j qs[q, j] v_j                   (IP)
// with v = table[ids[q, c]] (dequantized as offset + scale * u when asked).
template <typename T, bool kDequant, bool kIP>
__global__ void __launch_bounds__(kThreads)
vec_dist_kernel(const T* __restrict__ table, int64_t n_rows, int d,
                const int32_t* __restrict__ ids, int k,
                const float* __restrict__ qs, const float* __restrict__ offset,
                const float* __restrict__ scale, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* q_s = smem;           // [d]
  float* off_s = smem + d;     // [d] when kDequant
  float* sc_s = smem + 2 * d;  // [d] when kDequant
  const int64_t qi = blockIdx.x;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    q_s[j] = qs[qi * d + j];
    if (kDequant) {
      off_s[j] = offset[j];
      sc_s[j] = scale[j];
    }
  }
  __syncthreads();
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  for (int c = warp; c < k; c += n_warps) {
    const int64_t row = clamp_row(ids[qi * k + c], n_rows);
    const T* v = table + row * static_cast<int64_t>(d);
    float dot = 0.f, sq = 0.f;
    for (int j = lane; j < d; j += kWarp) {
      float x = to_f32(v[j]);
      if (kDequant) x = off_s[j] + sc_s[j] * x;
      dot += q_s[j] * x;
      if (!kIP) sq += x * x;
    }
    dot = warp_sum(dot);
    if (!kIP) sq = warp_sum(sq);
    if (lane == 0) out[qi * k + c] = kIP ? -dot : sq - 2.f * dot;
  }
}

template <typename T>
void launch_vec(const void* table, int64_t n_rows, int d, const int32_t* ids,
                int q, int k, const float* qs, const float* offset,
                const float* scale, bool ip, float* out, cudaStream_t s) {
  const T* t = static_cast<const T*>(table);
  const size_t smem = (offset ? 3 : 1) * static_cast<size_t>(d) * sizeof(float);
  if (offset) {
    if (ip)
      vec_dist_kernel<T, true, true><<<q, kThreads, smem, s>>>(t, n_rows, d, ids, k, qs, offset, scale, out);
    else
      vec_dist_kernel<T, true, false><<<q, kThreads, smem, s>>>(t, n_rows, d, ids, k, qs, offset, scale, out);
  } else {
    if (ip)
      vec_dist_kernel<T, false, true><<<q, kThreads, smem, s>>>(t, n_rows, d, ids, k, qs, offset, scale, out);
    else
      vec_dist_kernel<T, false, false><<<q, kThreads, smem, s>>>(t, n_rows, d, ids, k, qs, offset, scale, out);
  }
}

// out[q, c] = nbr_sq[r, c] - 2 sum_j qs[q, j] u_j   (L2)  or  -sum_j qs u (IP)
// where r = cur[q] and u is candidate c's code segment in packed row r:
// bytes [c * db, (c + 1) * db) with db = d (8-bit) or ceil(d / 2) (4-bit:
// even dim in the low nibble, odd dim in the high nibble).
// Block b = (query b / t, expansion b % t) reads row cur[b] and writes out
// row b (t = expanded nodes per query).
template <int kBits, bool kIP, bool kVec>
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
  for (int j = threadIdx.x; j < dq; j += blockDim.x)
    q_s[j] = j < d ? qs[qi * d + j] : 0.f;  // odd d, 4-bit: the pad dim is 0
  __syncthreads();
  const int64_t row = clamp_row(cur[b], n_rows);
  const uint8_t* r = codes + row * row_w;
  const float* sq_row = nbr_sq + row * static_cast<int64_t>(k);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  for (int c = warp; c < k; c += n_warps) {
    const uint8_t* seg = r + static_cast<int64_t>(c) * db;
    float dot = 0.f;
    if (kVec) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(seg);
      for (int i = lane; i < db / 4; i += kWarp) {
        const uint32_t u = __ldg(w + i);
        if (kBits == 8) {
          const float* qq = q_s + 4 * i;
#pragma unroll
          for (int v = 0; v < 4; ++v) dot += qq[v] * static_cast<float>((u >> (8 * v)) & 0xffu);
        } else {
          const float* qq = q_s + 8 * i;
#pragma unroll
          for (int v = 0; v < 8; ++v) dot += qq[v] * static_cast<float>((u >> (4 * v)) & 0xfu);
        }
      }
    } else {
      for (int j = lane; j < db; j += kWarp) {
        const uint32_t u = seg[j];
        if (kBits == 8)
          dot += q_s[j] * static_cast<float>(u);
        else
          dot += q_s[2 * j] * static_cast<float>(u & 0xfu) +
                 q_s[2 * j + 1] * static_cast<float>(u >> 4);
      }
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
  const bool vec = db % 4 == 0 && row_w % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  const unsigned grid = static_cast<unsigned>(q) * static_cast<unsigned>(t);
  if (vec)
    packed_dist_kernel<kBits, kIP, true><<<grid, kThreads, smem, s>>>(codes, n_rows, row_w, nbr_sq, k, d, cur, t, qs, out);
  else
    packed_dist_kernel<kBits, kIP, false><<<grid, kThreads, smem, s>>>(codes, n_rows, row_w, nbr_sq, k, d, cur, t, qs, out);
}

// out[b, c] = sum_j qs[b / t, j] * u_j, u = candidate c's values in word row
// r = cur[b]: value j sits at bits [kBits * (j % vpw), +kBits) of word
// c * wp + j / vpw (vpw = 32 / kBits values per word).
template <int kBits>
__global__ void __launch_bounds__(kThreads)
words_dist_kernel(const int32_t* __restrict__ words, int64_t n_rows,
                  int64_t row_w, int k, int wp, int d,
                  const int32_t* __restrict__ cur, int t,
                  const float* __restrict__ qs, float* __restrict__ out) {
  constexpr int kVpw = 32 / kBits;
  constexpr uint32_t kMask = (1u << kBits) - 1u;
  extern __shared__ float q_s[];  // [nw * kVpw], zero past d
  const int nw = (d + kVpw - 1) / kVpw;  // words that carry values
  const int64_t b = blockIdx.x;
  const int64_t qi = b / t;
  for (int j = threadIdx.x; j < nw * kVpw; j += blockDim.x)
    q_s[j] = j < d ? qs[qi * d + j] : 0.f;
  __syncthreads();
  const int64_t row = clamp_row(cur[b], n_rows);
  const uint32_t* r = reinterpret_cast<const uint32_t*>(words) + row * row_w;
  int lpc = 1;  // lanes per candidate: a power of two, so groups tile a warp
  while (lpc < nw && lpc < kWarp) lpc <<= 1;
  const int cpw = kWarp / lpc;  // candidates per warp
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int sub = lane / lpc, sl = lane % lpc;
  // c0 is the same for the whole warp, so every lane reaches the shuffles
  for (int c0 = warp * cpw; c0 < k; c0 += n_warps * cpw) {
    const int c = c0 + sub;
    float dot = 0.f;
    if (c < k) {
      const uint32_t* seg = r + static_cast<int64_t>(c) * wp;
      for (int i = sl; i < nw; i += lpc) {
        const uint32_t w = __ldg(seg + i);
        const float* qq = q_s + kVpw * i;
#pragma unroll
        for (int j = 0; j < kVpw; ++j) dot += qq[j] * static_cast<float>((w >> (kBits * j)) & kMask);
      }
    }
    for (int o = lpc / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (sl == 0 && c < k) out[b * k + c] = dot;
  }
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
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int32_t*>(ids);
  auto qf = static_cast<const float*>(qs);
  auto off = static_cast<const float*>(offset);
  auto sc = static_cast<const float*>(scale);
  auto o = static_cast<float*>(out);
  switch (dtype) {
    case 0: launch_vec<float>(table, n_rows, d, i, q, k, qf, off, sc, ip, o, s); break;
    case 1: launch_vec<__nv_bfloat16>(table, n_rows, d, i, q, k, qf, off, sc, ip, o, s); break;
    case 2: launch_vec<uint8_t>(table, n_rows, d, i, q, k, qf, off, sc, ip, o, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// bits: 8 or 4. cur: int32 [q, t] packed-row ids. ip: 0 = L2 surrogate,
// 1 = -dot. out: float32 [q, t * k].
extern "C" int hnsw_packed_dist(const void* codes, int64_t n_rows,
                                int64_t row_w, const void* nbr_sq, int k,
                                int d, int bits, const void* cur, int q,
                                int t, const void* qs, int ip, void* out,
                                void* stream) {
  using namespace hnsw;
  if (q <= 0 || k <= 0 || t <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const uint8_t*>(codes);
  auto sq = static_cast<const float*>(nbr_sq);
  auto r = static_cast<const int32_t*>(cur);
  auto qf = static_cast<const float*>(qs);
  auto o = static_cast<float*>(out);
  if (bits == 8) {
    if (ip) launch_packed<8, true>(c, n_rows, row_w, sq, k, d, r, q, t, qf, o, s);
    else launch_packed<8, false>(c, n_rows, row_w, sq, k, d, r, q, t, qf, o, s);
  } else if (bits == 4) {
    if (ip) launch_packed<4, true>(c, n_rows, row_w, sq, k, d, r, q, t, qf, o, s);
    else launch_packed<4, false>(c, n_rows, row_w, sq, k, d, r, q, t, qf, o, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
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
  const unsigned grid = static_cast<unsigned>(q) * static_cast<unsigned>(t);
  if (bits != 8 && bits != 4) return static_cast<int>(cudaErrorInvalidValue);
  const int vpw = 32 / bits;
  const size_t smem = static_cast<size_t>((d + vpw - 1) / vpw * vpw) * sizeof(float);
  if (bits == 8)
    words_dist_kernel<8><<<grid, kThreads, smem, s>>>(w, n_rows, row_w, k, wp, d, r, t, qf, o);
  else
    words_dist_kernel<4><<<grid, kThreads, smem, s>>>(w, n_rows, row_w, k, wp, d, r, t, qf, o);
  return static_cast<int>(cudaGetLastError());
}
