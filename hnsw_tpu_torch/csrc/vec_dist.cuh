// K3's row engines for Hopper (sm_90a): the distances of K rows gathered by
// id from a [n_rows, d] table (f32, bf16, or uint8 with an optional per-dim
// dequant affine) against one f32 query each, ids clamped to [0, n_rows -
// 1]. Two TPU kernels compute this function and both launch these engines:
//   * K3 gathered_vec_dist (hnsw_tpu/ops/dist_kernel.py, pallas_call at
//     :308) from dist_kernel.cu, hnsw_vec_dist (and hnsw_vec_dist_cur, its
//     ids by node), through launch_vec;
//   * K5 fused_gather_distances (hnsw_tpu/ops/hop_kernel.py, pallas_call at
//     :118; K3's function without the affine) from hop_kernel.cu,
//     hnsw_gather_dist, through launch_vec_src's ids form.
// Each .cu file is its own translation unit and compiles its own copy, so
// K3 and K5 run the same instructions and return the same bits.
// reduce_scatter and code_value are also K4's word engine's (dist_kernel.cu).
//
// K3 (vec_dist_kernel). The first port gave each query a block that staged
// the query in shared memory behind a barrier, then had each warp walk its
// candidates one at a time: load the id, then the row, then two shuffle
// trees. Each row cost two dependent round trips and a warp had about one
// row in flight, so a build launch of K = 256 ran 32 rows in series a warp
// and a launch of 86 queries filled 86 SMs. Now:
//   * one warp owns a chunk of up to 8 candidates of one query, and the flat
//     grid walks (query, chunk) pairs (Q * ceil(K / 8) warps; 4 a block, so
//     small launches still spread over the SMs; a persistent grid, with or
//     without the next chunk's ids fetched ahead, measured slower at every
//     main-path shape on the H100);
//   * the warp loads the chunk's 8 ids in one load, broadcasts them with
//     shuffles, and issues every row load of a 128-dim pass (8 rows x 4
//     loads a lane: 4 KB in flight a warp at f32) before the first FMA;
//     rows are read evict-first (__ldcs): a row is read once, and the
//     reused lines (the query, the ids, row 0 that masked ids read) stay
//     cached. That put the serving hop and the build's level-0 hop within a
//     few per cent of a gather with 16-byte loads and no arithmetic
//     (scripts/torch_kernel_ab.py);
//   * no shared memory and no barrier: lane j keeps the query values of dims
//     j, j + 32, j + 64, j + 96 of the pass (and the dequant affine) in
//     registers; a wider d walks in passes of 128 dims;
//   * order of summation: the first port's, kept on purpose (lane j sums
//     dims j, j + 32, ... in that order, then the xor tree 16, ..., 1), so
//     f32 results equal it bit for bit and the build's graph cannot drift.
//     That is why a lane loads 4 bytes, not 16: each warp load is one
//     coalesced 128-byte line. The 8 candidates' trees share their first
//     levels as a reduce-scatter (9 shuffles a tree set instead of 40).
// Rows are not bulk-copied: a K3 row is one 512-byte copy per candidate,
// which would make one producer thread the bottleneck.
//
// K3 on the storage codecs' rows. vec_dist_kernel reads one value a lane a
// load: 32 bytes a warp load on uint8 rows (sq8), 64 on bf16, where an f32
// warp load moves 128. On the H100 that ran uint8 + dequant rows at d = 96
// (96 bytes a row) at 0.18 ms a serving hop, twice f32's time at five times
// fewer bytes; measured (scripts/torch_k3_probe.py), the affine's two loads
// and FMA a dim cost the most (0.18 -> 0.096 ms without them), the
// sums next, and the int-to-float conversion nothing. So:
//   * uint8 rows of whole 4-byte words (vec_dist_bytes_kernel): one 4-byte
//     load a lane covers a row's 128-dim pass in one warp load (16 rows in
//     flight a warp where K >= 64), shuffles hand each lane its own dims,
//     and a byte permute and a subtract make them exact floats: 0.040 ms,
//     in the first port's order of summation, bit for bit;
//   * bf16 rows of whole 16-, 8- or 4-byte loads (vec_dist_bf16_kernel):
//     16-byte loads, a row over 4 to 32 lanes, 4 rows a lane, each lane
//     summing its own loads, then a short reduction: another order of
//     summation (held to the plain version within the tolerance), chosen
//     because the first port's order with shuffles measured 15% slower
//     (0.057 against 0.050 ms a serving hop);
//   * other sub-word rows (odd d, an unaligned table) keep vec_dist_kernel.
//
// Where a query's candidates come from: a row of ids [q, k], or, for the
// fused beam's hop (kByNode, cur given), the adjacency row of the node the
// query expands (ids is then the adjacency [n_nodes, k] and row cur[q]
// holds the query's ids). By node, a query whose cur is -1 and a candidate
// whose id is -1 read no row and get +inf; every other distance is the one
// the ids form gives the same id, bit for bit (each candidate's sums are
// its own). The by-node form is a template flag, so the ids form compiles
// to the same code as before it; the ids form keeps its clamp of any id to
// [0, n_rows - 1].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace hnsw {
namespace {

constexpr unsigned kFull = 0xffffffffu;

// Sums kM per-lane partial sums v[] each over the lpc lanes of a lane group
// (lpc >= kM, both powers of two) along the xor tree o = lpc / 2, ..., 1:
// the first port's order, bit for bit. The kM trees share their first
// log2(kM) levels as a reduce-scatter (at each level a lane keeps the half
// of the values on its side of the pair and sends the other half), so 8
// trees over 32 lanes take 4 + 2 + 1 + 2 shuffles instead of 40. Each pair
// still adds the same two partial sums, so every tree, and its result, is
// unchanged. Returns the lane's sum: that of value (sl / (lpc / kM)) % kM.
template <int kM>
__device__ __forceinline__ float reduce_scatter(float (&v)[kM], int sl, int lpc) {
  int o = lpc / 2;
#pragma unroll
  for (int m = kM; m > 1; m >>= 1, o >>= 1) {  // kM -> ... -> 1 values
    const bool up = (sl & o) != 0;
#pragma unroll
    for (int j = 0; j < m / 2; ++j) {
      const float send = up ? v[j] : v[j + m / 2];
      const float keep = up ? v[j + m / 2] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  for (; o > 0; o >>= 1) v[0] += __shfl_xor_sync(kFull, v[0], o);
  return v[0];
}

// Value j (< 32 / kBits) of word w as an exact float without an int-to-float
// conversion (16 a clock per SM on Hopper): 2^23 + v carries v in its low
// mantissa bits, so one byte permute (or shift and mask) and one subtract
// give float(v) bit for bit.
template <int kBits>
__device__ __forceinline__ float code_value(uint32_t w, int j) {
  constexpr uint32_t kTwo23 = 0x4B000000u;  // 8388608.0f
  const uint32_t bits = kBits == 8 ? __byte_perm(w, kTwo23, 0x7440 | j)
                                   : (((w >> (4 * j)) & 0xFu) | kTwo23);
  return __uint_as_float(bits) - 8388608.f;
}

// Lane l's id among the candidates c0 .. c0 + live - 1 of query qi (live <=
// 32): ids[qi, c0 + l], or by node ids[cur[qi], c0 + l]. By node, returns
// the bit mask of the candidates that read a row (none when cur[qi] is -1,
// else those whose id is not -1; their ids read as 0, never loaded); the
// ids form reads every live candidate and returns 0, unused.
template <bool kByNode>
__device__ __forceinline__ unsigned load_ids(const int32_t* __restrict__ ids,
                                             const int32_t* __restrict__ cur, int64_t qi, int k,
                                             int c0, int live, int lane, int32_t& id) {
  if constexpr (!kByNode) {
    id = lane < live ? __ldg(ids + qi * k + c0 + lane) : 0;
    return 0u;
  } else {
    const int32_t node = __ldg(cur + qi);
    id = lane < live && node >= 0 ? __ldg(ids + static_cast<int64_t>(node) * k + c0 + lane) : -1;
    const bool ok = id >= 0;
    if (!ok) id = 0;
    return __ballot_sync(kFull, ok);
  }
}

// candidate u (< live) of a chunk reads its row: always in the ids form, by
// node where its bit of vm is set
template <bool kByNode>
__device__ __forceinline__ bool reads(unsigned vm, int u, int live) {
  if constexpr (kByNode) return (vm >> u & 1u) != 0u;
  else return u < live;
}

// by node, +inf for the live candidates of a warp that reads no row (cur
// -1 or every id -1); returns whether it did
template <bool kByNode>
__device__ __forceinline__ bool store_none(unsigned vm, float* __restrict__ out, int64_t qi,
                                           int k, int c0, int live, int lane) {
  if constexpr (!kByNode) return false;
  else {
    if (vm != 0u) return false;
    if (lane < live) out[qi * k + c0 + lane] = INFINITY;
    return true;
  }
}

constexpr int kVecChunk = 8;  // candidates a warp owns
constexpr int kVecWarps = 4;  // warps a block
constexpr int kVecPass = 4;   // loads a lane per row and pass: 4 x 32 = 128 dims

// out[q, c] = sum_j v_j^2 - 2 sum_j qs[q, j] v_j   (L2 surrogate)
//           = -sum_j qs[q, j] v_j                   (IP)
// with v = table[ids[q, c]] (dequantized as offset + scale * u when asked).
// Warp w of the grid owns query w / chunks, candidates c0 = (w % chunks) *
// 8, ..., c0 + 7 (those < k).
template <typename T, bool kDequant, bool kIP, bool kByNode>
__global__ void __launch_bounds__(kVecWarps * kWarp)
vec_dist_kernel(const T* __restrict__ table, int64_t n_rows, int d,
                const int32_t* __restrict__ ids, const int32_t* __restrict__ cur, int k,
                int chunks, int64_t n_work, const float* __restrict__ qs,
                const float* __restrict__ offset, const float* __restrict__ scale,
                float* __restrict__ out) {
  const int lane = threadIdx.x % kWarp;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kVecWarps + threadIdx.x / kWarp;
  if (w >= n_work) return;  // warp-uniform
  const int64_t qi = w / chunks;
  const int c0 = static_cast<int>(w % chunks) * kVecChunk;
  const int live = min(kVecChunk, k - c0);
  int32_t id;
  const unsigned vm = load_ids<kByNode>(ids, cur, qi, k, c0, live, lane, id);
  if (store_none<kByNode>(vm, out, qi, k, c0, live, lane)) return;  // warp-uniform
  const T* row[kVecChunk];
#pragma unroll
  for (int u = 0; u < kVecChunk; ++u)
    row[u] = table + clamp_row(__shfl_sync(kFull, id, u), n_rows) * static_cast<int64_t>(d);
  const float* q = qs + qi * d;
  float dot[kVecChunk], sq[kVecChunk];
#pragma unroll
  for (int u = 0; u < kVecChunk; ++u) dot[u] = sq[u] = 0.f;
  for (int d0 = 0; d0 < d; d0 += kVecPass * kWarp) {
    // every load of the pass first (rows evict-first); dims >= d and
    // candidates >= live read nothing and sum 0 * 0 = +0, which leaves a
    // partial sum unchanged
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
      for (int u = 0; u < kVecChunk; ++u)
        x[u][i] = in && reads<kByNode>(vm, u, live) ? to_f32(__ldcs(row[u] + j)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kVecChunk; ++u) {
#pragma unroll
      for (int i = 0; i < kVecPass; ++i) {
        float v = x[u][i];
        if (kDequant) v = ov[i] + sv[i] * v;
        dot[u] += qv[i] * v;
        if (!kIP) sq[u] += v * v;
      }
    }
  }
  const float dsum = reduce_scatter<kVecChunk>(dot, lane, kWarp);
  const float ssum = kIP ? 0.f : reduce_scatter<kVecChunk>(sq, lane, kWarp);
  constexpr int kSpan = kWarp / kVecChunk;  // lanes that end with the same candidate
  const int c = lane / kSpan;
  if (lane % kSpan == 0 && c < live)
    out[qi * k + c0 + c] = reads<kByNode>(vm, c, live) ? (kIP ? -dsum : ssum - 2.f * dsum)
                                                       : INFINITY;
}

// K3 on uint8 rows that are a whole number of 4-byte words (d % 4 == 0,
// the table 4-byte aligned), with or without the dequant affine: the
// function and order of summation of vec_dist_kernel. Warp w owns query w
// / chunks, candidates c0 = (w % chunks) * kC, ..., c0 + kC - 1 (those <
// k), kC = 8 or 16, in groups of 8. Each 128-dim pass reads every row's
// words first, lane l word l (a row's 128 bytes in one warp load),
// evict-first; then one shuffle a dim hands lane j its dims j, j + 32, j +
// 64, j + 96 (dim j + 32 i is byte j % 4 of lane (j + 32 i) / 4's word), and
// a byte permute and a subtract make each an exact float (code_value, no
// int-to-float conversion). Lane j sums those dims in that order and the
// xor tree adds the lanes (one reduce_scatter per group of 8), as in
// vec_dist_kernel, so results equal it bit for bit.
template <bool kDequant, bool kIP, int kC, bool kByNode>
__global__ void __launch_bounds__(kVecWarps * kWarp)
vec_dist_bytes_kernel(const uint8_t* __restrict__ table, int64_t n_rows, int d,
                      const int32_t* __restrict__ ids, const int32_t* __restrict__ cur, int k,
                      int chunks, int64_t n_work, const float* __restrict__ qs,
                      const float* __restrict__ offset, const float* __restrict__ scale,
                      float* __restrict__ out) {
  constexpr int kG = kC / kVecChunk;  // groups of 8 candidates
  const int lane = threadIdx.x % kWarp;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kVecWarps + threadIdx.x / kWarp;
  if (w >= n_work) return;  // warp-uniform
  const int64_t qi = w / chunks;
  const int c0 = static_cast<int>(w % chunks) * kC;
  const int live = min(kC, k - c0);
  int32_t id;
  const unsigned vm = load_ids<kByNode>(ids, cur, qi, k, c0, live, lane, id);
  if (store_none<kByNode>(vm, out, qi, k, c0, live, lane)) return;  // warp-uniform
  const int row_words = d / 4;
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
    // every row load of the pass first; words past the row and candidates
    // >= live read nothing
    const int wi = d0 / 4 + lane;
    uint32_t x[kC];
#pragma unroll
    for (int u = 0; u < kC; ++u)
      x[u] = wi < row_words && reads<kByNode>(vm, u, live) ? __ldcs(row[u] + wi) : 0u;
#pragma unroll
    for (int i = 0; i < kVecPass; ++i) {
      if (d0 + i * kWarp < d) {  // warp-uniform; dims past d would add +0
        const int j = d0 + lane + i * kWarp;
        const bool in = j < d;
        const float qv = in ? __ldg(q + j) : 0.f;
        float ov = 0.f, sv = 0.f;
        if (kDequant) {
          ov = in ? __ldg(offset + j) : 0.f;
          sv = in ? __ldg(scale + j) : 0.f;
        }
        const int src = (lane + kWarp * i) / 4;
#pragma unroll
        for (int u = 0; u < kC; ++u) {
          float v = code_value<8>(__shfl_sync(kFull, x[u], src), lane & 3);
          if (kDequant) v = ov + sv * v;
          dot[u / kVecChunk][u % kVecChunk] += qv * v;
          if (!kIP) sq[u / kVecChunk][u % kVecChunk] += v * v;
        }
      }
    }
  }
  constexpr int kSpan = kWarp / kVecChunk;  // lanes that end with the same candidate
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const float dsum = reduce_scatter<kVecChunk>(dot[g], lane, kWarp);
    const float ssum = kIP ? 0.f : reduce_scatter<kVecChunk>(sq[g], lane, kWarp);
    const int c = g * kVecChunk + lane / kSpan;
    if (lane % kSpan == 0 && c < live)
      out[qi * k + c0 + c] = reads<kByNode>(vm, c, live) ? (kIP ? -dsum : ssum - 2.f * dsum)
                                                         : INFINITY;
  }
}

// the bf16 values of one load as floats: a bf16 is the high half of the
// f32 of the same value; value 2 m is the low half of word m
__device__ __forceinline__ void widen(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void widen(uint2 w, float* v) {
  widen(w.x, v);
  widen(w.y, v + 2);
}
__device__ __forceinline__ void widen(uint4 w, float* v) {
  widen(w.x, v);
  widen(w.y, v + 2);
  widen(w.z, v + 4);
  widen(w.w, v + 6);
}

constexpr int kBf16Rows = 4;  // rows a lane reads

// K3 on bf16 rows that are a whole number of V loads (16, 8 or 4 bytes;
// the table and the query rows aligned to them), in another order of
// summation than vec_dist_kernel's: lpr lanes read a row side by side (the
// least power of two >= its loads, 4 to 32), 32 / lpr rows sit side by
// side in a warp and each lane reads kBf16Rows of them, so warp w owns
// query w / chunks and 4 * 32 / lpr candidates from c0 = (w % chunks) * 4 *
// 32 / lpr. Every row load of a step goes out before the sums (evict-first);
// lane sl of a row sums its loads sl, sl + lpr, ... value by value, then
// the row's lanes reduce (one reduce_scatter over the kBf16Rows rows).
template <typename V, bool kIP, bool kByNode>
__global__ void __launch_bounds__(kVecWarps * kWarp)
vec_dist_bf16_kernel(const V* __restrict__ table, int64_t n_rows, int units, int lpr,
                     const int32_t* __restrict__ ids, const int32_t* __restrict__ cur, int k,
                     int chunks, int64_t n_work, const float* __restrict__ qs,
                     float* __restrict__ out) {
  constexpr int kVals = static_cast<int>(sizeof(V)) / 2;  // values a load holds
  const int lane = threadIdx.x % kWarp;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kVecWarps + threadIdx.x / kWarp;
  if (w >= n_work) return;  // warp-uniform
  const int rpw = kWarp / lpr, cpw = kBf16Rows * rpw;
  const int g = lane / lpr, sl = lane % lpr;
  const int64_t qi = w / chunks;
  const int c0 = static_cast<int>(w % chunks) * cpw;
  const int live = min(cpw, k - c0);
  int32_t id;
  const unsigned vm = load_ids<kByNode>(ids, cur, qi, k, c0, live, lane, id);
  if (store_none<kByNode>(vm, out, qi, k, c0, live, lane)) return;  // warp-uniform
  const V* row[kBf16Rows];
  bool ok[kBf16Rows];
#pragma unroll
  for (int s = 0; s < kBf16Rows; ++s) {
    const int c = s * rpw + g;
    ok[s] = c < live && reads<kByNode>(vm, c, live);
    row[s] = table + clamp_row(__shfl_sync(kFull, id, c), n_rows) * static_cast<int64_t>(units);
  }
  const float2* q2 = reinterpret_cast<const float2*>(qs + qi * units * kVals);
  float dot[kBf16Rows], sq[kBf16Rows];
#pragma unroll
  for (int s = 0; s < kBf16Rows; ++s) dot[s] = sq[s] = 0.f;
  for (int e = sl; e < units; e += lpr) {
    V x[kBf16Rows];
#pragma unroll
    for (int s = 0; s < kBf16Rows; ++s) x[s] = ok[s] ? __ldcs(row[s] + e) : V{};
    float qv[kVals];
#pragma unroll
    for (int m = 0; m < kVals / 2; ++m) {
      const float2 a = __ldg(q2 + e * (kVals / 2) + m);
      qv[2 * m] = a.x;
      qv[2 * m + 1] = a.y;
    }
#pragma unroll
    for (int s = 0; s < kBf16Rows; ++s) {
      float v[kVals];
      widen(x[s], v);
#pragma unroll
      for (int m = 0; m < kVals; ++m) {
        dot[s] += qv[m] * v[m];
        if (!kIP) sq[s] += v[m] * v[m];
      }
    }
  }
  const float dsum = reduce_scatter<kBf16Rows>(dot, sl, lpr);
  const float ssum = kIP ? 0.f : reduce_scatter<kBf16Rows>(sq, sl, lpr);
  const int span = lpr / kBf16Rows;  // lanes that end with the same row
  const int c = ((sl / span) % kBf16Rows) * rpw + g;
  if (sl % span == 0 && c < live)
    out[qi * k + c0 + c] = reads<kByNode>(vm, c, live) ? (kIP ? -dsum : ssum - 2.f * dsum)
                                                       : INFINITY;
}

template <typename V, bool kByNode>
void launch_bf16(const void* table, int64_t n_rows, int d, const int32_t* ids, const int32_t* cur,
                 int q, int k, const float* qs, bool ip, float* out, cudaStream_t s) {
  const int units = d * 2 / static_cast<int>(sizeof(V));
  int lpr = kBf16Rows;
  while (lpr < units && lpr < kWarp) lpr <<= 1;
  const int cpw = kBf16Rows * (kWarp / lpr);
  const int chunks = (k + cpw - 1) / cpw;
  const int64_t work = static_cast<int64_t>(q) * chunks;
  const auto grid = static_cast<unsigned>((work + kVecWarps - 1) / kVecWarps);
  const V* t = static_cast<const V*>(table);
  if (ip)
    vec_dist_bf16_kernel<V, true, kByNode><<<grid, kVecWarps * kWarp, 0, s>>>(
        t, n_rows, units, lpr, ids, cur, k, chunks, work, qs, out);
  else
    vec_dist_bf16_kernel<V, false, kByNode><<<grid, kVecWarps * kWarp, 0, s>>>(
        t, n_rows, units, lpr, ids, cur, k, chunks, work, qs, out);
}

// K3: f32 rows, and sub-word rows no wider kernel can read, take
// vec_dist_kernel (one value a lane a load); uint8 rows of whole 4-byte
// words vec_dist_bytes_kernel (16 candidates a warp where a query has 64 or
// more: two groups of rows in flight; else 8, more warps for the build's
// descent and entry); bf16 rows of whole 4-, 8- or 16-byte loads
// vec_dist_bf16_kernel with the widest load the rows and the query rows
// take. kByNode: ids is the adjacency, read at row cur[q].
template <typename T, bool kByNode>
void launch_vec_src(const void* table, int64_t n_rows, int d, const int32_t* ids,
                    const int32_t* cur, int q, int k, const float* qs, const float* offset,
                    const float* scale, bool ip, float* out, cudaStream_t s) {
  const T* t = static_cast<const T*>(table);
  const int64_t row_bytes = static_cast<int64_t>(d) * sizeof(T);
  // loads of b bytes fit: b divides the row bytes and both bases
  const auto fits = [&](int b) {
    return row_bytes % b == 0 &&
           (reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(qs)) % b == 0;
  };
  const auto run = [&](auto kern, int chunk) {
    const int chunks = (k + chunk - 1) / chunk;
    const int64_t work = static_cast<int64_t>(q) * chunks;
    const auto grid = static_cast<unsigned>((work + kVecWarps - 1) / kVecWarps);
    kern<<<grid, kVecWarps * kWarp, 0, s>>>(t, n_rows, d, ids, cur, k, chunks, work, qs, offset,
                                            scale, out);
  };
  if constexpr (sizeof(T) == 2) {
    if (fits(16)) return launch_bf16<uint4, kByNode>(table, n_rows, d, ids, cur, q, k, qs, ip, out, s);
    if (fits(8)) return launch_bf16<uint2, kByNode>(table, n_rows, d, ids, cur, q, k, qs, ip, out, s);
    if (fits(4))
      return launch_bf16<uint32_t, kByNode>(table, n_rows, d, ids, cur, q, k, qs, ip, out, s);
  }
  if constexpr (sizeof(T) == 1) {
    if (fits(4)) {
      const bool wide = k >= 64;
      const auto pick = [&](auto k16, auto k8) { wide ? run(k16, 16) : run(k8, 8); };
      if (offset)
        ip ? pick(vec_dist_bytes_kernel<true, true, 16, kByNode>,
                  vec_dist_bytes_kernel<true, true, 8, kByNode>)
           : pick(vec_dist_bytes_kernel<true, false, 16, kByNode>,
                  vec_dist_bytes_kernel<true, false, 8, kByNode>);
      else
        ip ? pick(vec_dist_bytes_kernel<false, true, 16, kByNode>,
                  vec_dist_bytes_kernel<false, true, 8, kByNode>)
           : pick(vec_dist_bytes_kernel<false, false, 16, kByNode>,
                  vec_dist_bytes_kernel<false, false, 8, kByNode>);
      return;
    }
  }
  if (offset)
    ip ? run(vec_dist_kernel<T, true, true, kByNode>, kVecChunk)
       : run(vec_dist_kernel<T, true, false, kByNode>, kVecChunk);
  else
    ip ? run(vec_dist_kernel<T, false, true, kByNode>, kVecChunk)
       : run(vec_dist_kernel<T, false, false, kByNode>, kVecChunk);
}

// K3 on ids [q, k], or, with cur given, by node on the adjacency ids [n_nodes, k]
template <typename T>
void launch_vec(const void* table, int64_t n_rows, int d, const int32_t* ids, const int32_t* cur,
                int q, int k, const float* qs, const float* offset, const float* scale, bool ip,
                float* out, cudaStream_t s) {
  if (cur != nullptr)
    launch_vec_src<T, true>(table, n_rows, d, ids, cur, q, k, qs, offset, scale, ip, out, s);
  else
    launch_vec_src<T, false>(table, n_rows, d, ids, cur, q, k, qs, offset, scale, ip, out, s);
}

}  // namespace
}  // namespace hnsw
