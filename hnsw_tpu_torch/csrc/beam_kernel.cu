// One level-0 beam hop for Hopper (sm_90a): K1 of the port.
//
// Replaces hnsw_tpu/ops/beam_kernel.py beam_update (_beam_update_kernel and
// its bitonic network _cx / _bitonic_sort_desc / _bitonic_merge_asc;
// pallas_call at :204). Per query, one hop of beam bookkeeping:
//   1. drop candidates whose id is already in the buffer (ndis = the count
//      of fresh ones);
//   2. merge the fresh ones into the ascending top-ef buffer;
//   3. kill slots >= ef_live with (+inf, -1);
//   4. pick the nearest unexpanded slot (first index on a tie), set its
//      expanded bit and return its id as cur (-1 once converged).
// Payload = (id << 1) | expanded; -1 means "empty and expanded".
//
// What bounds it on the H100: latency and shared memory, not bytes. A hop
// moves ~(2 ef + 2 K) * 4 bytes per query, but every step depends on the
// last (dedup, then sort, then merge, then select), so the time is the
// chain of dependent steps inside one query, and ef + K entries must fit in
// the block's shared memory.
//
// What the design does about it: one block per query keeps the whole state
// in shared memory (ef <= 1024 and K <= 1024 take at most 24 KB) and makes
// each step a flat parallel pass with no data-dependent loop:
//   * dedup: every thread compares its buffer slots against all K candidate
//     ids (ef * K compares spread over the block);
//   * sort: each candidate's rank is counted against the other K (stable:
//     ties go by candidate index), then scattered to its place;
//   * merge: each buffer slot and each sorted candidate finds its place in
//     the merged order with one binary search in the other list (buffer
//     first on equal keys), so entries past ef are never written;
//   * select: the merged buffer is ascending, so the nearest unexpanded
//     slot is the first unexpanded finite one: one shared atomicMin.
// The result equals a stable sort of (buffer ++ fresh candidates), the
// plain PyTorch version, tie order included. The TPU's bitonic network is
// unstable on ties; the reference allows either order (beam_kernel.py:28).
// Keys are compared as floats: negative L2 surrogates sort correctly, +inf
// marks empty slots, and NaN keys are not supported.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace hnsw {
namespace {

constexpr int kThreads = 256;

// number of a[0..n) < x (a ascending)
__device__ __forceinline__ int count_less(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// number of a[0..n) <= x (a ascending)
__device__ __forceinline__ int count_less_equal(const float* a, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
beam_update_kernel(const float* __restrict__ buf_d,
                   const int32_t* __restrict__ buf_p,
                   const int32_t* __restrict__ cand_i,
                   const float* __restrict__ cand_d, int ef, int k,
                   int ef_live, float* __restrict__ out_d,
                   int32_t* __restrict__ out_p, int32_t* __restrict__ cur,
                   int32_t* __restrict__ ndis) {
  extern __shared__ int32_t smem[];
  float* bd = reinterpret_cast<float*>(smem);          // [ef] buffer keys
  int32_t* bp = smem + ef;                             // [ef] buffer payloads
  float* od = reinterpret_cast<float*>(smem + 2 * ef); // [ef] merged keys
  int32_t* op = smem + 3 * ef;                         // [ef] merged payloads
  int32_t* ci = smem + 4 * ef;                         // [k] candidate ids
  float* ck = reinterpret_cast<float*>(ci + k);        // [k] candidate keys
  int32_t* seen = ci + 2 * k;                          // [k] in-buffer flags
  float* sk = reinterpret_cast<float*>(ci + 3 * k);    // [k] sorted keys
  int32_t* sp = ci + 4 * k;                            // [k] sorted payloads
  __shared__ int s_fresh;
  __shared__ int s_first;

  const int64_t qi = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_fresh = 0;
    s_first = ef;
  }
  for (int i = tid; i < ef; i += blockDim.x) {
    bd[i] = buf_d[qi * ef + i];
    bp[i] = buf_p[qi * ef + i];
  }
  for (int c = tid; c < k; c += blockDim.x) {
    ci[c] = cand_i[qi * k + c];
    seen[c] = 0;
  }
  __syncthreads();

  // 1. membership against the buffer as it was before the merge
  for (int i = tid; i < ef; i += blockDim.x) {
    const int32_t id = bp[i] >> 1;  // -1 for empty slots; never a valid id
    for (int c = 0; c < k; ++c)
      if (ci[c] == id) seen[c] = 1;
  }
  __syncthreads();
  int fresh_here = 0;
  for (int c = tid; c < k; c += blockDim.x) {
    const bool fresh = ci[c] >= 0 && !seen[c];
    ck[c] = fresh ? cand_d[qi * k + c] : INFINITY;
    fresh_here += fresh;
  }
  if (fresh_here) atomicAdd(&s_fresh, fresh_here);
  __syncthreads();

  // 2a. stable rank of each candidate key, scattered into sorted order
  for (int c = tid; c < k; c += blockDim.x) {
    const float x = ck[c];
    int rank = 0;
    for (int j = 0; j < k; ++j) {
      const float y = ck[j];
      rank += (y < x) || (y == x && j < c);
    }
    sk[rank] = x;
    sp[rank] = (ci[c] >= 0 && !seen[c]) ? (ci[c] << 1) : -1;
  }
  __syncthreads();

  // 2b. merge: place = own index + entries of the other list before it
  for (int i = tid; i < ef; i += blockDim.x) {
    const int pos = i + count_less(sk, k, bd[i]);
    if (pos < ef) {
      od[pos] = bd[i];
      op[pos] = bp[i];
    }
  }
  for (int r = tid; r < k; r += blockDim.x) {
    const int pos = r + count_less_equal(bd, ef, sk[r]);
    if (pos < ef) {
      od[pos] = sk[r];
      op[pos] = sp[r];
    }
  }
  __syncthreads();

  // 3. ef_live: emulate a narrower buffer; 4. first unexpanded finite slot
  for (int i = tid; i < ef; i += blockDim.x) {
    if (i >= ef_live) {
      od[i] = INFINITY;
      op[i] = -1;
    } else if ((op[i] & 1) == 0 && od[i] < INFINITY) {
      atomicMin(&s_first, i);
    }
  }
  __syncthreads();
  const int j = s_first;
  for (int i = tid; i < ef; i += blockDim.x) {
    out_d[qi * ef + i] = od[i];
    out_p[qi * ef + i] = op[i] | (i == j ? 1 : 0);
  }
  if (tid == 0) {
    cur[qi] = j < ef ? (op[j] >> 1) : -1;
    ndis[qi] = s_fresh;
  }
}

}  // namespace
}  // namespace hnsw

// buf_d/buf_p [q, ef] and cand_i/cand_d [q, k], row-major, all contiguous.
extern "C" int hnsw_beam_update(const void* buf_d, const void* buf_p,
                                const void* cand_i, const void* cand_d, int q,
                                int ef, int k, int ef_live, void* out_d,
                                void* out_p, void* cur, void* ndis,
                                void* stream) {
  using namespace hnsw;
  if (q <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = (4 * static_cast<size_t>(ef) + 5 * static_cast<size_t>(k)) * sizeof(int32_t);
  beam_update_kernel<<<q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(buf_d), static_cast<const int32_t*>(buf_p),
      static_cast<const int32_t*>(cand_i), static_cast<const float*>(cand_d),
      ef, k, ef_live, static_cast<float*>(out_d), static_cast<int32_t*>(out_p),
      static_cast<int32_t*>(cur), static_cast<int32_t*>(ndis));
  return static_cast<int>(cudaGetLastError());
}
