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
// What bounds it on the H100: latency, not bytes. A hop moves ~(2 ef + 2 K)
// * 4 bytes per query (12.6 MB at Q = 8192, ef = K = 64: 3.8 us of HBM),
// but every step depends on the last (dedup, then sort, then merge, then
// select), so the time is the chain of dependent steps inside one query
// times the number of waves of queries the card needs. The first port gave
// each query a 256-thread block: at ef = K = 64 three quarters of its
// threads idled through six block barriers and K-long serial compare loops,
// and only 8 queries fit on an SM at once.
//
// What the design does about it. Where ef + K <= 256 (the serving buckets
// ef in {32, 64, 128} at K = 64) one WARP owns a query (beam_warp_kernel):
// a 256-thread block carries 8 queries, so 8x more queries are in flight,
// and the warp never waits on a block barrier (__syncwarp only). Per query:
//   * loads: the buffer row into warp-private shared memory with 16-byte
//     loads, the candidates into registers (lane l holds candidates
//     l * C .. l * C + C - 1, C = 1, 2, 4 or 8 a lane), coalesced;
//   * fast path: a query with no valid candidate (converged queries get all
//     -1 from the hop loop) or no fresh one keeps its buffer as it is: the
//     plain version's stable sort puts the buffer first on equal +inf keys,
//     so the result is the buffer, then ef_live and the selection;
//   * membership: the buffer's ids go into a warp-private open-addressing
//     hash table in shared memory (>= 2 ef slots, atomicCAS inserts), and
//     each candidate probes it: O(1) expected per candidate instead of a
//     K- or ef-long compare loop;
//   * order: the candidates are sorted in registers by a bitonic network
//     over shuffles on the total key (distance, candidate index); every key
//     is distinct, so the network's result is exactly the stable order;
//   * merge path: each buffer slot and each sorted candidate finds its
//     place in the merged order with one binary search in the other list
//     (buffer first on equal keys), so entries past ef are never written;
//   * selection: __ballot_sync / __ffs over "unexpanded and finite" in
//     slot order;
//   * stores: 16-byte stores of the merged row.
// Wider shapes (ef + K > 256, up to ef <= 1024 and K <= 1024) take
// beam_block_kernel, one 256-thread block per query with the state in
// shared memory: a stable rank count, the same merge-path merge and an
// atomicMin selection. Both give exactly a stable sort of (buffer ++ fresh
// candidates), the plain PyTorch version, tie order included. The TPU's
// bitonic network is unstable on ties; the reference allows either order
// (beam_kernel.py:28). Keys are compared as floats: negative L2 surrogates
// sort correctly, +inf marks empty slots, and NaN keys are not supported.
//
// The hop entry (hnsw_beam_hop, kHop) is the fused beam's whole level-0 hop
// bookkeeping in the same two kernels, so that a hop on the card is the
// distance kernel and this one, with no PyTorch op between or after them.
// It updates the search's state in place: a query whose cur is -1, or whose
// steps (hops it has taken) reached the limit, returns before it reads
// anything, so its row stays exactly as it is; otherwise the candidates are
// the expanded node's adjacency row nbrs[cur] (-1 = no candidate), read
// here, with the distances the distance kernel wrote, ndis grows by the
// fresh count and steps by one. ef_live and the limit are read from device
// scalars, so a captured search takes them at replay. The batch's hop count
// is the largest steps (a query is live on a prefix of the hops, so its
// steps equal the batch's count while it is live): no block needs another's
// result, and the batch-wide condition costs no reduction a hop.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace hnsw {
namespace {

constexpr int kThreads = 256;
constexpr int kQueriesPerBlock = kThreads / kWarp;  // warp path
constexpr int kWarpMaxWidth = 256;                  // ef + K of the warp path
constexpr unsigned kFull = 0xffffffffu;

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

// number of a[0..kN) < x, kN a power of two (a ascending), in log2(kN) + 1
// steps with no data-dependent trip count
template <int kN>
__device__ __forceinline__ int count_less_pow2(const float* a, float x) {
  int lo = 0;
#pragma unroll
  for (int s = kN / 2; s >= 1; s >>= 1)
    if (a[lo + s - 1] < x) lo += s;
  return lo + (a[lo] < x ? 1 : 0);
}

// (ka, ia) before (kb, ib) on the total key (distance, candidate index)
__device__ __forceinline__ bool before(float ka, int ia, float kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

__device__ __forceinline__ uint32_t hash_slot(int32_t id, int shift) {
  return (static_cast<uint32_t>(id) * 0x9E3779B1u) >> shift;
}

// The fused beam's per-query state that the hop entry reads and updates in
// place (unused by beam_update).
struct HopState {
  const int32_t* nbrs;     // [n_rows, k] adjacency: candidates of node cur[q]
  int64_t n_rows;
  int32_t* steps;          // [q] hops the query has taken
  const int64_t* ef_live;  // 0-d, or null: ef
  const int64_t* limit;    // 0-d: no query takes more hops
};

// kHop: the query's row of the hop entry, or false where the query does not
// step (cur -1 or steps at the limit: its state is left as it is). Sets the
// candidate ids' row, the hops taken and ef_live.
template <bool kHop>
__device__ __forceinline__ bool hop_row(const HopState& h, const int32_t* cand_i,
                                        const int32_t* cur, int64_t qi, int k,
                                        const int32_t*& gi, int& taken, int& ef_live) {
  if constexpr (!kHop) {
    gi = cand_i + qi * k;
    return true;
  } else {
    const int32_t node = cur[qi];
    taken = h.steps[qi];
    if (node < 0 || taken >= *h.limit) return false;
    gi = h.nbrs + clamp_row(node, h.n_rows) * k;
    if (h.ef_live != nullptr && *h.ef_live < ef_live) ef_live = static_cast<int>(*h.ef_live);
    return true;
  }
}

// a buffer value: read-only data (__ldg) for beam_update; for the hop entry
// the buffer is rewritten in place by the same warp, so a plain load
template <bool kHop, typename T>
__device__ __forceinline__ T ld_buf(const T* p) {
  if constexpr (kHop) return *p;
  else return __ldg(p);
}

// Warp path: one warp per query, kCpl candidates per lane (K <= 32 kCpl).
// Shared memory per warp, in int32 words, every region a multiple of 4
// words so 16-byte accesses stay aligned:
//   tab [1 << tab_log2]  hash table of buffer ids (-1 = free); after the
//                        probes it holds the merged row: od = tab[0, efp),
//                        op = tab[efp, 2 efp) (tab_log2 makes it >= 2 efp)
//   bd, bp [efp]         the buffer row as loaded (keys, payloads)
//   cpay [kN]            candidate payloads by candidate index
//   sk [kN]              candidate keys in sorted order
// vec: ef and K are multiples of 4 and every row is 16-byte aligned.
// kHop: the hop entry (out_d / out_p are buf_d / buf_p, cur and ndis are
// read and rewritten, cand_i is h.nbrs).
template <int kCpl, bool kHop>
__global__ void __launch_bounds__(kThreads)
beam_warp_kernel(const float* buf_d, const int32_t* buf_p,
                 const int32_t* __restrict__ cand_i,
                 const float* __restrict__ cand_d, int q, int ef, int k,
                 int ef_live, int tab_log2, bool vec, float* out_d,
                 int32_t* out_p, int32_t* cur, int32_t* ndis, HopState h) {
  constexpr int kN = kWarp * kCpl;
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t qi = static_cast<int64_t>(blockIdx.x) * kQueriesPerBlock + warp;
  if (qi >= q) return;  // the whole warp: no block barrier follows
  const int32_t* gi;
  int taken = 0;
  if (!hop_row<kHop>(h, cand_i, cur, qi, k, gi, taken, ef_live)) return;  // warp-uniform
  const int tab_n = 1 << tab_log2;
  const int efp = (ef + 3) & ~3;
  int32_t* tab = smem + static_cast<int64_t>(warp) * (tab_n + 2 * efp + 2 * kN);
  float* bd = reinterpret_cast<float*>(tab + tab_n);
  int32_t* bp = tab + tab_n + efp;
  int32_t* cpay = bp + efp;
  float* sk = reinterpret_cast<float*>(cpay + kN);

  const float* gd = buf_d + qi * ef;
  const int32_t* gp = buf_p + qi * ef;
  const float* gc = cand_d + qi * k;
  if (vec) {
    for (int i = lane; i < ef / 4; i += kWarp) {
      reinterpret_cast<float4*>(bd)[i] = ld_buf<kHop>(reinterpret_cast<const float4*>(gd) + i);
      reinterpret_cast<int4*>(bp)[i] = ld_buf<kHop>(reinterpret_cast<const int4*>(gp) + i);
    }
  } else {
    for (int i = lane; i < ef; i += kWarp) {
      bd[i] = ld_buf<kHop>(gd + i);
      bp[i] = ld_buf<kHop>(gp + i);
    }
  }
  // candidate e = lane * kCpl + r sits in register r of lane `lane`
  int32_t cid[kCpl];
  float key[kCpl];
  bool vec_cand = false;  // the whole row in kCpl-wide loads
  if constexpr (kCpl >= 4) {
    if (vec && k == kN) {
#pragma unroll
      for (int v = 0; v < kCpl / 4; ++v) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(gi) + lane * (kCpl / 4) + v);
        const float4 b = __ldg(reinterpret_cast<const float4*>(gc) + lane * (kCpl / 4) + v);
        cid[4 * v] = a.x; cid[4 * v + 1] = a.y; cid[4 * v + 2] = a.z; cid[4 * v + 3] = a.w;
        key[4 * v] = b.x; key[4 * v + 1] = b.y; key[4 * v + 2] = b.z; key[4 * v + 3] = b.w;
      }
      vec_cand = true;
    }
  } else if constexpr (kCpl == 2) {
    if (vec && k == kN) {
      const int2 a = __ldg(reinterpret_cast<const int2*>(gi) + lane);
      const float2 b = __ldg(reinterpret_cast<const float2*>(gc) + lane);
      cid[0] = a.x; cid[1] = a.y;
      key[0] = b.x; key[1] = b.y;
      vec_cand = true;
    }
  }
  if (!vec_cand) {
#pragma unroll
    for (int r = 0; r < kCpl; ++r) {
      const int e = lane * kCpl + r;
      cid[r] = e < k ? __ldg(gi + e) : -1;
      key[r] = e < k ? __ldg(gc + e) : INFINITY;
    }
  }
  bool any_valid = false;
#pragma unroll
  for (int r = 0; r < kCpl; ++r) any_valid |= cid[r] >= 0;
  __syncwarp();

  int fresh_n = 0;
  if (__any_sync(kFull, any_valid)) {
    // 1. membership: hash the buffer's ids, then probe each candidate
    const int shift = 32 - tab_log2;
    const uint32_t mask = static_cast<uint32_t>(tab_n - 1);
    for (int i = 4 * lane; i < tab_n; i += 4 * kWarp)
      *reinterpret_cast<int4*>(tab + i) = make_int4(-1, -1, -1, -1);
    __syncwarp();
    for (int i = lane; i < ef; i += kWarp) {
      const int32_t id = bp[i] >> 1;  // -1 for empty slots; never a valid id
      if (id < 0) continue;
      for (uint32_t h = hash_slot(id, shift);; h = (h + 1) & mask) {
        const int32_t old = atomicCAS(tab + h, -1, id);
        if (old == -1 || old == id) break;
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kCpl; ++r) {
      bool fresh = cid[r] >= 0;
      if (fresh) {
        for (uint32_t h = hash_slot(cid[r], shift);; h = (h + 1) & mask) {
          const int32_t v = tab[h];
          if (v == cid[r]) { fresh = false; break; }
          if (v == -1) break;
        }
      }
      fresh_n += __popc(__ballot_sync(kFull, fresh));
      if (!fresh) key[r] = INFINITY;
      cpay[lane * kCpl + r] = fresh ? (cid[r] << 1) : -1;
    }
    __syncwarp();  // cpay is read by index below; tab is rewritten
  }

  const float* fd = bd;
  const int32_t* fp = bp;
  if (fresh_n > 0) {  // warp-uniform: a sum of ballots
    // 2a. bitonic sort of (key, index) over the warp's kN slots; padding
    // slots (index >= K) hold +inf and sort after every real candidate
    int idx[kCpl];
#pragma unroll
    for (int r = 0; r < kCpl; ++r) idx[r] = lane * kCpl + r;
#pragma unroll
    for (int size = 2; size <= kN; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        if (stride < kCpl) {  // both slots in this lane's registers
#pragma unroll
          for (int r = 0; r < kCpl; ++r) {
            const int r2 = r | stride;
            if ((r & stride) == 0) {
              const bool asc = ((lane * kCpl + r) & size) == 0;
              const bool swap = asc ? before(key[r2], idx[r2], key[r], idx[r])
                                    : before(key[r], idx[r], key[r2], idx[r2]);
              if (swap) {
                const float tk = key[r]; key[r] = key[r2]; key[r2] = tk;
                const int ti = idx[r]; idx[r] = idx[r2]; idx[r2] = ti;
              }
            }
          }
        } else {  // partner slot in lane ^ (stride / kCpl), same register
#pragma unroll
          for (int r = 0; r < kCpl; ++r) {
            const float ok = __shfl_xor_sync(kFull, key[r], stride / kCpl);
            const int oi = __shfl_xor_sync(kFull, idx[r], stride / kCpl);
            const int e = lane * kCpl + r;
            const bool lower = (e & stride) == 0;
            const bool asc = (e & size) == 0;
            const bool other_first = before(ok, oi, key[r], idx[r]);
            if (lower == asc ? other_first : !other_first) {
              key[r] = ok;
              idx[r] = oi;
            }
          }
        }
      }
    }
    int32_t pay[kCpl];
#pragma unroll
    for (int r = 0; r < kCpl; ++r) {
      sk[lane * kCpl + r] = key[r];
      pay[r] = cpay[idx[r]];
    }
    __syncwarp();

    // 2b. merge: place = own index + entries of the other list before it;
    // the merged row goes where the hash table was
    float* od = reinterpret_cast<float*>(tab);
    int32_t* op = tab + efp;
    for (int i = lane; i < ef; i += kWarp) {
      const float x = bd[i];
      const int pos = i + count_less_pow2<kN>(sk, x);
      if (pos < ef) {
        od[pos] = x;
        op[pos] = bp[i];
      }
    }
    // a +inf key lands at or past ef: padding and stale ids never land
#pragma unroll
    for (int r = 0; r < kCpl; ++r) {
      const int pos = lane * kCpl + r + count_less_equal(bd, ef, key[r]);
      if (pos < ef) {
        od[pos] = key[r];
        op[pos] = pay[r];
      }
    }
    __syncwarp();
    fd = od;
    fp = op;
  }

  // 3./4. ef_live and the first unexpanded finite slot, 32 slots a ballot
  int j = ef;
  for (int base = 0; base < ef; base += kWarp) {
    const int i = base + lane;
    const bool open = i < ef && i < ef_live && (fp[i] & 1) == 0 && fd[i] < INFINITY;
    const unsigned m = __ballot_sync(kFull, open);
    if (m) {
      j = base + __ffs(m) - 1;
      break;
    }
  }
  float* dd = out_d + qi * ef;
  int32_t* dp = out_p + qi * ef;
  if (vec) {
    for (int i = lane; i < ef / 4; i += kWarp) {
      float4 x = reinterpret_cast<const float4*>(fd)[i];
      int4 p = reinterpret_cast<const int4*>(fp)[i];
      const int s = 4 * i;
      if (s >= ef_live) { x.x = INFINITY; p.x = -1; }
      if (s + 1 >= ef_live) { x.y = INFINITY; p.y = -1; }
      if (s + 2 >= ef_live) { x.z = INFINITY; p.z = -1; }
      if (s + 3 >= ef_live) { x.w = INFINITY; p.w = -1; }
      p.x |= s == j; p.y |= s + 1 == j; p.z |= s + 2 == j; p.w |= s + 3 == j;
      reinterpret_cast<float4*>(dd)[i] = x;
      reinterpret_cast<int4*>(dp)[i] = p;
    }
  } else {
    for (int i = lane; i < ef; i += kWarp) {
      const bool dead = i >= ef_live;
      dd[i] = dead ? INFINITY : fd[i];
      dp[i] = dead ? -1 : (fp[i] | (i == j ? 1 : 0));
    }
  }
  if (lane == 0) {
    cur[qi] = j < ef ? (fp[j] >> 1) : -1;
    if constexpr (kHop) {
      ndis[qi] += fresh_n;
      h.steps[qi] = taken + 1;
    } else {
      ndis[qi] = fresh_n;
    }
  }
}

// Block path (ef + K > 256): one block per query, the state in shared
// memory, each step a flat parallel pass with no data-dependent loop.
// kHop as in beam_warp_kernel.
template <bool kHop>
__global__ void __launch_bounds__(kThreads)
beam_block_kernel(const float* buf_d, const int32_t* buf_p,
                  const int32_t* __restrict__ cand_i,
                  const float* __restrict__ cand_d, int ef, int k,
                  int ef_live, float* out_d, int32_t* out_p, int32_t* cur,
                  int32_t* ndis, HopState h) {
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
  const int32_t* gi;
  int taken = 0;
  if (!hop_row<kHop>(h, cand_i, cur, qi, k, gi, taken, ef_live)) return;  // block-uniform
  if (tid == 0) {
    s_fresh = 0;
    s_first = ef;
  }
  for (int i = tid; i < ef; i += blockDim.x) {
    bd[i] = buf_d[qi * ef + i];
    bp[i] = buf_p[qi * ef + i];
  }
  for (int c = tid; c < k; c += blockDim.x) {
    ci[c] = gi[c];
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
    if constexpr (kHop) {
      ndis[qi] += s_fresh;
      h.steps[qi] = taken + 1;
    } else {
      ndis[qi] = s_fresh;
    }
  }
}

template <int kCpl, bool kHop>
void launch_warp(const float* bd, const int32_t* bp, const int32_t* ci,
                 const float* cd, int q, int ef, int k, int ef_live,
                 float* od, int32_t* op, int32_t* cur, int32_t* ndis,
                 const HopState& h, cudaStream_t s) {
  const int efp = (ef + 3) & ~3;
  int tab_log2 = 6;  // >= 64 slots and >= 2 efp: load factor <= 1/2
  while ((1 << tab_log2) < 2 * efp) ++tab_log2;
  const size_t per_warp = static_cast<size_t>((1 << tab_log2) + 2 * efp + 2 * kWarp * kCpl);
  const size_t smem = per_warp * kQueriesPerBlock * sizeof(int32_t);
  const bool vec = ef % 4 == 0 && k % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(bd) | reinterpret_cast<uintptr_t>(bp) |
                    reinterpret_cast<uintptr_t>(ci) | reinterpret_cast<uintptr_t>(cd) |
                    reinterpret_cast<uintptr_t>(od) | reinterpret_cast<uintptr_t>(op)) % 16 == 0;
  const unsigned grid = static_cast<unsigned>((q + kQueriesPerBlock - 1) / kQueriesPerBlock);
  beam_warp_kernel<kCpl, kHop><<<grid, kThreads, smem, s>>>(
      bd, bp, ci, cd, q, ef, k, ef_live, tab_log2, vec, od, op, cur, ndis, h);
}

// ef + k <= 256 takes the warp path, wider shapes the block path.
template <bool kHop>
void launch_beam(const float* bd, const int32_t* bp, const int32_t* ci, const float* cd, int q,
                 int ef, int k, int ef_live, float* od, int32_t* op, int32_t* c, int32_t* n,
                 const HopState& h, cudaStream_t s) {
  if (ef + k <= kWarpMaxWidth) {
    if (k <= 32) launch_warp<1, kHop>(bd, bp, ci, cd, q, ef, k, ef_live, od, op, c, n, h, s);
    else if (k <= 64) launch_warp<2, kHop>(bd, bp, ci, cd, q, ef, k, ef_live, od, op, c, n, h, s);
    else if (k <= 128) launch_warp<4, kHop>(bd, bp, ci, cd, q, ef, k, ef_live, od, op, c, n, h, s);
    else launch_warp<8, kHop>(bd, bp, ci, cd, q, ef, k, ef_live, od, op, c, n, h, s);
  } else {
    const size_t smem = (4 * static_cast<size_t>(ef) + 5 * static_cast<size_t>(k)) * sizeof(int32_t);
    beam_block_kernel<kHop><<<q, kThreads, smem, s>>>(bd, bp, ci, cd, ef, k, ef_live, od, op, c, n, h);
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
  launch_beam<false>(static_cast<const float*>(buf_d), static_cast<const int32_t*>(buf_p),
                     static_cast<const int32_t*>(cand_i), static_cast<const float*>(cand_d), q,
                     ef, k, ef_live, static_cast<float*>(out_d), static_cast<int32_t*>(out_p),
                     static_cast<int32_t*>(cur), static_cast<int32_t*>(ndis), HopState{},
                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The fused beam's hop, in place: buf_d/buf_p [q, ef], cur/ndis/steps [q]
// int32, nbrs [n_rows, k] int32 adjacency, cand_d [q, k] the distances of
// node cur[q]'s k candidates, ef_live (NULL: ef) and limit int64 0-d, all
// contiguous.
extern "C" int hnsw_beam_hop(void* buf_d, void* buf_p, const void* nbrs,
                             int64_t n_rows, const void* cand_d, int q, int ef,
                             int k, const void* ef_live, const void* limit,
                             void* cur, void* ndis, void* steps, void* stream) {
  using namespace hnsw;
  if (q <= 0) return static_cast<int>(cudaGetLastError());
  const HopState h{static_cast<const int32_t*>(nbrs), n_rows, static_cast<int32_t*>(steps),
                   static_cast<const int64_t*>(ef_live), static_cast<const int64_t*>(limit)};
  auto bd = static_cast<float*>(buf_d);
  auto bp = static_cast<int32_t*>(buf_p);
  launch_beam<true>(bd, bp, h.nbrs, static_cast<const float*>(cand_d), q, ef, k, ef, bd, bp,
                    static_cast<int32_t*>(cur), static_cast<int32_t*>(ndis), h,
                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
