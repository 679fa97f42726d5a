// Single-core CPU HNSW baseline engine.
//
// Role (SURVEY.md §6): the measured stand-in for "faiss IndexHNSWFlat on one
// CPU core" when faiss-cpu is not installed — bench.py's vs_baseline
// denominator. Written from scratch against the HNSW paper (Malkov &
// Yashunin, TPAMI 2018) with faiss-equivalent semantics: exponential level
// draw with mult = 1/ln(M), greedy upper-level descent, efSearch/efConstruction
// beam via binary heaps, select-neighbors diversity heuristic, capacity-2M
// level-0 lists with shrink-on-overflow back-links.
//
// Exposed as a flat C ABI for ctypes (no pybind11 in this environment).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <vector>

namespace {

struct Pair {
  float d;
  int32_t id;
};
struct MinCmp {  // min-heap on distance
  bool operator()(const Pair& a, const Pair& b) const { return a.d > b.d; }
};
struct MaxCmp {  // max-heap on distance
  bool operator()(const Pair& a, const Pair& b) const { return a.d < b.d; }
};
using MinHeap = std::priority_queue<Pair, std::vector<Pair>, MinCmp>;
using MaxHeap = std::priority_queue<Pair, std::vector<Pair>, MaxCmp>;

struct Index {
  int dim = 0;
  int m = 16;
  int m0 = 32;
  bool ip = false;  // false: squared L2, true: negated inner product
  double mult = 0.0;
  std::mt19937_64 rng{42};

  std::vector<float> vecs;                       // [n, dim]
  std::vector<int> levels;                       // [n]
  std::vector<std::vector<std::vector<int32_t>>> nbrs;  // [n][level][..]
  int entry = -1;
  int max_level = -1;
  std::vector<uint32_t> visit_tag;               // visited-table epochs
  uint32_t epoch = 0;

  int n() const { return static_cast<int>(levels.size()); }

  float dist(const float* a, const float* b) const {
    float acc = 0.f;
    if (ip) {
      for (int i = 0; i < dim; ++i) acc -= a[i] * b[i];
    } else {
      for (int i = 0; i < dim; ++i) {
        float t = a[i] - b[i];
        acc += t * t;
      }
    }
    return acc;
  }
  const float* vec(int32_t id) const { return vecs.data() + (size_t)id * dim; }

  int draw_level() {
    std::uniform_real_distribution<double> u01(0.0, 1.0);
    double u = std::max(u01(rng), 1e-12);
    return (int)std::floor(-std::log(u) * mult);
  }

  // paper Alg. 2: best-first beam at one level; returns ascending by dist
  std::vector<Pair> search_layer(const float* q, int ep, float ep_d, int ef,
                                 int level) {
    ++epoch;
    visit_tag.resize(vecs.size() / dim, 0);
    visit_tag[ep] = epoch;
    MinHeap cand;
    MaxHeap top;
    cand.push({ep_d, ep});
    top.push({ep_d, ep});
    while (!cand.empty()) {
      Pair c = cand.top();
      if (c.d > top.top().d && (int)top.size() >= ef) break;
      cand.pop();
      const auto& lst = nbrs[c.id][level];
      for (int32_t nb : lst) {
        if (visit_tag[nb] == epoch) continue;
        visit_tag[nb] = epoch;
        float dn = dist(q, vec(nb));
        if ((int)top.size() < ef || dn < top.top().d) {
          cand.push({dn, nb});
          top.push({dn, nb});
          if ((int)top.size() > ef) top.pop();
        }
      }
    }
    std::vector<Pair> out;
    out.reserve(top.size());
    while (!top.empty()) {
      out.push_back(top.top());
      top.pop();
    }
    std::reverse(out.begin(), out.end());
    return out;
  }

  int greedy(const float* q, int node, float& d, int from, int to) const {
    for (int level = from; level > to; --level) {
      bool moved = true;
      while (moved) {
        moved = false;
        for (int32_t nb : nbrs[node][level]) {
          float dn = dist(q, vec(nb));
          if (dn < d) {
            d = dn;
            node = nb;
            moved = true;
          }
        }
      }
    }
    return node;
  }

  // paper Alg. 4: diversity heuristic; cand ascending by dist-to-q
  void select_neighbors(const float* /*q*/, std::vector<Pair>& cand,
                        int max_m, std::vector<int32_t>& out) const {
    out.clear();
    for (const Pair& c : cand) {
      if ((int)out.size() >= max_m) break;
      bool ok = true;
      for (int32_t k : out) {
        if (dist(vec(c.id), vec(k)) < c.d) {
          ok = false;
          break;
        }
      }
      if (ok) out.push_back(c.id);
    }
  }

  void add_link(int32_t dst, int32_t src, int level) {
    auto& lst = nbrs[dst][level];
    for (int32_t x : lst)
      if (x == src) return;
    int cap = level == 0 ? m0 : m;
    if ((int)lst.size() < cap) {
      lst.push_back(src);
      return;
    }
    std::vector<Pair> cand;
    cand.reserve(lst.size() + 1);
    for (int32_t x : lst) cand.push_back({dist(vec(dst), vec(x)), x});
    cand.push_back({dist(vec(dst), vec(src)), src});
    std::sort(cand.begin(), cand.end(),
              [](const Pair& a, const Pair& b) { return a.d < b.d; });
    select_neighbors(vec(dst), cand, cap, lst);
  }

  void insert(const float* x, int efc) {
    int id = n();
    vecs.insert(vecs.end(), x, x + dim);
    int lvl = draw_level();
    levels.push_back(lvl);
    nbrs.emplace_back(lvl + 1);
    if (entry < 0) {
      entry = id;
      max_level = lvl;
      return;
    }
    float d = dist(x, vec(entry));
    int ep = greedy(x, entry, d, max_level, std::min(lvl, max_level));
    for (int level = std::min(lvl, max_level); level >= 0; --level) {
      auto cand = search_layer(x, ep, d, efc, level);
      std::vector<int32_t> kept;
      select_neighbors(x, cand, level == 0 ? m0 : m, kept);
      nbrs[id][level] = kept;
      for (int32_t k : kept) add_link(k, id, level);
      ep = cand[0].id;
      d = cand[0].d;
    }
    if (lvl > max_level) {
      entry = id;
      max_level = lvl;
    }
  }

  void search(const float* q, int k, int ef, int32_t* out_ids,
              float* out_d) {
    if (entry < 0) {
      for (int i = 0; i < k; ++i) {
        out_ids[i] = -1;
        out_d[i] = INFINITY;
      }
      return;
    }
    float d = dist(q, vec(entry));
    int ep = greedy(q, entry, d, max_level, 0);
    auto res = search_layer(q, ep, d, std::max(ef, k), 0);
    for (int i = 0; i < k; ++i) {
      if (i < (int)res.size()) {
        out_ids[i] = res[i].id;
        out_d[i] = res[i].d;
      } else {
        out_ids[i] = -1;
        out_d[i] = INFINITY;
      }
    }
  }
};

}  // namespace

extern "C" {

void* hnsw_cpu_create(int dim, int m, int is_ip, uint64_t seed) {
  auto* idx = new Index();
  idx->dim = dim;
  idx->m = m;
  idx->m0 = 2 * m;
  idx->ip = is_ip != 0;
  idx->mult = 1.0 / std::log((double)m);
  idx->rng.seed(seed);
  return idx;
}

void hnsw_cpu_free(void* h) { delete static_cast<Index*>(h); }

void hnsw_cpu_add(void* h, const float* x, int count, int efc) {
  auto* idx = static_cast<Index*>(h);
  for (int i = 0; i < count; ++i) idx->insert(x + (size_t)i * idx->dim, efc);
}

void hnsw_cpu_search(void* h, const float* q, int count, int k, int ef,
                     int32_t* out_ids, float* out_d) {
  auto* idx = static_cast<Index*>(h);
  for (int i = 0; i < count; ++i)
    idx->search(q + (size_t)i * idx->dim, k, ef, out_ids + (size_t)i * k,
                out_d + (size_t)i * k);
}

int hnsw_cpu_ntotal(void* h) { return static_cast<Index*>(h)->n(); }
}
