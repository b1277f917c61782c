// Host C++ of the port, bound with ctypes (coldrec_tpu_torch/native.py):
// the negative sampler (uniform draws rejected against the training CSR)
// and FSGNN's forward-push personalized PageRank.
//
// The sampler is a copy of the RNG, `contains` and `sample_negatives` of the
// JAX package's native/coldrec_native.cpp: the same seed gives the same
// draws, so the port's batch stream is bit for bit the JAX package's.
// Integer arithmetic only, so the draws do not depend on the compiler's
// flags.
#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- RNG
// splitmix64 + xoshiro256** — deterministic, seedable, fast.
struct Rng {
  uint64_t s[4];
};

static uint64_t splitmix64(uint64_t *x) {
  uint64_t z = (*x += 0x9E3779B97f4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

static void rng_seed(Rng *r, uint64_t seed) {
  for (int i = 0; i < 4; i++) r->s[i] = splitmix64(&seed);
}

static inline uint64_t rotl(uint64_t x, int k) {
  return (x << k) | (x >> (64 - k));
}

static inline uint64_t rng_next(Rng *r) {
  uint64_t *s = r->s;
  const uint64_t result = rotl(s[1] * 5, 7) * 9;
  const uint64_t t = s[1] << 17;
  s[2] ^= s[0];
  s[3] ^= s[1];
  s[1] ^= s[2];
  s[0] ^= s[3];
  s[2] ^= t;
  s[3] = rotl(s[3], 45);
  return result;
}

static inline int64_t rng_below(Rng *r, int64_t n) {
  // Lemire's nearly-divisionless bounded rand
  return (int64_t)(((__uint128_t)rng_next(r) * (uint64_t)n) >> 64);
}

// ------------------------------------------------------------- membership
static inline int contains(const int64_t *arr, int64_t lo, int64_t hi,
                           int64_t key) {
  while (lo < hi) {
    int64_t mid = lo + ((hi - lo) >> 1);
    if (arr[mid] < key)
      lo = mid + 1;
    else if (arr[mid] > key)
      hi = mid;
    else
      return 1;
  }
  return 0;
}

// Uniform negatives in [0, n_candidates) (or pool[0..pool_n)) rejecting
// training positives. users: (n,) mapped ids; out: (n,) item ids.
void sample_negatives(const int64_t *indptr, const int64_t *items_sorted,
                      const int64_t *users, int64_t n, int64_t n_candidates,
                      const int64_t *pool, int64_t pool_n, uint64_t seed,
                      int64_t *out) {
  Rng rng;
  rng_seed(&rng, seed);
  for (int64_t i = 0; i < n; i++) {
    int64_t u = users[i];
    int64_t lo = indptr[u], hi = indptr[u + 1];
    int64_t cand;
    int tries = 0;
    do {
      if (pool_n > 0)
        cand = pool[rng_below(&rng, pool_n)];
      else
        cand = rng_below(&rng, n_candidates);
      if (++tries > 10000) break;  // degenerate pool; caller validates
    } while (contains(items_sorted, lo, hi, cand));
    out[i] = cand;
  }
}

}  // extern "C"

// ------------------------------------------------------------ PPR push
// A copy of `PushScratch`, `push_one_source` and `ppr_push_topk` of the JAX
// package's native/coldrec_native.cpp (Andersen-Chung-Lang approximate PPR,
// threaded over sources, at most 8 threads). It replaces FSGNN's dense
// power iteration (reference FSGNN.py:54-103) above its size rule: the dense
// form iterates a (chunk, n_nodes) float64 block 30 times on the host,
// hours at book-crossing shape (92k users x 362k nodes), while the push
// work is O(1 / (alpha * eps)) per source, whatever n is.
//
// Graph: CSR over n nodes (users 0..nu-1 then items, self-loops included,
// symmetric). Pushes are row-stochastic (out-degree normalized), the
// reference's D^-1 A transition matrix. Per source u the top-k item nodes
// by PPR score, without u's observed items, go to out_items / out_vals
// (pad -1 / 0). Each source's result depends on its own pushes only, so the
// output does not depend on the thread count.

namespace {

struct PushScratch {
  std::vector<double> p, r;
  std::vector<uint8_t> inq;
  std::vector<int32_t> touched, queue;
  explicit PushScratch(int64_t n) : p(n, 0.0), r(n, 0.0), inq(n, 0) {
    touched.reserve(1 << 16);
    queue.reserve(1 << 14);
  }
};

static void push_one_source(
    int64_t n, int64_t nu, const int64_t *indptr, const int32_t *indices,
    const int64_t *obs_indptr, const int32_t *obs_items, double alpha,
    double eps, int32_t topk, int64_t u, PushScratch &s, int32_t *out_items,
    float *out_vals) {
  s.touched.clear();
  s.queue.clear();
  s.r[u] = 1.0;
  s.inq[u] = 1;
  s.touched.push_back((int32_t)u);
  s.queue.push_back((int32_t)u);
  size_t head = 0;
  while (head < s.queue.size()) {
    int32_t v = s.queue[head++];
    s.inq[v] = 0;
    double rv = s.r[v];
    int64_t beg = indptr[v], end = indptr[v + 1];
    int64_t deg = end - beg;
    if (deg <= 0 || rv < eps * (double)deg) continue;
    if (s.p[v] == 0.0 && s.r[v] == 0.0) s.touched.push_back(v);
    s.p[v] += alpha * rv;
    double share = (1.0 - alpha) * rv / (double)deg;
    s.r[v] = 0.0;
    for (int64_t e = beg; e < end; e++) {
      int32_t nb = indices[e];
      if (s.p[nb] == 0.0 && s.r[nb] == 0.0) s.touched.push_back(nb);
      s.r[nb] += share;
      if (!s.inq[nb]) {
        int64_t dnb = indptr[nb + 1] - indptr[nb];
        if (s.r[nb] >= eps * (double)dnb) {
          s.inq[nb] = 1;
          s.queue.push_back(nb);
        }
      }
    }
  }
  // top-k item nodes by p, excluding observed items of u
  const int32_t *obs_b = obs_items + obs_indptr[u];
  const int32_t *obs_e = obs_items + obs_indptr[u + 1];
  std::vector<std::pair<float, int32_t>> cand;
  cand.reserve(64);
  for (int32_t node : s.touched) {
    if (node < nu) continue;
    double pv = s.p[node];
    if (pv <= 0.0) continue;
    int32_t item = node - (int32_t)nu;
    if (std::binary_search(obs_b, obs_e, item)) continue;
    cand.emplace_back((float)pv, item);
  }
  int32_t k_eff = (int32_t)std::min<size_t>(topk, cand.size());
  if (k_eff > 0) {
    std::nth_element(
        cand.begin(), cand.begin() + (k_eff - 1), cand.end(),
        [](const auto &a, const auto &b) { return a.first > b.first; });
  }
  for (int32_t i = 0; i < topk; i++) {
    if (i < k_eff) {
      out_items[i] = cand[i].second;
      out_vals[i] = cand[i].first;
    } else {
      out_items[i] = -1;
      out_vals[i] = 0.0f;
    }
  }
  // reset scratch
  for (int32_t node : s.touched) {
    s.p[node] = 0.0;
    s.r[node] = 0.0;
    s.inq[node] = 0;
  }
}

}  // namespace

extern "C" {

void ppr_push_topk(int64_t n, int64_t nu, const int64_t *indptr,
                   const int32_t *indices, const int64_t *obs_indptr,
                   const int32_t *obs_items, double alpha, double eps,
                   int32_t topk, int32_t *out_items, float *out_vals) {
  unsigned nthreads = std::thread::hardware_concurrency();
  if (nthreads == 0) nthreads = 1;
  if (nthreads > 8) nthreads = 8;
  std::vector<std::thread> pool;
  int64_t per = (nu + nthreads - 1) / nthreads;
  for (unsigned t = 0; t < nthreads; t++) {
    int64_t b = (int64_t)t * per, e = std::min<int64_t>(b + per, nu);
    if (b >= e) break;
    pool.emplace_back([=]() {
      PushScratch scratch(n);
      for (int64_t u = b; u < e; u++) {
        push_one_source(n, nu, indptr, indices, obs_indptr, obs_items, alpha,
                        eps, topk, u, scratch,
                        out_items + (size_t)u * topk,
                        out_vals + (size_t)u * topk);
      }
    });
  }
  for (auto &th : pool) th.join();
}

}  // extern "C"
