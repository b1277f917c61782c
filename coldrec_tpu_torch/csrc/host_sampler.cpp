// Host negative sampler of the port: uniform draws rejected against the
// training CSR, on the host, bound with ctypes (coldrec_tpu_torch/native.py).
//
// A copy of the RNG, `contains` and `sample_negatives` of the JAX package's
// native/coldrec_native.cpp: the same seed gives the same draws, so the
// port's batch stream is bit for bit the JAX package's. Integer arithmetic
// only, so the draws do not depend on the compiler's flags.
#include <cstdint>

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
