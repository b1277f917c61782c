// The product tile shared by the retrieval sweep (retrieval.cu) and the
// dot-only ceiling (exp_retrieval_kernels.cu) on Hopper (sm_90a).
//
// A block owns a tile of TU users and walks a range of item groups
// [g_lo, g_hi): group g is the 128 items g*128 .. g*128+127, one item of
// each lane class (item id mod 128). The walk takes GS groups at a time
// (the GS*128 items that follow each other in a row of the (d, I) table)
// and cuts the depth d into chunks of DC; one step of the walk is one
// (GS groups, chunk). The user tile (d x TU) is copied into shared memory
// once and held there for the whole walk ("resident"); each step stages
// the chunk of its groups (DC x GS*128) with cp.async, in a ring of STAGES
// stages, so STAGES - 1 steps' loads are in flight while one is
// multiplied. Where d is too wide for a resident tile, each step stages
// the chunk of the user tile (DC x TU) beside the items.
//
// Register tile: each thread owns RU users and RI items of every group
// (Shape::user, Shape::item), so its lane classes stay the same at every
// step and each (user, class) belongs to one thread. A step of dimension j
// reads the thread's RU user values and GS x RI item values from shared
// memory as float4s (float2s for 2) and issues GS * RU * RI FFMAs. Every
// read of shared memory costs its bytes whoever else reads the same
// address, so the reads per FFMA, (RU + GS * RI) / (GS * RU * RI), and not
// the broadcast, decide how close the loop comes to the FFMA rate; GS
// raises the register tile without adding (user, class) pairs a thread
// owns.
//
// Products are exact fp32: every score is one fmaf chain over j = 0..d-1 in
// order starting from 0 (the accumulators live across the chunks of a
// group), so the scores are bitwise those of the plain FFMA loop. No TF32,
// no tensor cores (the bf16 sweep's tensor-core tile is mma_tile.cuh).
//
// The walk calls epi.begin(q, g + q) at the first chunk of a step over
// groups g .. g + GS - 1 and, after its last chunk, epi.step(g, n, acc)
// with n the groups of the step below g_hi (those at or past g_hi are
// neither begun nor handed over) and acc[q][u][e] the score of user
// Shape::user(ug, u) of the tile against item (g + q)*128 +
// Shape::item(ig, e).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace coldrec_tile {

constexpr int LANES = 128;  // lane classes; items per group
constexpr int SLOTS = 8;  // sorted slots per (user, lane class)
constexpr float NEG = -10e8f;  // score of a candidate-excluded item
constexpr float INIT_NEG = -4e9f;  // below NEG: "nothing seen"

// The tile's shape: TU users per block; each thread a register tile of RU
// users x RI items of each of GS groups; LI threads of a warp side by side
// along the items; DC dimensions per step; STAGES steps in the ring.
template <int TU_, int RU_, int RI_, int LI_, int GS_, int DC_, int STAGES_>
struct Shape {
  static constexpr int TU = TU_, RU = RU_, RI = RI_, LI = LI_, GS = GS_;
  static constexpr int DC = DC_, STAGES = STAGES_;
  static constexpr int W = GS * LANES;  // items of a staged row
  static constexpr int NUG = TU / RU;  // user groups of a tile
  static constexpr int NIG = LANES / RI;  // item groups of a tile
  static constexpr int THREADS = NUG * NIG;
  static constexpr int LU = 32 / LI;  // user groups of a warp
  static constexpr int WI = NIG / LI;  // warps side by side along the items
  // a stage holds the users' chunk unless they are resident, then the
  // items' chunk
  template <bool RESIDENT>
  __host__ __device__ static constexpr int stage_floats() {
    return DC * ((RESIDENT ? 0 : TU) + W);
  }
  // dynamic shared memory of a block at depth d: the resident users, then
  // the ring
  template <bool RESIDENT>
  static constexpr size_t smem_bytes(int d) {
    return sizeof(float) * ((RESIDENT ? (size_t)TU * d : 0) +
                            STAGES * stage_floats<RESIDENT>());
  }
  // the resident tile is used up to this many bytes of shared memory
  static constexpr size_t RESIDENT_MAX = 200 * 1024;
  static constexpr bool resident(int d) {
    return smem_bytes<true>(d) <= RESIDENT_MAX;
  }
  static_assert(TU % RU == 0 && LANES % RI == 0 && NIG % LI == 0 &&
                    NUG % LU == 0 && THREADS % 32 == 0,
                "a tile of whole warps");
  static_assert((RU <= 2 || RU % 4 == 0) && (RI <= 2 || RI % 4 == 0),
                "register tiles read as float, float2 or float4s");
  static_assert((TU & (TU - 1)) == 0 && (GS & (GS - 1)) == 0,
                "TU and GS are powers of two");

  // this thread's user group and item group
  __device__ static __forceinline__ int ug() {
    return (int)(threadIdx.x >> 5) / WI * LU + (int)(threadIdx.x & 31) / LI;
  }
  __device__ static __forceinline__ int ig() {
    return (int)(threadIdx.x >> 5) % WI * LI + (int)(threadIdx.x & 31) % LI;
  }
  // user u of user group g, and item e of item group g, in the tile: runs
  // of 4 neighbours (float4s), the groups' runs side by side
  __device__ static __forceinline__ int user(int g, int u) {
    return RU <= 2 ? RU * g + u : (u / 4) * 4 * NUG + 4 * g + u % 4;
  }
  __device__ static __forceinline__ int item(int g, int e) {
    return RI <= 2 ? RI * g + e : (e / 4) * 4 * NIG + 4 * g + e % 4;
  }
};

// How the item table lies in device memory.
enum Layout {
  kRows16 = 0,  // (d, I_pad), rows 16-byte aligned: 16-byte copies
  kRows4 = 1,  // (d, I_pad), any 4-byte alignment: 4-byte copies
  kCols4 = 2,  // (I_pad, d): 4-byte copies that transpose the tile
};

// ---- cp.async (sm_80+): copies from device memory into shared memory
// 16 or 4 bytes, or as many zero bytes when !valid (src is not read then).
template <class T>
__device__ __forceinline__ void cp_async16(T* dst, const T* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- the tile
struct Tile {
  const float* __restrict__ users;  // (n_users, d)
  const float* __restrict__ items;  // (d, I_pad) or (I_pad, d)
  int n_users, d, i_pad;
  int u0;  // first user of the block
};

// Copy users [u0, u0 + TU) x dims [j0, j0 + dc) into su laid out (dc, TU)
// (row jj holds dimension j0 + jj) as floats; users past n_users are zero.
template <class S>
__device__ __forceinline__ void load_users(const Tile& t, float* su, int j0,
                                           int dc) {
  constexpr int TU = S::TU;
  for (int e = threadIdx.x; e < dc * TU; e += S::THREADS) {
    const int u = e & (TU - 1);
    const int jj = e / TU;
    const int row = t.u0 + u;
    const bool valid = row < t.n_users;
    cp_async4(su + jj * TU + u,
              t.users + (valid ? (size_t)row * t.d + j0 + jj : 0), valid);
  }
}

// Stage step (groups g .. g + GS - 1, chunk k) into `st`: the users' chunk
// (DC, TU) unless they are resident, then the items' (DC, GS * LANES).
// Rows past the chunk's depth are left as they are (the products never read
// them); items past I_pad are zero.
template <class S, int LAYOUT, bool RESIDENT>
__device__ __forceinline__ void load_step(const Tile& t, float* st, int g,
                                          int k) {
  constexpr int DC = S::DC, THREADS = S::THREADS, W = S::W;
  const int tid = threadIdx.x;
  const int j0 = k * DC;
  const int dc = min(DC, t.d - j0);
  if constexpr (!RESIDENT) load_users<S>(t, st, j0, dc);
  float* si = st + (RESIDENT ? 0 : DC * S::TU);
  const size_t col0 = (size_t)g * LANES;
  if constexpr (LAYOUT == kRows16) {
    constexpr int V = 4;  // floats of a 16-byte copy
    for (int e = tid; e < dc * (W / V); e += THREADS) {
      const int jj = e / (W / V);
      const int q = e - jj * (W / V);
      const bool valid = col0 + V * q < (size_t)t.i_pad;
      cp_async16(si + jj * W + V * q,
                 t.items + (valid ? (size_t)(j0 + jj) * t.i_pad + col0 + V * q
                                  : 0),
                 valid);
    }
  } else {
    for (int e = tid; e < dc * W; e += THREADS) {
      const int i = e & (W - 1);
      const int jj = e / W;
      const bool valid = col0 + i < (size_t)t.i_pad;
      const size_t src = !valid ? 0
                         : LAYOUT == kRows4
                             ? (size_t)(j0 + jj) * t.i_pad + col0 + i
                             : (col0 + i) * t.d + j0 + jj;
      cp_async4(si + jj * W + i, t.items + src, valid);
    }
  }
}

// The R values of group g in one staged row laid out as Shape::user (NG
// groups) or Shape::item says.
template <int R, int NG>
__device__ __forceinline__ void tile_values(const float* row, int g,
                                            float (&x)[R]) {
  if constexpr (R == 1) {
    x[0] = row[g];
  } else if constexpr (R == 2) {
    const float2 v = reinterpret_cast<const float2*>(row)[g];
    x[0] = v.x;
    x[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(row)[q * NG + g];
      x[4 * q + 0] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  }
}

template <class S>
using Acc = float[S::GS][S::RU][S::RI];

template <class S>
__device__ __forceinline__ void fma_row(const float* su, const float* si,
                                        int jj, int ug, int ig, Acc<S>& acc) {
  float uu[S::RU], xx[S::GS][S::RI];
  tile_values<S::RU, S::NUG>(su + jj * S::TU, ug, uu);
#pragma unroll
  for (int q = 0; q < S::GS; ++q) {
    tile_values<S::RI, S::NIG>(si + jj * S::W + q * LANES, ig, xx[q]);
  }
#pragma unroll
  for (int q = 0; q < S::GS; ++q) {
#pragma unroll
    for (int u = 0; u < S::RU; ++u) {
#pragma unroll
      for (int e = 0; e < S::RI; ++e) {
        acc[q][u][e] = fmaf(uu[u], xx[q][e], acc[q][u][e]);
      }
    }
  }
}

template <class S>
__device__ __forceinline__ void zero(Acc<S>& acc) {
#pragma unroll
  for (int q = 0; q < S::GS; ++q) {
#pragma unroll
    for (int u = 0; u < S::RU; ++u) {
#pragma unroll
      for (int e = 0; e < S::RI; ++e) acc[q][u][e] = 0.0f;
    }
  }
}

// The products of one step, dimension by dimension: su holds the chunk's
// user rows (stride TU), si its item rows (stride GS * LANES).
template <class S>
__device__ __forceinline__ void step_products(const float* su,
                                              const float* si, int dc, int ug,
                                              int ig, Acc<S>& acc) {
  if (dc == S::DC) {
#pragma unroll
    for (int jj = 0; jj < S::DC; ++jj) fma_row<S>(su, si, jj, ug, ig, acc);
  } else {
#pragma unroll 4
    for (int jj = 0; jj < dc; ++jj) fma_row<S>(su, si, jj, ug, ig, acc);
  }
}

// Walk groups [g_lo, g_hi) of the tile; `smem` holds
// S::smem_bytes<RESIDENT>(d) bytes: the resident users (d, TU) if
// RESIDENT, then the ring of stages. Every thread of the block must call it.
template <class S, int LAYOUT, bool RESIDENT, class Epi>
__device__ __forceinline__ void sweep_walk(const Tile& t, int g_lo, int g_hi,
                                           float* smem, Epi& epi) {
  constexpr int DC = S::DC, STAGES = S::STAGES;
  constexpr int STAGE = S::template stage_floats<RESIDENT>();
  const int ug = S::ug();
  const int ig = S::ig();
  const int chunks = (t.d + DC - 1) / DC;
  const int steps = (g_hi - g_lo + S::GS - 1) / S::GS * chunks;
  float* ring = smem + (RESIDENT ? S::TU * t.d : 0);
  // the resident users land with the first stage's copies
  if constexpr (RESIDENT) load_users<S>(t, smem, 0, t.d);
  // the step s lives in stage s % STAGES
  int lg = g_lo, lk = 0;  // the next step to load
  auto load_next = [&](int s) {
    load_step<S, LAYOUT, RESIDENT>(t, ring + (s % STAGES) * STAGE, lg, lk);
    if (++lk == chunks) {
      lk = 0;
      lg += S::GS;
    }
  };
#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_next(s);
    cp_async_commit();
  }
  Acc<S> acc;
  zero<S>(acc);
  int g = g_lo, k = 0;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();  // step s has landed (this thread's part)
    __syncthreads();  // every part of it, and step s - 1 is done with
    if (s + STAGES - 1 < steps) load_next(s + STAGES - 1);
    cp_async_commit();
    if (k == 0) {
#pragma unroll
      for (int q = 0; q < S::GS; ++q) {
        if (g + q < g_hi) epi.begin(q, g + q);
      }
    }
    const float* st = ring + (s % STAGES) * STAGE;
    step_products<S>(RESIDENT ? smem + k * DC * S::TU : st,
                     RESIDENT ? st : st + DC * S::TU, min(DC, t.d - k * DC),
                     ug, ig, acc);
    if (++k == chunks) {
      epi.step(g, min(S::GS, g_hi - g), acc);
      zero<S>(acc);
      k = 0;
      g += S::GS;
    }
  }
  cp_async_wait<0>();
}

// max(a, b) that is NaN where either is NaN (PTX max.NaN, sm_80+), where
// fmaxf would return the other operand: a ghost that once takes a NaN
// score keeps it, as jnp.maximum does in the TPU kernel.
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// min(a, b) that is NaN where either is NaN (PTX min.NaN, sm_80+), as
// jnp.minimum is.
__device__ __forceinline__ float fmin_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Part p of `parts` covers groups [part_lo(p), part_lo(p + 1)).
__device__ __forceinline__ int part_lo(int groups, int parts, int p) {
  return (int)(((long long)groups * p) / parts);
}

// Insert (v, id) into slots sorted by (-value, id), given v > rv[SLOTS-1]
// and id larger than every id in the slots: v goes behind its equals.
// Returns the value that falls off the end.
__device__ __forceinline__ float insert_sorted(float (&rv)[SLOTS],
                                               int (&ri)[SLOTS], float v,
                                               int id) {
  bool gt[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) gt[s] = v > rv[s];
  const float out = rv[SLOTS - 1];
#pragma unroll
  for (int s = SLOTS - 1; s >= 1; --s) {
    rv[s] = gt[s - 1] ? rv[s - 1] : (gt[s] ? v : rv[s]);
    ri[s] = gt[s - 1] ? ri[s - 1] : (gt[s] ? id : ri[s]);
  }
  rv[0] = gt[0] ? v : rv[0];
  ri[0] = gt[0] ? id : ri[0];
  return out;
}

// Parts for a sweep of n_users over `groups` item groups: as many as fill
// every SM with the blocks it holds of `kernel` (one item range each,
// `per_tile` blocks a tile of S::TU users), at least 1 and at most one
// group each. Returns 0 on a CUDA error.
template <class S, typename Kernel>
inline int choose_parts(Kernel* kernel, size_t smem, int n_users,
                        int groups, int per_tile = 1) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess) {
    return 0;
  }
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess) {
    return 0;
  }
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, S::THREADS, smem) != cudaSuccess) {
    return 0;
  }
  const long long tiles =
      (long long)(n_users + S::TU - 1) / S::TU * per_tile;
  long long parts = (long long)sms * (per_sm > 0 ? per_sm : 1) / tiles;
  if (parts < 1) parts = 1;
  if (parts > groups) parts = groups;
  return (int)parts;
}

}  // namespace coldrec_tile
