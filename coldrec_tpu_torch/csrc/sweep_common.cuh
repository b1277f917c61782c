// Device code shared by the kernel-variant sweeps (exp_retrieval_kernels.cu,
// exp_multiacc.cu, exp_blockskip.cu): the TPU kernels' block-local top-2
// chain, their merge of two such chains, the sorted 8-slot insertion
// cascade, the user-tile loads of the stream sweep, and the running slots
// of the sweeps that walk the shared tile of sweep_tile.cuh.
//
// These reproduce the tie rules of the Pallas kernels in tools/exp_*.py and
// coldrec_tpu/ops/pallas/retrieval.py, not those of retrieval.cu (which
// keeps each lane class's exact top-8 by (value, id)):
//   - inside an item block, slices (the 128-item column groups, in
//     increasing order) are compared with a strict `>`, so the earliest
//     slice wins a tie for m1 and for m2; m3 is the largest value of the
//     block that is not kept;
//   - the cascade inserts m1, then m2, with a strict `>`, so an incumbent
//     keeps its slot on a tie (a stable descending merge of
//     [8 slots, m1, m2]); every evicted value and m3 go into the ghost.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_tile.cuh"

namespace coldrec_exp {

constexpr int LANES = 128;  // lane class = item id mod 128
constexpr int SLOTS = 8;  // sorted slots kept per lane class
constexpr float NEG = -10e8f;  // score of a candidate-excluded item
constexpr float INIT_NEG = -4e9f;  // below NEG: "nothing seen"
constexpr size_t SMEM_DEFAULT = 48 * 1024;  // above it, opt in per kernel
constexpr size_t SMEM_MAX = 232448;  // what one block may opt in to

// One lane class's top-2 over the slices of one item block: values m1 >= m2
// at slice indices a1, a2, and m3, the largest value dropped.
struct Top2 {
  float m1, m2, m3;
  int a1, a2;

  __device__ __forceinline__ void init() {
    m1 = m2 = m3 = INIT_NEG;
    a1 = a2 = 0;
  }

  // The Pallas chain for the value c of slice s.
  __device__ __forceinline__ void push(float c, int s) {
    const bool gt1 = c > m1;
    const bool gt2 = c > m2;
    m3 = fmaxf(m3, gt2 ? m2 : c);  // whatever drops to 3rd
    a2 = gt1 ? a1 : (gt2 ? s : a2);
    m2 = gt1 ? m1 : (gt2 ? c : m2);
    a1 = gt1 ? s : a1;
    m1 = gt1 ? c : m1;
  }
};

// Exact top-2 of two chains over disjoint slices (tools/exp_multiacc.py
// ::_merge_two): equal values keep the lower slice index.
__device__ __forceinline__ Top2 merge_two(const Top2& a, const Top2& b) {
  const bool w = (a.m1 > b.m1) || (a.m1 == b.m1 && a.a1 < b.a1);
  Top2 r;
  r.m1 = w ? a.m1 : b.m1;
  r.a1 = w ? a.a1 : b.a1;
  const float lo1 = w ? b.m1 : a.m1;
  const int lo1a = w ? b.a1 : a.a1;
  const float wm2 = w ? a.m2 : b.m2;
  const int wm2a = w ? a.a2 : b.a2;
  const bool w2 = (lo1 > wm2) || (lo1 == wm2 && lo1a < wm2a);
  r.m2 = w2 ? lo1 : wm2;
  r.a2 = w2 ? lo1a : wm2a;
  const float d2 = w2 ? wm2 : lo1;  // dropped 3rd of the four tops
  const float lm2 = w ? b.m2 : a.m2;  // the losing chain's 2nd, dropped too
  r.m3 = fmaxf(fmaxf(a.m3, b.m3), fmaxf(d2, lm2));
  return r;
}

// Insert (v, id) into the descending slots with a strict `>`; returns the
// value that falls off the end.
__device__ __forceinline__ float cascade(float (&rv)[SLOTS], int (&ri)[SLOTS],
                                         float v, int id) {
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const bool sw = v > rv[s];
    const float tv = rv[s];
    const int ti = ri[s];
    rv[s] = sw ? v : tv;
    ri[s] = sw ? id : ti;
    v = sw ? tv : v;
    id = sw ? ti : id;
  }
  return v;
}

// The end of an item block: the ghost takes m3, then m1 and m2 go into the
// slots and the ghost takes each eviction. lane_base is the block's first
// item id plus the lane class, so slice a holds item lane_base + a*128.
__device__ __forceinline__ void insert_block(float (&rv)[SLOTS],
                                             int (&ri)[SLOTS], float& gh,
                                             const Top2& t, int lane_base) {
  gh = fmaxf(gh, t.m3);
  gh = fmaxf(gh, cascade(rv, ri, t.m1, lane_base + t.a1 * LANES));
  gh = fmaxf(gh, cascade(rv, ri, t.m2, lane_base + t.a2 * LANES));
}

// Copy users [u0, u0 + tu) into shared memory laid out (d, tu), so one step
// j reads the tile's values of dimension j as a broadcast vector. Rows at or
// past n_users are zero.
__device__ __forceinline__ void load_users(float* su,
                                           const float* __restrict__ users,
                                           int u0, int tu, int n_users, int d,
                                           int tid, int nthreads) {
  for (int t = tid; t < tu * d; t += nthreads) {
    const int u = t / d;
    const int j = t - u * d;
    su[j * tu + u] =
        (u0 + u < n_users) ? users[(size_t)(u0 + u) * d + j] : 0.0f;
  }
}

// TU consecutive user values su[idx .. idx + TU), with idx a multiple of TU:
// float4 or float2 loads where TU allows.
template <int TU>
__device__ __forceinline__ void user_values(const float* su, int idx,
                                            float (&uu)[TU]) {
  if constexpr (TU % 4 == 0) {
#pragma unroll
    for (int q = 0; q < TU / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(su + idx)[q];
      uu[4 * q + 0] = v.x;
      uu[4 * q + 1] = v.y;
      uu[4 * q + 2] = v.z;
      uu[4 * q + 3] = v.w;
    }
  } else if constexpr (TU % 2 == 0) {
#pragma unroll
    for (int q = 0; q < TU / 2; ++q) {
      const float2 v = reinterpret_cast<const float2*>(su + idx)[q];
      uu[2 * q + 0] = v.x;
      uu[2 * q + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int u = 0; u < TU; ++u) uu[u] = su[idx + u];
  }
}

// Scores of users [ub, ub + TU) of a shared tile (d, tu) against one item
// whose values lie `stride` floats apart in device memory from `col`: FFMA
// chains in dimension order, starting from 0.
template <int TU>
__device__ __forceinline__ void dot_column(const float* __restrict__ col,
                                           size_t stride, const float* su,
                                           int tu, int ub, int d,
                                           float (&acc)[TU]) {
#pragma unroll
  for (int u = 0; u < TU; ++u) acc[u] = 0.0f;
#pragma unroll 8
  for (int j = 0; j < d; ++j) {
    const float x = __ldg(col + (size_t)j * stride);
    float uu[TU];
    user_values<TU>(su, j * tu + ub, uu);
#pragma unroll
    for (int u = 0; u < TU; ++u) acc[u] = fmaf(uu[u], x, acc[u]);
  }
}

// Write one user's slots and ghost for lane class c (column s*128 + c).
__device__ __forceinline__ void store_slots(float* __restrict__ cand_v,
                                            int* __restrict__ cand_i,
                                            float* __restrict__ ghost,
                                            size_t row, int c,
                                            const float (&rv)[SLOTS],
                                            const int (&ri)[SLOTS], float gh) {
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    cand_v[row * (SLOTS * LANES) + s * LANES + c] = rv[s];
    cand_i[row * (SLOTS * LANES) + s * LANES + c] = ri[s];
  }
  ghost[row * LANES + c] = gh;
}

// Opt a kernel in to `bytes` of dynamic shared memory where that is more
// than the default.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The block width's contract: a positive multiple of 128 dividing I_pad.
inline bool valid_blocks(int i_pad, int block_i) {
  return block_i > 0 && block_i % LANES == 0 && i_pad % block_i == 0;
}

// The running slots of a thread's (user, class) pairs on the shared tile
// (coldrec_tile::Shape S: pair (u, e) is user S::user(ug, u) and lane class
// S::item(ig, e)). The values and the ghost are read at every block end and
// stay in registers; the ids are only moved by the cascade, so they live in
// shared memory, SLOTS x S::RU x S::RI ints a thread, laid out so that the
// threads of a warp touch consecutive words.
template <class S>
struct TileSlots {
  static constexpr int RU = S::RU, RI = S::RI;
  // shared memory of the ids of a block
  static constexpr size_t ID_BYTES =
      sizeof(int) * SLOTS * RU * RI * (size_t)S::THREADS;
  float rv[RU][RI][SLOTS];
  float gh[RU][RI];
  int* ids;

  __device__ __forceinline__ int* id(int u, int e, int s) const {
    return ids + ((s * RU + u) * RI + e) * S::THREADS + threadIdx.x;
  }

  __device__ __forceinline__ void init(int* shared_ids) {
    ids = shared_ids;
#pragma unroll
    for (int u = 0; u < RU; ++u) {
#pragma unroll
      for (int e = 0; e < RI; ++e) {
        gh[u][e] = INIT_NEG;
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          rv[u][e][s] = INIT_NEG;
          *id(u, e, s) = 0;
        }
      }
    }
  }

  // insert_block for pair (u, e)
  __device__ __forceinline__ void insert(int u, int e, const Top2& t,
                                         int lane_base) {
    int ri[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) ri[s] = *id(u, e, s);
    insert_block(rv[u][e], ri, gh[u][e], t, lane_base);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) *id(u, e, s) = ri[s];
  }

  // slot `slot` of pair (u, e), with no dynamic register index
  __device__ __forceinline__ float value(int u, int e, int slot) const {
    float f = rv[u][e][0];
#pragma unroll
    for (int s = 1; s < SLOTS; ++s) f = (s == slot) ? rv[u][e][s] : f;
    return f;
  }

  // write pair (u, e) to row `row` of the outputs, lane class c
  __device__ __forceinline__ void store(float* __restrict__ cand_v,
                                        int* __restrict__ cand_i,
                                        float* __restrict__ ghost, size_t row,
                                        int u, int e, int c) const {
    int ri[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) ri[s] = *id(u, e, s);
    store_slots(cand_v, cand_i, ghost, row, c, rv[u][e], ri, gh[u][e]);
  }
};

// Where a block ends inside a step of the walk: the epilogues count the
// item groups left in the current block of block_i / 128 groups.
struct BlockClock {
  int slices;  // groups per block
  int left;  // groups of the current block still to come
  int base;  // first item id of the current block

  __device__ __forceinline__ void init(int block_i) {
    slices = block_i / LANES;
    left = slices;
    base = 0;
  }
  // the block-relative slice of the next group
  __device__ __forceinline__ int slice() const { return slices - left; }
  // count one group; true when it closed its block
  __device__ __forceinline__ bool tick() { return --left == 0; }
  __device__ __forceinline__ void next_block() {
    base += slices * LANES;
    left = slices;
  }
};

// Dynamic shared memory of a variant sweep on tile S at depth d: the walk's
// (users resident or staged step by step) and the ids of TileSlots, or 0
// where that exceeds what a block may use beside `static_bytes` of static
// shared memory.
template <class S, bool RESIDENT>
inline size_t tile_smem(int d, size_t static_bytes) {
  const size_t bytes =
      S::template smem_bytes<RESIDENT>(d) + TileSlots<S>::ID_BYTES;
  return bytes + static_bytes <= SMEM_MAX ? bytes : 0;
}

// The ids of TileSlots follow the walk's shared memory.
template <class S, bool RESIDENT>
__device__ __forceinline__ int* tile_ids(float* smem, int d) {
  return reinterpret_cast<int*>(
      smem + (RESIDENT ? S::TU * d : 0) +
      S::STAGES * S::template stage_floats<RESIDENT>());
}

}  // namespace coldrec_exp
