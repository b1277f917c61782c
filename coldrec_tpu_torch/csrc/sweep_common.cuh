// Device code shared by the kernel-variant sweeps (exp_retrieval_kernels.cu,
// exp_multiacc.cu, exp_blockskip.cu): the TPU kernels' block-local top-2
// chains, their merge of two such chains, the sorted 8-slot insertion
// cascade, the running slots of the sweeps that walk the shared tile of
// sweep_tile.cuh, and the chain sweep that stream_sweep and multiacc_sweep
// both run (ChainEpilogue, chain_sweep_kernel, launch_chain).
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
// And each keeps NaN as its own Pallas kernel's arithmetic does (`>` and
// `==` on NaN are false there as here; jnp.maximum and jnp.minimum are
// max.NaN and min.NaN):
//   - StreamChain (_stream_kernel, _skip_kernel: `where`, m3 by maximum):
//     a NaN never enters m1 or m2 and turns m3 NaN;
//   - MaxChain (_multiacc_kernel: maximum/minimum): a NaN turns m1, m2 and
//     m3 NaN for the rest of the block;
//   - merge_two's m3 and the ghost fold with max.NaN, so a NaN m3, and a
//     NaN m1 that the cascade drops, make the ghost NaN for good.
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

using coldrec_tile::fmax_nan;
using coldrec_tile::fmin_nan;

// One lane class's top-2 over the slices of one item block: values m1 >= m2
// at slice indices a1, a2, and m3, the largest value dropped.
struct Top2 {
  float m1, m2, m3;
  int a1, a2;

  __device__ __forceinline__ void init() {
    m1 = m2 = m3 = INIT_NEG;
    a1 = a2 = 0;
  }
};

// The stream chain (tools/exp_retrieval_kernels.py::_stream_kernel :108-117,
// and _skip_kernel's) for the value c of slice s.
struct StreamChain {
  __device__ __forceinline__ static void push(Top2& t, float c, int s) {
    const bool gt1 = c > t.m1;
    const bool gt2 = c > t.m2;
    t.m3 = fmax_nan(t.m3, gt2 ? t.m2 : c);  // whatever drops to 3rd
    t.a2 = gt1 ? t.a1 : (gt2 ? s : t.a2);
    t.m2 = gt1 ? t.m1 : (gt2 ? c : t.m2);
    t.a1 = gt1 ? s : t.a1;
    t.m1 = gt1 ? c : t.m1;
  }
};

// The multiacc chain (tools/exp_multiacc.py::_multiacc_kernel :96-102):
// the stream chain's values on finite scores, written with maximum and
// minimum.
struct MaxChain {
  __device__ __forceinline__ static void push(Top2& t, float c, int s) {
    const bool gt1 = c > t.m1;
    const bool gt2 = c > t.m2;
    t.m3 = fmax_nan(t.m3, fmin_nan(c, t.m2));
    t.a2 = gt1 ? t.a1 : (gt2 ? s : t.a2);
    t.m2 = gt1 ? t.m1 : fmax_nan(c, t.m2);
    t.a1 = gt1 ? s : t.a1;
    t.m1 = fmax_nan(c, t.m1);
  }
};

// Exact top-2 of two chains over disjoint slices (tools/exp_multiacc.py
// ::_merge_two): equal values keep the lower slice index. On a NaN m1 it
// is not symmetric: b wins (a NaN in b wins, a NaN in a loses).
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
  r.m3 = fmax_nan(fmax_nan(a.m3, b.m3), fmax_nan(d2, lm2));
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
  gh = fmax_nan(gh, t.m3);
  gh = fmax_nan(gh, cascade(rv, ri, t.m1, lane_base + t.a1 * LANES));
  gh = fmax_nan(gh, cascade(rv, ri, t.m2, lane_base + t.a2 * LANES));
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

// ---- The chain sweep: stream_sweep (P = 1, StreamChain) and
// multiacc_sweep (P chains of MaxChain) on the shared tile.

// The tile of each P: users per block, and per thread RU users x RI items
// of each of GS groups (GS a multiple of P, so group q of a step feeds
// chain q % P).
using MultiP1 = coldrec_tile::Shape<16, 8, 1, 32, 8, 16, 2>;
using MultiP2 = coldrec_tile::Shape<16, 8, 1, 32, 4, 16, 3>;
using MultiP4 = coldrec_tile::Shape<8, 4, 1, 32, 8, 16, 2>;
using MultiP8 = coldrec_tile::Shape<4, 2, 1, 32, 8, 16, 2>;

template <int P>
struct MultiShape;
template <>
struct MultiShape<1> {
  using S = MultiP1;
};
template <>
struct MultiShape<2> {
  using S = MultiP2;
};
template <>
struct MultiShape<4> {
  using S = MultiP4;
};
template <>
struct MultiShape<8> {
  using S = MultiP8;
};

// t[i] takes t[(i + off) % P]: log2(P) rotations by compile-time register
// moves, each taken or not by the whole block at once.
template <int P>
__device__ __forceinline__ void rotate(Top2 (&t)[P], int off) {
#pragma unroll
  for (int sh = 1; sh < P; sh *= 2) {
    if (off & sh) {
      Top2 r[P];
#pragma unroll
      for (int i = 0; i < P; ++i) r[i] = t[(i + sh) % P];
#pragma unroll
      for (int i = 0; i < P; ++i) t[i] = r[i];
    }
  }
}

// Each thread's (user, class) pairs feed P chains per item block. The
// Pallas kernel feeds slice s of a block (block-relative) to chain s % P;
// here group g of the walk feeds register chain g % P, a compile-time
// index (a step starts at a multiple of GS, itself a multiple of P). At a
// block end the register chains are rotated by the block's first group mod
// P (0 whenever block_i / 128 is a multiple of P), so chain i holds the
// slices s with s % P == i, as in the Pallas kernel; then they are merged
// pairwise as its list reduction does ((0, 1), (2, 3), ..., then the
// pairs' results), and m1 and m2 cascade into the slots. Without NaN
// neither the split nor the order changes a bit; with NaN both do, as in
// JAX.
template <class S, int P, class Chain>
struct ChainEpilogue {
  static constexpr int RU = S::RU, RI = S::RI, GS = S::GS;
  static_assert(GS % P == 0, "group q of a step feeds chain q % P");
  const int8_t* __restrict__ excl;
  int ig;
  BlockClock clock;
  TileSlots<S> slots;
  Top2 t[RU][RI][P];
  int8_t ex[GS][RI];

  __device__ __forceinline__ void init_chains() {
#pragma unroll
    for (int u = 0; u < RU; ++u) {
#pragma unroll
      for (int e = 0; e < RI; ++e) {
#pragma unroll
        for (int p = 0; p < P; ++p) t[u][e][p].init();
      }
    }
  }

  __device__ __forceinline__ void begin(int q, int g) {
#pragma unroll
    for (int e = 0; e < RI; ++e) {
      ex[q][e] = __ldg(excl + g * LANES + S::item(ig, e));
    }
  }

  // merge each pair's P chains and cascade the block's top-2
  __device__ __forceinline__ void close() {
    // one branch around every rotation: predicated inside the merge loop,
    // the moves slowed P = 4 by 8% at block_i 8192 on an H100, where they
    // are never taken
    const int off = (clock.base / LANES) % P;
    if (off != 0) {
#pragma unroll
      for (int u = 0; u < RU; ++u) {
#pragma unroll
        for (int e = 0; e < RI; ++e) rotate<P>(t[u][e], off);
      }
    }
#pragma unroll
    for (int u = 0; u < RU; ++u) {
#pragma unroll
      for (int e = 0; e < RI; ++e) {
#pragma unroll
        for (int step = 1; step < P; step *= 2) {
#pragma unroll
          for (int q = 0; q + step < P; q += 2 * step) {
            t[u][e][q] = merge_two(t[u][e][q], t[u][e][q + step]);
          }
        }
        slots.insert(u, e, t[u][e][0], clock.base + S::item(ig, e));
      }
    }
    init_chains();
    clock.next_block();
  }

  __device__ __forceinline__ void step(int, int n,
                                       const coldrec_tile::Acc<S>& acc) {
#pragma unroll
    for (int q = 0; q < GS; ++q) {
      if (q >= n) break;
      const int s = clock.slice();
#pragma unroll
      for (int u = 0; u < RU; ++u) {
#pragma unroll
        for (int e = 0; e < RI; ++e) {
          Chain::push(t[u][e][q % P], ex[q][e] ? NEG : acc[q][u][e], s);
        }
      }
      if (clock.tick()) close();
    }
  }
};

// Block: a tile of S::TU users over the whole item range (not split: the
// strict cascade is not a stable merge, so parts could not be merged bit
// for bit). Writes the tile's rows of cand_v, cand_i and ghost.
template <class S, int P, class Chain, int LAYOUT, bool RESIDENT>
__global__ void __launch_bounds__(S::THREADS, 1)
chain_sweep_kernel(const float* __restrict__ users,
                   const float* __restrict__ items_t,
                   const int8_t* __restrict__ excl,
                   float* __restrict__ cand_v, int* __restrict__ cand_i,
                   float* __restrict__ ghost, int n_users, int d, int i_pad,
                   int block_i) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const coldrec_tile::Tile tl{users, items_t, n_users, d, i_pad,
                              (int)blockIdx.x * S::TU};
  ChainEpilogue<S, P, Chain> epi;
  epi.excl = excl;
  epi.ig = S::ig();
  epi.clock.init(block_i);
  epi.slots.init(tile_ids<S, RESIDENT>(smem, d));
  epi.init_chains();
  coldrec_tile::sweep_walk<S, LAYOUT, RESIDENT>(tl, 0, i_pad / LANES, smem,
                                                epi);

  const int ug = S::ug();
#pragma unroll
  for (int u = 0; u < S::RU; ++u) {
    const int user = tl.u0 + S::user(ug, u);
    if (user >= n_users) continue;
#pragma unroll
    for (int e = 0; e < S::RI; ++e) {
      epi.slots.store(cand_v, cand_i, ghost, (size_t)user, u, e,
                      S::item(epi.ig, e));
    }
  }
}

template <class S, int P, class Chain, int LAYOUT, bool RESIDENT>
int launch_chain(const float* users, const float* items_t,
                 const int8_t* excl, float* cand_v, int* cand_i, float* ghost,
                 int n_users, int d, int i_pad, int block_i,
                 cudaStream_t stream) {
  const size_t smem = tile_smem<S, RESIDENT>(d, 0);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  auto* kernel = chain_sweep_kernel<S, P, Chain, LAYOUT, RESIDENT>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n_users + S::TU - 1) / S::TU);
  kernel<<<grid, S::THREADS, smem, stream>>>(users, items_t, excl, cand_v,
                                             cand_i, ghost, n_users, d,
                                             i_pad, block_i);
  return (int)cudaGetLastError();
}

// The users stay resident where their tile fits in shared memory beside
// the ring and the ids, and are staged step by step at wider d. Staged,
// P = 1 takes the tile of P = 2: with P = 1's 8-group step the staging's
// addresses spill.
template <int P, class Chain, int LAYOUT>
int launch_chain(const float* users, const float* items_t,
                 const int8_t* excl, float* cand_v, int* cand_i, float* ghost,
                 int n_users, int d, int i_pad, int block_i,
                 cudaStream_t stream) {
  using S = typename MultiShape<P>::S;
  using Staged = typename MultiShape<P == 1 ? 2 : P>::S;
  return tile_smem<S, true>(d, 0) != 0
             ? launch_chain<S, P, Chain, LAYOUT, true>(
                   users, items_t, excl, cand_v, cand_i, ghost, n_users, d,
                   i_pad, block_i, stream)
             : launch_chain<Staged, P, Chain, LAYOUT, false>(
                   users, items_t, excl, cand_v, cand_i, ghost, n_users, d,
                   i_pad, block_i, stream);
}

// The chain sweep of P chains of Chain on `stream` (the contract of
// coldrec_stream_sweep and coldrec_multiacc_sweep): allocates nothing,
// does not synchronise, returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments outside the contract).
template <int P, class Chain>
int launch_chain(const void* users, const void* items_t, const void* excl,
                 void* cand_v, void* cand_i, void* ghost, int n_users, int d,
                 int i_pad, int block_i, void* stream) {
  if (d <= 0 || !valid_blocks(i_pad, block_i)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_users <= 0) return (int)cudaSuccess;
  const float* u = static_cast<const float*>(users);
  const float* it = static_cast<const float*>(items_t);
  const int8_t* ex = static_cast<const int8_t*>(excl);
  float* cv = static_cast<float*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  float* gh = static_cast<float*>(ghost);
  const cudaStream_t s = (cudaStream_t)stream;
  return reinterpret_cast<uintptr_t>(items_t) % 16 == 0
             ? launch_chain<P, Chain, coldrec_tile::kRows16>(
                   u, it, ex, cv, ci, gh, n_users, d, i_pad, block_i, s)
             : launch_chain<P, Chain, coldrec_tile::kRows4>(
                   u, it, ex, cv, ci, gh, n_users, d, i_pad, block_i, s);
}

}  // namespace coldrec_exp
