// Multi-accumulator streaming sweep for Hopper (sm_90a).
//
// Replaces the Pallas kernel tools/exp_multiacc.py::_multiacc_kernel (:72,
// with the merge _merge_two :49), launched by multiacc_sweep (:137,
// pallas_call :142). Contract as in stream_sweep_kernel
// (exp_retrieval_kernels.cu) plus P: inside each block of block_i items the
// item slices feed P independent top-2 chains, and once per block the P
// chains are merged pairwise ((0,1), (2,3), ... then the pairs' results, as
// the Pallas kernel's list reduction does) with merge_two, which keeps the
// lower slice on a tie; then m1 and m2 cascade into the 8 slots with the
// TPU's strict `>`. The merge is exact for any split of a block's slices
// into chains, each fed in increasing slice order, so the result is bit for
// bit the single chain's (P = 1) and stream_sweep_kernel's. Here group g
// (items g*128 .. g*128+127) feeds chain g % P, which is the Pallas
// kernel's block-relative slice % P whenever block_i / 128 is a multiple of
// P (every timed shape), and keeps the chain index a compile-time constant.
//
// What bounds it on an H100: the products, as for the stream sweep: at
// B=2048, I_pad=270,336, d=64, 7.09e10 fp32 operations (1.058 ms at
// 67 TFLOP/s) against ~88 MB of compulsory traffic (26 us at 3.35 TB/s).
//
// Design: the product loop of sweep_tile.cuh (the user tile resident in
// shared memory, or staged beside the items where d is too wide for it,
// item groups staged by cp.async, a register tile per thread), the one
// retrieval.cu's sweep runs on. Each thread owns its
// (user, class) pairs for the whole walk: P chains (5P registers), the 8
// slot values and the ghost in registers, the 8 slot ids in shared memory
// (TileSlots: the ids move only at block ends). A block end may fall inside
// a step (block_i 256 closes a block every 2 groups of an 8-group step):
// the epilogue counts groups (BlockClock) and closes the block after the
// group that ends it. The item range is not split: the strict cascade is
// not a stable merge, so parts could not be merged bit for bit; the
// parallelism comes from the users. The register tile shrinks where P
// grows (MultiShape below; the build's -Xptxas -v report shows registers
// and spills of each instance).
#include "sweep_common.cuh"
#include "sweep_tile.cuh"

namespace {

using namespace coldrec_exp;
namespace tile = coldrec_tile;

// The tile of each P: users per block, and per thread RU users x RI items
// of each of GS groups (GS a multiple of P, so group q of a step feeds
// chain q % P).
using MultiP1 = tile::Shape<16, 8, 1, 32, 8, 16, 2>;
using MultiP2 = tile::Shape<16, 8, 1, 32, 4, 16, 3>;
using MultiP4 = tile::Shape<8, 4, 1, 32, 8, 16, 2>;
using MultiP8 = tile::Shape<4, 2, 1, 32, 8, 16, 2>;

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

template <class S, int P>
struct MultiEpilogue {
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
                                       const tile::Acc<S>& acc) {
#pragma unroll
    for (int q = 0; q < GS; ++q) {
      if (q >= n) break;
      const int s = clock.slice();
#pragma unroll
      for (int u = 0; u < RU; ++u) {
#pragma unroll
        for (int e = 0; e < RI; ++e) {
          t[u][e][q % P].push(ex[q][e] ? NEG : acc[q][u][e], s);
        }
      }
      if (clock.tick()) close();
    }
  }
};

template <class S, int P, int LAYOUT, bool RESIDENT>
__global__ void __launch_bounds__(S::THREADS, 1)
multiacc_sweep_kernel(const float* __restrict__ users,
                      const float* __restrict__ items_t,
                      const int8_t* __restrict__ excl,
                      float* __restrict__ cand_v, int* __restrict__ cand_i,
                      float* __restrict__ ghost, int n_users, int d,
                      int i_pad, int block_i) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const tile::Tile tl{users, items_t, n_users, d, i_pad,
                      (int)blockIdx.x * S::TU};
  MultiEpilogue<S, P> epi;
  epi.excl = excl;
  epi.ig = S::ig();
  epi.clock.init(block_i);
  epi.slots.init(tile_ids<S, RESIDENT>(smem, d));
  epi.init_chains();
  tile::sweep_walk<S, LAYOUT, RESIDENT>(tl, 0, i_pad / LANES, smem, epi);

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

template <class S, int P, int LAYOUT, bool RESIDENT>
int launch_multiacc(const float* users, const float* items_t,
                    const int8_t* excl, float* cand_v, int* cand_i,
                    float* ghost, int n_users, int d, int i_pad, int block_i,
                    cudaStream_t stream) {
  const size_t smem = tile_smem<S, RESIDENT>(d, 0);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  auto* kernel = multiacc_sweep_kernel<S, P, LAYOUT, RESIDENT>;
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
template <int P, int LAYOUT>
int launch_multiacc(const float* users, const float* items_t,
                    const int8_t* excl, float* cand_v, int* cand_i,
                    float* ghost, int n_users, int d, int i_pad, int block_i,
                    cudaStream_t stream) {
  using S = typename MultiShape<P>::S;
  using Staged = typename MultiShape<P == 1 ? 2 : P>::S;
  return tile_smem<S, true>(d, 0) != 0
             ? launch_multiacc<S, P, LAYOUT, true>(users, items_t, excl,
                                                   cand_v, cand_i, ghost,
                                                   n_users, d, i_pad,
                                                   block_i, stream)
             : launch_multiacc<Staged, P, LAYOUT, false>(
                   users, items_t, excl, cand_v, cand_i, ghost, n_users, d,
                   i_pad, block_i, stream);
}

template <int P>
int launch_multiacc(const float* users, const float* items_t,
                    const int8_t* excl, float* cand_v, int* cand_i,
                    float* ghost, int n_users, int d, int i_pad, int block_i,
                    cudaStream_t stream) {
  return reinterpret_cast<uintptr_t>(items_t) % 16 == 0
             ? launch_multiacc<P, tile::kRows16>(users, items_t, excl,
                                                 cand_v, cand_i, ghost,
                                                 n_users, d, i_pad, block_i,
                                                 stream)
             : launch_multiacc<P, tile::kRows4>(users, items_t, excl, cand_v,
                                                cand_i, ghost, n_users, d,
                                                i_pad, block_i, stream);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream), allocates nothing, does
// not synchronise, and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments outside the contract: P is one of
// 1, 2, 4, 8; d is any positive depth).
extern "C" int coldrec_multiacc_sweep(const void* users, const void* items_t,
                                      const void* excl, void* cand_v,
                                      void* cand_i, void* ghost, int n_users,
                                      int d, int i_pad, int block_i,
                                      int p_acc, void* stream) {
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
  switch (p_acc) {
    case 1:
      return launch_multiacc<1>(u, it, ex, cv, ci, gh, n_users, d, i_pad,
                                block_i, s);
    case 2:
      return launch_multiacc<2>(u, it, ex, cv, ci, gh, n_users, d, i_pad,
                                block_i, s);
    case 4:
      return launch_multiacc<4>(u, it, ex, cv, ci, gh, n_users, d, i_pad,
                                block_i, s);
    case 8:
      return launch_multiacc<8>(u, it, ex, cv, ci, gh, n_users, d, i_pad,
                                block_i, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
