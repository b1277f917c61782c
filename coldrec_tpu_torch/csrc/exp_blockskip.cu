// Block-skip streaming sweep for Hopper (sm_90a).
//
// Replaces the Pallas kernel tools/exp_blockskip.py::_skip_kernel (:57),
// launched by _skip_sweep (:126, pallas_call :132). Contract as in
// coldrec_stream_sweep (exp_retrieval_kernels.cu; the stream chain, so a
// NaN score turns its class's ghost NaN), over users padded to a
// multiple of tile_u (pad rows take part), plus, at each block of block_i
// items, for every user u of a tile:
//   - bmax[u] = the block's max score (excluded items score NEG; NaN if a
//     score is NaN, as torch's amax gives) and floor[u] = min over lane
//     classes of slot floor_slot of u before the block (INIT_NEG until
//     every class has filled that slot);
//   - if bmax[u] < floor[u] for EVERY user of the tile, the block is
//     skipped: the block's top-2 is dropped, the ghost of every lane class
//     takes bmax[u] (a NaN ghost stays NaN), and the tile's counter
//     skips[tile] goes up by one;
//   - otherwise the block's top-2 goes through the stream sweep's cascade.
// tile_u changes the result (the predicate is over the whole tile).
//
// What bounds it on an H100: the products, as for the stream sweep (the
// block max needs every score, so a skip saves only the cascade): at
// B=2048, I_pad=270,336, d=64, 7.09e10 fp32 operations (1.058 ms at
// 67 TFLOP/s) against ~88 MB of compulsory traffic.
//
// Design. The TPU kernel decides first and then extracts; here the top-2
// chain of a (user, class) pair needs only the block's scores, so the
// block is scored once: the product loop of sweep_tile.cuh (users resident
// in shared memory, item groups staged by cp.async, a register tile per
// thread) feeds each pair's chain, whose m1 is the pair's block max (a
// per-thread bit per user records a NaN score). At the block's end the
// block maxima and the floors are reduced per user over the 128 classes
// (warp shuffles, then shared memory across the warps), the tile decides,
// and each pair either raises its ghost to bmax[u] or cascades its top-2.
// The slot values, ghosts and chains stay in registers, the slot ids in
// shared memory (TileSlots); the outputs are written once, at the end.
//
// The CTA tile is TU users (16; 32 for tiles of more than 256 users).
// The host chooses the layout (coldrec_tpu_torch/tools/exp_blockskip.py
// ::skip_layout):
//   - tile_u <= TU: a CTA holds TU / tile_u whole tiles (cta_users rows)
//     and decides each in shared memory;
//   - tile_u > TU: a tile spans a thread-block cluster of
//     ceil(tile_u / TU) CTAs (4 at tile_u 64, 16 at 256), rank r holding
//     rows r*TU .. of the tile. Each CTA reduces its own rows' predicate
//     and writes one flag into the leader CTA's shared memory (distributed
//     shared memory, double-buffered by block parity); one cluster.sync()
//     per item block, and every CTA reads the same decision. Clusters of
//     more than 8 CTAs are non-portable (opted in per kernel).
// Where d is too wide for the resident user tile (above 544 at TU = 16),
// each step stages the users' chunk beside the items'. A layout the card
// refuses (a cluster of more than 16) returns its error, and the wrapper
// raises.
#include <cooperative_groups.h>

#include "sweep_common.cuh"
#include "sweep_tile.cuh"

namespace {

using namespace coldrec_exp;
namespace tile = coldrec_tile;
namespace cg = cooperative_groups;

// per thread 8 users x 1 class of each of 8 groups (256 threads), the
// production sweep's tile
using SkipT16 = tile::Shape<16, 8, 1, 32, 8, 16, 2>;
// tiles of more than 256 users: 16 users x 1 class of 2 groups a thread
using SkipT32 = tile::Shape<32, 16, 1, 32, 2, 16, 2>;
constexpr int MAX_CLUSTER = 16;

// shared memory of the block-end reductions
template <class S>
struct SkipShared {
  static constexpr int WI = S::WI;
  float red_max[WI][S::TU];
  float red_min[WI][S::TU];
  float bmax[S::TU];
  int dom[S::TU];
  int flag[S::TU];  // per local tile (at most TU / 4 of them)
  int skips[S::TU];
  int cflags[2][MAX_CLUSTER];  // the leader's: one flag per rank
};

template <class S>
struct SkipEpilogue {
  static constexpr int RU = S::RU, RI = S::RI, GS = S::GS;
  static_assert(RU <= 32, "one NaN bit per user");
  const int8_t* __restrict__ excl;
  SkipShared<S>* sh;
  int ig, ug;
  int rows;  // the CTA's rows (users of its tiles)
  int tl;  // rows per local tile: tile_u, or TU in a cluster
  int ntiles;  // local tiles
  int cluster;  // CTAs per tile (1: tiles per CTA)
  int floor_slot;
  int parity;
  unsigned nan_bits;  // bit u: user u scored NaN in this block
  BlockClock clock;
  TileSlots<S> slots;
  Top2 t[RU][RI];
  int8_t ex[GS][RI];

  __device__ __forceinline__ void init_chains() {
#pragma unroll
    for (int u = 0; u < RU; ++u) {
#pragma unroll
      for (int e = 0; e < RI; ++e) t[u][e].init();
    }
    nan_bits = 0u;
  }

  __device__ __forceinline__ void begin(int q, int g) {
#pragma unroll
    for (int e = 0; e < RI; ++e) {
      ex[q][e] = __ldg(excl + g * LANES + S::item(ig, e));
    }
  }

  // decide the block for every local tile; every thread of the CTA (of
  // every CTA of the cluster) calls it at the same block end
  __device__ __forceinline__ void decide() {
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int wi = (tid >> 5) % S::WI;
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      float m = INIT_NEG;
      float f = -INIT_NEG;
#pragma unroll
      for (int e = 0; e < RI; ++e) {
        m = fmaxf(m, t[u][e].m1);  // the pair's block max (m1 is no NaN)
        f = fminf(f, slots.value(u, e, floor_slot));
      }
      if ((nan_bits >> u) & 1u) m = __int_as_float(0x7fffffff);
#pragma unroll
      for (int o = S::LI / 2; o > 0; o >>= 1) {
        m = tile::fmax_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
        f = fminf(f, __shfl_xor_sync(0xffffffffu, f, o));
      }
      if (lane % S::LI == 0) {
        sh->red_max[wi][S::user(ug, u)] = m;
        sh->red_min[wi][S::user(ug, u)] = f;
      }
    }
    __syncthreads();
    if (tid < S::TU) {
      float m = sh->red_max[0][tid];
      float f = sh->red_min[0][tid];
#pragma unroll
      for (int w = 1; w < S::WI; ++w) {
        m = tile::fmax_nan(m, sh->red_max[w][tid]);
        f = fminf(f, sh->red_min[w][tid]);
      }
      sh->bmax[tid] = m;
      sh->dom[tid] = tid >= rows || m < f;  // NaN: never dominated
    }
    __syncthreads();
    if (tid < ntiles) {
      int all = 1;
      const int hi = min(rows, (tid + 1) * tl);
      for (int r = tid * tl; r < hi; ++r) all &= sh->dom[r];
      sh->flag[tid] = all;
    }
    if (cluster > 1) {
      cg::cluster_group cl = cg::this_cluster();
      const int rank = (int)cl.block_rank();
      if (tid == 0) {
        *cl.map_shared_rank(&sh->cflags[parity][rank], 0) = sh->flag[0];
      }
      cl.sync();
      if (tid == 0) {
        int all = 1;
        for (int r = 0; r < cluster; ++r) {
          all &= *cl.map_shared_rank(&sh->cflags[parity][r], 0);
        }
        sh->flag[0] = all;
      }
      parity ^= 1;
    }
    if (tid < ntiles) sh->skips[tid] += sh->flag[tid];
    __syncthreads();
  }

  __device__ __forceinline__ void close() {
    decide();
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      const int row = S::user(ug, u);
      const bool skip = sh->flag[row / tl] != 0;
      const float bm = sh->bmax[row];
#pragma unroll
      for (int e = 0; e < RI; ++e) {
        if (skip) {
          slots.gh[u][e] = fmax_nan(slots.gh[u][e], bm);  // NaN sticks
        } else {
          slots.insert(u, e, t[u][e], clock.base + S::item(ig, e));
        }
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
          const float v = ex[q][e] ? NEG : acc[q][u][e];
          if (v != v) nan_bits |= 1u << u;
          StreamChain::push(t[u][e], v, s);
        }
      }
      if (clock.tick()) close();
    }
  }
};

template <class S, int LAYOUT, bool RESIDENT>
__global__ void __launch_bounds__(S::THREADS, 1)
skip_sweep_kernel(const float* __restrict__ users,
                  const float* __restrict__ items_t,
                  const int8_t* __restrict__ excl, float* __restrict__ cand_v,
                  int* __restrict__ cand_i, float* __restrict__ ghost,
                  int* __restrict__ skips, int b_pad, int d, int i_pad,
                  int block_i, int tile_u, int floor_slot, int cta_users,
                  int cluster) {
  extern __shared__ float4 smem4[];
  __shared__ SkipShared<S> sh;
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  int u0, rows;
  if (cluster == 1) {
    u0 = (int)blockIdx.x * cta_users;
    rows = min(cta_users, b_pad - u0);
  } else {
    const int r = (int)blockIdx.x % cluster;
    u0 = (int)blockIdx.x / cluster * tile_u + r * S::TU;
    rows = min(S::TU, tile_u - r * S::TU);
  }
  // rows past the CTA's own load as zeros and are never written
  const tile::Tile tl{users, items_t, u0 + rows, d, i_pad, u0};
  SkipEpilogue<S> epi;
  epi.excl = excl;
  epi.sh = &sh;
  epi.ig = S::ig();
  epi.ug = S::ug();
  epi.rows = rows;
  epi.tl = cluster == 1 ? tile_u : S::TU;
  epi.ntiles = (rows + epi.tl - 1) / epi.tl;
  epi.cluster = cluster;
  epi.floor_slot = floor_slot;
  epi.parity = 0;
  epi.clock.init(block_i);
  epi.slots.init(tile_ids<S, RESIDENT>(smem, d));
  epi.init_chains();
  if (tid < S::TU) sh.skips[tid] = 0;
  if (cluster > 1) cg::this_cluster().sync();  // every CTA has started
  tile::sweep_walk<S, LAYOUT, RESIDENT>(tl, 0, i_pad / LANES, smem, epi);

#pragma unroll
  for (int u = 0; u < S::RU; ++u) {
    const int row = S::user(epi.ug, u);
    if (row >= rows) continue;
#pragma unroll
    for (int e = 0; e < S::RI; ++e) {
      epi.slots.store(cand_v, cand_i, ghost, (size_t)(u0 + row), u, e,
                      S::item(epi.ig, e));
    }
  }
  if (cluster == 1) {
    if (tid < epi.ntiles) skips[u0 / tile_u + tid] = sh.skips[tid];
  } else {
    if (blockIdx.x % cluster == 0 && tid == 0) {
      skips[blockIdx.x / cluster] = sh.skips[0];
    }
    cg::this_cluster().sync();  // the leader's flags outlive every read
  }
}

// The users stay resident where their tile fits in shared memory beside
// the ring, the ids and the reductions, and are staged step by step at
// wider d.
template <class S>
bool skip_resident(int d) {
  return tile_smem<S, true>(d, sizeof(SkipShared<S>)) != 0;
}

template <class S, int LAYOUT, bool RESIDENT>
cudaError_t skip_config(int n_ctas, int cluster, int d, size_t* smem,
                        cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  *smem = tile_smem<S, RESIDENT>(d, sizeof(SkipShared<S>));
  if (*smem == 0) return cudaErrorInvalidValue;
  auto* kernel = skip_sweep_kernel<S, LAYOUT, RESIDENT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (e != cudaSuccess) return e;
  if (cluster > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(n_ctas);
  cfg->blockDim = dim3(S::THREADS);
  cfg->dynamicSmemBytes = *smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <class S, int LAYOUT, bool RESIDENT>
int launch_skip(const float* users, const float* items_t, const int8_t* excl,
                float* cand_v, int* cand_i, float* ghost, int* skips,
                int b_pad, int d, int i_pad, int block_i, int tile_u,
                int floor_slot, int cta_users, int cluster, int n_ctas,
                cudaStream_t stream) {
  size_t smem = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = skip_config<S, LAYOUT, RESIDENT>(n_ctas, cluster, d, &smem,
                                                   &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  cfg.stream = stream;
  e = cudaLaunchKernelEx(&cfg, skip_sweep_kernel<S, LAYOUT, RESIDENT>, users,
                         items_t, excl, cand_v, cand_i, ghost, skips, b_pad,
                         d, i_pad, block_i, tile_u, floor_slot, cta_users,
                         cluster);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <class S, int LAYOUT>
int launch_skip(const float* users, const float* items_t, const int8_t* excl,
                float* cand_v, int* cand_i, float* ghost, int* skips,
                int b_pad, int d, int i_pad, int block_i, int tile_u,
                int floor_slot, int cta_users, int cluster, int n_ctas,
                cudaStream_t stream) {
  return skip_resident<S>(d)
             ? launch_skip<S, LAYOUT, true>(users, items_t, excl, cand_v,
                                            cand_i, ghost, skips, b_pad, d,
                                            i_pad, block_i, tile_u,
                                            floor_slot, cta_users, cluster,
                                            n_ctas, stream)
             : launch_skip<S, LAYOUT, false>(users, items_t, excl, cand_v,
                                             cand_i, ghost, skips, b_pad, d,
                                             i_pad, block_i, tile_u,
                                             floor_slot, cta_users, cluster,
                                             n_ctas, stream);
}

template <class S>
int launch_skip(const void* users, const void* items_t, const void* excl,
                void* cand_v, void* cand_i, void* ghost, void* skips,
                int b_pad, int d, int i_pad, int block_i, int tile_u,
                int floor_slot, int cta_users, int cluster, int n_ctas,
                cudaStream_t stream) {
  const float* u = static_cast<const float*>(users);
  const float* it = static_cast<const float*>(items_t);
  const int8_t* ex = static_cast<const int8_t*>(excl);
  float* cv = static_cast<float*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  float* gh = static_cast<float*>(ghost);
  int* sk = static_cast<int*>(skips);
  if (reinterpret_cast<uintptr_t>(items_t) % 16 == 0) {
    return launch_skip<S, tile::kRows16>(u, it, ex, cv, ci, gh, sk, b_pad, d,
                                         i_pad, block_i, tile_u, floor_slot,
                                         cta_users, cluster, n_ctas, stream);
  }
  return launch_skip<S, tile::kRows4>(u, it, ex, cv, ci, gh, sk, b_pad, d,
                                      i_pad, block_i, tile_u, floor_slot,
                                      cta_users, cluster, n_ctas, stream);
}

// The layout's contract (see the header); the number of CTAs, or 0.
int skip_ctas(int b_pad, int tile_u, int cta_tile, int cta_users,
              int cluster) {
  if (cluster == 1) {
    if (cta_users <= 0 || cta_users > cta_tile || cta_users % tile_u) {
      return 0;
    }
    return (b_pad + cta_users - 1) / cta_users;
  }
  if (tile_u <= cta_tile || cluster != (tile_u + cta_tile - 1) / cta_tile) {
    return 0;
  }
  return b_pad / tile_u * cluster;
}

// How many clusters of `cluster` CTAs of the tile S kernel (16-byte aligned
// items, users resident or staged as a launch at depth d takes them) can be
// resident at once (cudaOccupancyMaxActiveClusters), or -1 on a CUDA error.
template <class S, bool RESIDENT>
int skip_max_clusters(int d, int cluster) {
  size_t smem = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int n = -1;
  cudaError_t e = skip_config<S, tile::kRows16, RESIDENT>(cluster, cluster, d,
                                                          &smem, &cfg, &attr);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveClusters(
        &n, skip_sweep_kernel<S, tile::kRows16, RESIDENT>, &cfg);
  }
  return e == cudaSuccess ? n : -1;
}

template <class S>
int skip_max_clusters(int d, int cluster) {
  return skip_resident<S>(d) ? skip_max_clusters<S, true>(d, cluster)
                             : skip_max_clusters<S, false>(d, cluster);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream), allocates nothing, does
// not synchronise, and returns the launch's error (cudaErrorInvalidValue
// for arguments outside the contract, cudaErrorInvalidClusterSize for a
// cluster of more than 16). b_pad is a multiple of tile_u, tile_u a
// multiple of 4; cand_v, cand_i and ghost have b_pad rows and skips
// b_pad / tile_u entries. cta_tile (16 or 32), cta_users and cluster are
// the layout of skip_layout.
extern "C" int coldrec_skip_sweep(const void* users, const void* items_t,
                                  const void* excl, void* cand_v,
                                  void* cand_i, void* ghost, void* skips,
                                  int b_pad, int d, int i_pad, int block_i,
                                  int tile_u, int floor_slot, int cta_tile,
                                  int cta_users, int cluster, void* stream) {
  if (d <= 0 || !valid_blocks(i_pad, block_i) || tile_u <= 0 ||
      tile_u % 4 || b_pad % tile_u || floor_slot < 0 ||
      floor_slot >= SLOTS || cluster < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (cluster > MAX_CLUSTER) return (int)cudaErrorInvalidClusterSize;
  if (b_pad <= 0) return (int)cudaSuccess;
  const int n_ctas = skip_ctas(b_pad, tile_u, cta_tile, cta_users, cluster);
  if (n_ctas <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (cta_tile == SkipT16::TU) {
    return launch_skip<SkipT16>(users, items_t, excl, cand_v, cand_i, ghost,
                                skips, b_pad, d, i_pad, block_i, tile_u,
                                floor_slot, cta_users, cluster, n_ctas, s);
  }
  if (cta_tile == SkipT32::TU) {
    return launch_skip<SkipT32>(users, items_t, excl, cand_v, cand_i, ghost,
                                skips, b_pad, d, i_pad, block_i, tile_u,
                                floor_slot, cta_users, cluster, n_ctas, s);
  }
  return (int)cudaErrorInvalidValue;
}

// skip_max_clusters of the cta_tile kernel, or -1.
extern "C" int coldrec_skip_max_clusters(int d, int cta_tile, int cluster) {
  if (d <= 0 || cluster < 1 || cluster > MAX_CLUSTER) return -1;
  if (cta_tile == SkipT16::TU) return skip_max_clusters<SkipT16>(d, cluster);
  if (cta_tile == SkipT32::TU) return skip_max_clusters<SkipT32>(d, cluster);
  return -1;
}
