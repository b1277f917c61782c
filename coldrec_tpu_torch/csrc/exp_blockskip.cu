// Block-skip streaming sweep for Hopper (sm_90a).
//
// Replaces the Pallas kernel tools/exp_blockskip.py::_skip_kernel (:57),
// launched by _skip_sweep (:126, pallas_call :132). Contract as in
// stream_sweep_kernel (exp_retrieval_kernels.cu), over users padded to a
// multiple of tile_u (pad rows take part), plus:
//   - before each block of block_i items, for every user u of a tile:
//     bmax[u] = the block's max score (excluded items score NEG) and
//     floor[u] = min over lane classes of slot floor_slot of u (INIT_NEG
//     until every class has filled that slot);
//   - if bmax[u] < floor[u] for EVERY user of the tile, the block is
//     skipped: no extraction, the ghost of every lane class takes bmax[u],
//     and the tile's counter skips[tile] goes up by one;
//   - otherwise the block goes through the stream sweep's extraction.
// tile_u changes the result (the predicate is over the whole tile), so the
// kernel takes it: one CTA owns one tile, and __syncthreads_and decides.
//
// What bounds it on an H100: the products, as for the stream sweep (the
// block max needs every score): at B=2048, I_pad=270,336, d=64,
// 7.09e10 fp32 operations (1.058 ms at 67 TFLOP/s) against ~88 MB of
// compulsory traffic. This kernel is far from that bound by design:
//   - one CTA per tile gives B / tile_u CTAs (8 at B=2048, tile_u=256) for
//     132 SMs;
//   - a block that is not skipped is scored twice, once for its max and
//     once for the extraction: the (tile_u, block_i) score block (8 MB at
//     256 x 8192) fits no SM, which is also why the TPU variant ran out of
//     VMEM;
//   - the running state of a tile (tile_u x 1024 slots of 8 bytes, 2 MB at
//     tile_u=256) fits no SM either, so it lives in the output buffers in
//     device memory (mostly L2): thread (group, c) alone reads and writes
//     lane class c of its users, so no two threads share an address.
// Threads: 512 = 4 groups x 128 lane classes; a group scores UG=4 users at
// a time (the item value is loaded once for them), users ub, ub + 16, ...
// of the tile go to group (ub / 4) % 4. The per-user block max and floor
// are reduced across the 128 lane classes with warp shuffles and a
// (4 warps, tile_u) shared array. The user tile sits in shared memory as
// (d, tile_u): 64 KB at d=64, tile_u=256.
#include "sweep_common.cuh"

namespace {

using namespace coldrec_exp;

constexpr int SKIP_THREADS = 512;
constexpr int GROUPS = SKIP_THREADS / LANES;  // user groups per CTA
constexpr int LANE_WARPS = LANES / 32;  // warps per group
constexpr int UG = 4;  // users a group scores at a time

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// One CTA per SM is the design, so every thread may take 128 registers.
__global__ void __launch_bounds__(SKIP_THREADS, 1)
skip_sweep_kernel(const float* __restrict__ users,
                  const float* __restrict__ items_t,
                  const int8_t* __restrict__ excl, float* __restrict__ cand_v,
                  int* __restrict__ cand_i, float* __restrict__ ghost,
                  int* __restrict__ skips, int d, int i_pad, int block_i,
                  int tile_u, int floor_slot) {
  extern __shared__ float4 smem4[];
  float* su = reinterpret_cast<float*>(smem4);  // (d, tile_u)
  float* part = su + (size_t)d * tile_u;  // (LANE_WARPS, tile_u)
  float* floor_v = part + LANE_WARPS * tile_u;  // (tile_u)
  float* bmax = floor_v + tile_u;  // (tile_u)
  const int tid = threadIdx.x;
  const int c = tid % LANES;
  const int grp = tid / LANES;
  const int w = c / 32;
  const bool lead = (c % 32) == 0;
  const size_t u0 = (size_t)blockIdx.x * tile_u;
  load_users(su, users + u0 * d, 0, tile_u, tile_u, d, tid, SKIP_THREADS);
  for (int u = tid; u < tile_u; u += SKIP_THREADS) floor_v[u] = INIT_NEG;
  for (int ub = grp * UG; ub < tile_u; ub += GROUPS * UG) {
    for (int k = 0; k < UG; ++k) {
      const size_t row = u0 + ub + k;
      for (int s = 0; s < SLOTS; ++s) {
        cand_v[row * (SLOTS * LANES) + s * LANES + c] = INIT_NEG;
        cand_i[row * (SLOTS * LANES) + s * LANES + c] = 0;
      }
      ghost[row * LANES + c] = INIT_NEG;
    }
  }
  __syncthreads();

  const int slices = block_i / LANES;
  int n_skipped = 0;
  for (int base = 0; base < i_pad; base += block_i) {
    // 1. every user's block max
    for (int ub = grp * UG; ub < tile_u; ub += GROUPS * UG) {
      float mx[UG];
#pragma unroll
      for (int k = 0; k < UG; ++k) mx[k] = INIT_NEG;
      for (int s = 0; s < slices; ++s) {
        const int item = base + s * LANES + c;
        float acc[UG];
        dot_column<UG>(items_t + item, (size_t)i_pad, su, tile_u, ub, d, acc);
        const bool ex = excl[item] != 0;
#pragma unroll
        for (int k = 0; k < UG; ++k) mx[k] = fmaxf(mx[k], ex ? NEG : acc[k]);
      }
#pragma unroll
      for (int k = 0; k < UG; ++k) {
        const float m = warp_max(mx[k]);
        if (lead) part[w * tile_u + ub + k] = m;
      }
    }
    __syncthreads();
    // 2. skip when every user of the tile is dominated by its floor
    int dominated = 1;
    for (int u = tid; u < tile_u; u += SKIP_THREADS) {
      float m = part[u];
#pragma unroll
      for (int q = 1; q < LANE_WARPS; ++q) m = fmaxf(m, part[q * tile_u + u]);
      bmax[u] = m;
      dominated &= m < floor_v[u];
    }
    if (__syncthreads_and(dominated)) {
      for (int ub = grp * UG; ub < tile_u; ub += GROUPS * UG) {
#pragma unroll
        for (int k = 0; k < UG; ++k) {
          float* g = ghost + (u0 + ub + k) * LANES + c;
          *g = fmaxf(*g, bmax[ub + k]);
        }
      }
      ++n_skipped;
      continue;
    }
    // 3. the extraction, with the block scored again
    for (int ub = grp * UG; ub < tile_u; ub += GROUPS * UG) {
      Top2 t[UG];
#pragma unroll
      for (int k = 0; k < UG; ++k) t[k].init();
      for (int s = 0; s < slices; ++s) {
        const int item = base + s * LANES + c;
        float acc[UG];
        dot_column<UG>(items_t + item, (size_t)i_pad, su, tile_u, ub, d, acc);
        const bool ex = excl[item] != 0;
#pragma unroll
        for (int k = 0; k < UG; ++k) t[k].push(ex ? NEG : acc[k], s);
      }
#pragma unroll
      for (int k = 0; k < UG; ++k) {
        const size_t row = u0 + ub + k;
        float* cv = cand_v + row * (SLOTS * LANES) + c;
        int* ci = cand_i + row * (SLOTS * LANES) + c;
        float rv[SLOTS];
        int ri[SLOTS];
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          rv[s] = cv[s * LANES];
          ri[s] = ci[s * LANES];
        }
        float gh = ghost[row * LANES + c];
        insert_block(rv, ri, gh, t[k], base + c);
        float f = rv[0];
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          cv[s * LANES] = rv[s];
          ci[s * LANES] = ri[s];
          f = (s == floor_slot) ? rv[s] : f;  // no dynamic register index
        }
        ghost[row * LANES + c] = gh;
        f = warp_min(f);
        if (lead) part[w * tile_u + ub + k] = f;
      }
    }
    __syncthreads();
    for (int u = tid; u < tile_u; u += SKIP_THREADS) {
      float f = part[u];
#pragma unroll
      for (int q = 1; q < LANE_WARPS; ++q) f = fminf(f, part[q * tile_u + u]);
      floor_v[u] = f;
    }
    __syncthreads();  // `part` is written again by the next block's step 1
  }
  if (tid == 0) skips[blockIdx.x] = n_skipped;
}

}  // namespace

// Launches on `stream` (PyTorch's current stream), allocates nothing, does
// not synchronise, and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments outside the contract). b_pad is a
// multiple of tile_u, tile_u a multiple of 4; cand_v, cand_i and ghost have
// b_pad rows and skips b_pad / tile_u entries.
extern "C" int coldrec_skip_sweep(const void* users, const void* items_t,
                                  const void* excl, void* cand_v,
                                  void* cand_i, void* ghost, void* skips,
                                  int b_pad, int d, int i_pad, int block_i,
                                  int tile_u, int floor_slot, void* stream) {
  if (d <= 0 || !valid_blocks(i_pad, block_i) || tile_u <= 0 ||
      tile_u % UG || b_pad % tile_u || floor_slot < 0 ||
      floor_slot >= SLOTS) {
    return (int)cudaErrorInvalidValue;
  }
  if (b_pad <= 0) return (int)cudaSuccess;
  const size_t smem =
      sizeof(float) * ((size_t)d * tile_u + (LANE_WARPS + 2) * tile_u);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(skip_sweep_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  skip_sweep_kernel<<<b_pad / tile_u, SKIP_THREADS, smem,
                      (cudaStream_t)stream>>>(
      static_cast<const float*>(users), static_cast<const float*>(items_t),
      static_cast<const int8_t*>(excl), static_cast<float*>(cand_v),
      static_cast<int*>(cand_i), static_cast<float*>(ghost),
      static_cast<int*>(skips), d, i_pad, block_i, tile_u, floor_slot);
  return (int)cudaGetLastError();
}
