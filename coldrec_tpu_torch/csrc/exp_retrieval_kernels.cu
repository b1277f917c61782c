// Kernel-variant sweeps for Hopper (sm_90a): the dot-only ceiling and the
// TPU kernel's streaming top-2 sweep.
//
// Replace the Pallas kernels of tools/exp_retrieval_kernels.py:
//   dot_sweep_kernel   <- _dot_kernel (:55), launched by dot_sweep (:77,
//                         pallas_call :83)
//   coldrec_stream_sweep (chain_sweep_kernel<..., 1, StreamChain, ...>)
//                      <- _stream_kernel (:94), launched by stream_sweep
//                         (:148, pallas_call :152)
// Contracts, as in coldrec_tpu_torch/tools/exp_retrieval_kernels.py:
//   dot     in   users (B, d) f32; items (I_pad, d) f32, or (d, I_pad) f32
//                when transposed
//           out  (B, 128) f32: per user and lane class c (item id mod 128)
//                the max score over the items of that class (NaN where one
//                is NaN, as jnp.maximum gives). No exclusion; zero pad
//                items count.
//   stream  in   users (B, d), items_t (d, I_pad) f32, excl (I_pad,) int8
//                (nonzero: score -> NEG), block_i (a multiple of 128 that
//                divides I_pad)
//           out  cand_v, cand_i (B, 1024), ghost (B, 128), the layout of
//                retrieval.cu. Per block of block_i items each lane class
//                keeps its top-2 (the 3rd-best value into the ghost), then
//                both go into the 8 sorted slots with the TPU's tie rules
//                (sweep_common.cuh). A NaN score never enters the top-2 and
//                turns the class's ghost NaN (StreamChain). block_i changes
//                the result.
//
// What bounds them on an H100: the products. At B=2048, I_pad=270,336,
// d=64 a sweep is 2*B*I*d = 7.09e10 fp32 operations (1.058 ms at
// 67 TFLOP/s; exact fp32 products are the contract, so no tensor cores)
// against ~71 MB (dot) or ~88 MB (stream) of compulsory traffic (21-26 us
// at 3.35 TB/s).
//
// Design.
//   - dot: the product loop of sweep_tile.cuh, the one retrieval.cu's sweep
//     runs on (users resident in shared memory, item groups staged by
//     cp.async in a ring, a register tile per thread), with a running max
//     per (user, class) in registers in place of the top-8. So it measures
//     how close the product loop alone comes to the card. Free of the top-8
//     state, it takes a wider tile (DotTile) than retrieval.cu can. The (d, I_pad) table
//     is staged with 16-byte copies (4-byte ones when it is not 16-byte
//     aligned); the (I_pad, d) table with 4-byte copies that transpose each
//     group into the same (DC, 128) tile, so d need not be a multiple of 4.
//     The item range is split into parts to fill the SMs (as in
//     retrieval.cu); with more than one part a second kernel takes the max
//     over the parts' (B, 128) outputs.
//   - stream: the chain sweep of sweep_common.cuh at P = 1 with the stream
//     chain (launch_chain<1, StreamChain>), the epilogue and tile that
//     multiacc_sweep runs at P = 1 (MultiP1: 16 users a block, 8 users x 1
//     class of each of 8 groups a thread; the users staged step by step
//     where d is too wide for the resident tile). Each thread keeps its
//     pairs' chains, slot values and ghosts in registers and their slot
//     ids in shared memory (TileSlots); block ends are counted per group
//     (BlockClock), so any valid block_i runs.
#include "sweep_common.cuh"
#include "sweep_tile.cuh"

namespace {

using namespace coldrec_exp;
namespace tile = coldrec_tile;

// The dot ceiling's tile: with no top-8 to hold, a thread takes a wider
// register tile than retrieval.cu's (8 users x 4 items, 128 users and 512
// threads a block), 32 dimensions per step, a ring of 4 steps.
using DotTile = tile::Shape<128, 8, 4, 8, 1, 32, 4>;

// Per thread: the running max of its (user, class) pairs.
struct MaxEpilogue {
  float mx[DotTile::RU][DotTile::RI];

  __device__ __forceinline__ void begin(int, int) {}

  __device__ __forceinline__ void step(int, int n,
                                       const tile::Acc<DotTile>& acc) {
#pragma unroll
    for (int q = 0; q < DotTile::GS; ++q) {
      if (q >= n) break;
#pragma unroll
      for (int u = 0; u < DotTile::RU; ++u) {
#pragma unroll
        for (int e = 0; e < DotTile::RI; ++e) {
          mx[u][e] = fmax_nan(mx[u][e], acc[q][u][e]);
        }
      }
    }
  }
};

// Block (user tile, part): the part's per-class max of the tile's users,
// written to out + part * n_users * 128 (the output itself for one part).
template <int LAYOUT, bool RESIDENT>
__global__ void __launch_bounds__(DotTile::THREADS, 1)
dot_sweep_kernel(const float* __restrict__ users,
                 const float* __restrict__ items, float* __restrict__ out,
                 int n_users, int d, int i_pad, int parts) {
  extern __shared__ float4 smem4[];
  const tile::Tile t{users, items, n_users, d, i_pad,
                     (int)blockIdx.x * DotTile::TU};
  const int groups = i_pad / LANES;
  const int p = blockIdx.y;
  MaxEpilogue epi;
#pragma unroll
  for (int u = 0; u < DotTile::RU; ++u) {
#pragma unroll
    for (int e = 0; e < DotTile::RI; ++e) epi.mx[u][e] = INIT_NEG;
  }
  tile::sweep_walk<DotTile, LAYOUT, RESIDENT>(t, tile::part_lo(groups, parts, p),
                                    tile::part_lo(groups, parts, p + 1),
                                    reinterpret_cast<float*>(smem4), epi);
  const int ug = DotTile::ug();
  const int ig = DotTile::ig();
#pragma unroll
  for (int u = 0; u < DotTile::RU; ++u) {
    const int user = t.u0 + DotTile::user(ug, u);
    if (user >= n_users) continue;
    const size_t row = (size_t)p * n_users + user;
#pragma unroll
    for (int e = 0; e < DotTile::RI; ++e) {
      out[row * LANES + DotTile::item(ig, e)] = epi.mx[u][e];
    }
  }
}

// out[b, c] = max over the parts of part_out[p, b, c].
__global__ void __launch_bounds__(LANES)
dot_merge_kernel(const float* __restrict__ part_out, float* __restrict__ out,
                 int n_users, int parts) {
  const size_t at = (size_t)blockIdx.x * LANES + threadIdx.x;
  const size_t stride = (size_t)n_users * LANES;
  float m = part_out[at];
  for (int p = 1; p < parts; ++p) {
    m = fmax_nan(m, part_out[p * stride + at]);
  }
  out[at] = m;
}

template <int LAYOUT, bool RESIDENT>
int launch_dot(const float* users, const float* items, float* out,
               float* scratch, int n_users, int d, int i_pad, int parts,
               cudaStream_t stream) {
  const size_t smem = DotTile::smem_bytes<RESIDENT>(d);
  const cudaError_t e = cudaFuncSetAttribute(
      dot_sweep_kernel<LAYOUT, RESIDENT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n_users + DotTile::TU - 1) / DotTile::TU, parts);
  dot_sweep_kernel<LAYOUT, RESIDENT><<<grid, DotTile::THREADS, smem, stream>>>(
      users, items, parts > 1 ? scratch : out, n_users, d, i_pad, parts);
  if (parts > 1) {
    const cudaError_t le = cudaGetLastError();
    if (le != cudaSuccess) return (int)le;
    dot_merge_kernel<<<n_users, LANES, 0, stream>>>(scratch, out, n_users,
                                                    parts);
  }
  return (int)cudaGetLastError();
}

template <int LAYOUT>
int launch_dot(const float* users, const float* items, float* out,
               float* scratch, int n_users, int d, int i_pad, int parts,
               cudaStream_t stream) {
  return DotTile::resident(d)
             ? launch_dot<LAYOUT, true>(users, items, out, scratch, n_users,
                                        d, i_pad, parts, stream)
             : launch_dot<LAYOUT, false>(users, items, out, scratch, n_users,
                                         d, i_pad, parts, stream);
}

}  // namespace

// Both entry points launch on `stream` (PyTorch's current stream), allocate
// nothing, do not synchronise, and return cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments outside the contract).
// The number of item ranges coldrec_dot_sweep splits a sweep of n_users
// into on the current device (>= 1), or -1 on a CUDA error.
extern "C" int coldrec_dot_sweep_parts(int n_users, int d, int i_pad) {
  if (n_users <= 0 || d <= 0 || i_pad < LANES) return 1;
  const int groups = i_pad / LANES;
  const int parts =
      DotTile::resident(d)
          ? tile::choose_parts<DotTile>(
                dot_sweep_kernel<tile::kRows16, true>,
                DotTile::smem_bytes<true>(d), n_users, groups)
          : tile::choose_parts<DotTile>(
                dot_sweep_kernel<tile::kRows16, false>,
                DotTile::smem_bytes<false>(d), n_users, groups);
  return parts > 0 ? parts : -1;
}

// With parts > 1, `scratch` holds (parts, B, 128) floats and a second
// kernel folds the parts into `out`.
extern "C" int coldrec_dot_sweep(const void* users, const void* items,
                                 void* out, void* scratch, int n_users, int d,
                                 int i_pad, int transposed, int parts,
                                 void* stream) {
  if (d <= 0 || i_pad % LANES) return (int)cudaErrorInvalidValue;
  if (n_users <= 0 || i_pad <= 0) return (int)cudaSuccess;
  if (parts < 1 || parts > i_pad / LANES || parts > 65535 ||
      (parts > 1 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* u = static_cast<const float*>(users);
  const float* it = static_cast<const float*>(items);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  const cudaStream_t s = (cudaStream_t)stream;
  if (transposed) {
    if (reinterpret_cast<uintptr_t>(items) % 16 == 0) {
      return launch_dot<tile::kRows16>(u, it, o, sc, n_users, d, i_pad, parts,
                                       s);
    }
    return launch_dot<tile::kRows4>(u, it, o, sc, n_users, d, i_pad, parts, s);
  }
  return launch_dot<tile::kCols4>(u, it, o, sc, n_users, d, i_pad, parts, s);
}

extern "C" int coldrec_stream_sweep(const void* users, const void* items_t,
                                    const void* excl, void* cand_v,
                                    void* cand_i, void* ghost, int n_users,
                                    int d, int i_pad, int block_i,
                                    void* stream) {
  return launch_chain<1, StreamChain>(users, items_t, excl, cand_v, cand_i,
                                      ghost, n_users, d, i_pad, block_i,
                                      stream);
}
