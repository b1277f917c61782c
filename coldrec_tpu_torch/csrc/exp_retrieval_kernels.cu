// Kernel-variant sweeps for Hopper (sm_90a): the dot-only ceiling and the
// TPU kernel's streaming top-2 sweep.
//
// Replace the Pallas kernels of tools/exp_retrieval_kernels.py:
//   dot_sweep_kernel    <- _dot_kernel (:55), launched by dot_sweep (:77,
//                          pallas_call :83)
//   stream_sweep_kernel <- _stream_kernel (:94), launched by stream_sweep
//                          (:148, pallas_call :152)
// Contracts, as in coldrec_tpu_torch/tools/exp_retrieval_kernels.py:
//   dot     in   users (B, d) f32; items (I_pad, d) f32, or (d, I_pad) f32
//                when transposed
//           out  (B, 128) f32: per user and lane class c (item id mod 128)
//                the max score over the items of that class. No exclusion;
//                zero pad items count.
//   stream  in   users (B, d), items_t (d, I_pad) f32, excl (I_pad,) int8
//                (nonzero: score -> NEG), block_i (a multiple of 128 that
//                divides I_pad)
//           out  cand_v, cand_i (B, 1024), ghost (B, 128), the layout of
//                retrieval.cu. Per block of block_i items each lane class
//                keeps its top-2 (the 3rd-best value goes into the ghost),
//                then both go into the 8 sorted slots with the TPU's tie
//                rules (sweep_common.cuh). block_i changes the result.
//
// What bounds them on an H100: the products. At B=2048, I_pad=270,336,
// d=64 a sweep is 2*B*I*d = 7.09e10 fp32 operations (1.058 ms at
// 67 TFLOP/s; exact fp32 products are the contract, so no tensor cores)
// against ~71 MB (dot) or ~88 MB (stream) of compulsory traffic (21-26 us
// at 3.35 TB/s).
//
// Design (simple first, the structure of retrieval.cu so that the three
// compare like with like): one block of 128 threads per tile of TILE_U
// users; thread c owns lane class c for the tile's users and walks the items
// of its class in increasing id order; the user tile sits in shared memory
// as (d, TILE_U) and is read as broadcast float4s. Per item: TILE_U FFMA
// chains of length d, then
//   - dot: a running max per user;
//   - stream: the block-local top-2 chain per user (5 registers), and at the
//     end of each block the cascade into the user's 8 slots, in registers.
// The dot kernel's (I_pad, d) layout puts one thread's item values d floats
// apart, so a warp's reads of one dimension would touch 32 rows; the block
// instead stages each group of 128 item rows in shared memory with
// coalesced loads (row stride d+1, so the column reads hit 32 banks) and
// pays two barriers per group for it. Like retrieval.cu, every block
// streams the whole item table, mostly from L2.
#include "sweep_common.cuh"

namespace {

using namespace coldrec_exp;

constexpr int TILE_U = 4;  // users per block

template <int TU, bool TRANSPOSED>
__global__ void __launch_bounds__(LANES)
dot_sweep_kernel(const float* __restrict__ users,
                 const float* __restrict__ items, float* __restrict__ out,
                 int n_users, int d, int i_pad) {
  extern __shared__ float4 smem4[];
  float* su = reinterpret_cast<float*>(smem4);  // (d, TU)
  float* sit = su + TU * d;  // (128, d + 1) staged rows, (I_pad, d) layout
  const int c = threadIdx.x;
  const int u0 = blockIdx.x * TU;
  load_users(su, users, u0, TU, n_users, d, c, LANES);
  __syncthreads();

  float mx[TU];
#pragma unroll
  for (int u = 0; u < TU; ++u) mx[u] = INIT_NEG;
  // thread c stages elements c, c + 128, ... of a group's 128 * d floats:
  // walk (row, col) by 128 elements at a time without a division
  const int rstep = LANES / d;
  const int cstep = LANES - rstep * d;
  const int groups = i_pad / LANES;
  for (int g = 0; g < groups; ++g) {
    float acc[TU];
    if constexpr (TRANSPOSED) {
      dot_column<TU>(items + (size_t)g * LANES + c, (size_t)i_pad, su, TU,
                     0, d, acc);
    } else {
      const float* rows = items + (size_t)g * LANES * d;
      __syncthreads();  // every thread is done with the previous group
      int r = c / d;
      int col = c - r * d;
      for (int k = c; k < LANES * d; k += LANES) {
        sit[r * (d + 1) + col] = __ldg(rows + k);
        r += rstep;
        col += cstep;
        if (col >= d) {
          col -= d;
          ++r;
        }
      }
      __syncthreads();
      const float* mine = sit + c * (d + 1);
#pragma unroll
      for (int u = 0; u < TU; ++u) acc[u] = 0.0f;
#pragma unroll 8
      for (int j = 0; j < d; ++j) {
        const float x = mine[j];
        float uu[TU];
        user_values<TU>(su, j * TU, uu);
#pragma unroll
        for (int u = 0; u < TU; ++u) acc[u] = fmaf(uu[u], x, acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < TU; ++u) mx[u] = fmaxf(mx[u], acc[u]);
  }
#pragma unroll
  for (int u = 0; u < TU; ++u) {
    if (u0 + u < n_users) out[(size_t)(u0 + u) * LANES + c] = mx[u];
  }
}

template <int TU>
__global__ void __launch_bounds__(LANES)
stream_sweep_kernel(const float* __restrict__ users,
                    const float* __restrict__ items_t,
                    const int8_t* __restrict__ excl,
                    float* __restrict__ cand_v, int* __restrict__ cand_i,
                    float* __restrict__ ghost, int n_users, int d, int i_pad,
                    int block_i) {
  extern __shared__ float4 smem4[];
  float* su = reinterpret_cast<float*>(smem4);  // (d, TU)
  const int c = threadIdx.x;
  const int u0 = blockIdx.x * TU;
  load_users(su, users, u0, TU, n_users, d, c, LANES);
  __syncthreads();

  float rv[TU][SLOTS];
  int ri[TU][SLOTS];
  float gh[TU];
#pragma unroll
  for (int u = 0; u < TU; ++u) {
    gh[u] = INIT_NEG;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      rv[u][s] = INIT_NEG;
      ri[u][s] = 0;
    }
  }

  const int slices = block_i / LANES;
  for (int base = 0; base < i_pad; base += block_i) {
    Top2 t[TU];
#pragma unroll
    for (int u = 0; u < TU; ++u) t[u].init();
    for (int s = 0; s < slices; ++s) {
      const int item = base + s * LANES + c;
      float acc[TU];
      dot_column<TU>(items_t + item, (size_t)i_pad, su, TU, 0, d, acc);
      const bool ex = excl[item] != 0;
#pragma unroll
      for (int u = 0; u < TU; ++u) t[u].push(ex ? NEG : acc[u], s);
    }
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      insert_block(rv[u], ri[u], gh[u], t[u], base + c);
    }
  }

#pragma unroll
  for (int u = 0; u < TU; ++u) {
    if (u0 + u < n_users) {
      store_slots(cand_v, cand_i, ghost, (size_t)(u0 + u), c, rv[u], ri[u],
                  gh[u]);
    }
  }
}

template <bool TRANSPOSED>
int launch_dot(const float* users, const float* items, float* out,
               int n_users, int d, int i_pad, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (TILE_U * d + (TRANSPOSED ? 0 : LANES * (d + 1)));
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(dot_sweep_kernel<TILE_U, TRANSPOSED>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n_users + TILE_U - 1) / TILE_U);
  dot_sweep_kernel<TILE_U, TRANSPOSED><<<grid, LANES, smem, stream>>>(
      users, items, out, n_users, d, i_pad);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points launch on `stream` (PyTorch's current stream), allocate
// nothing, do not synchronise, and return cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments outside the contract).
extern "C" int coldrec_dot_sweep(const void* users, const void* items,
                                 void* out, int n_users, int d, int i_pad,
                                 int transposed, void* stream) {
  if (d <= 0 || i_pad % LANES) return (int)cudaErrorInvalidValue;
  if (n_users <= 0 || i_pad <= 0) return (int)cudaSuccess;
  const float* u = static_cast<const float*>(users);
  const float* it = static_cast<const float*>(items);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  return transposed ? launch_dot<true>(u, it, o, n_users, d, i_pad, s)
                    : launch_dot<false>(u, it, o, n_users, d, i_pad, s);
}

extern "C" int coldrec_stream_sweep(const void* users, const void* items_t,
                                    const void* excl, void* cand_v,
                                    void* cand_i, void* ghost, int n_users,
                                    int d, int i_pad, int block_i,
                                    void* stream) {
  if (d <= 0 || !valid_blocks(i_pad, block_i)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_users <= 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * TILE_U * d;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(stream_sweep_kernel<TILE_U>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n_users + TILE_U - 1) / TILE_U);
  stream_sweep_kernel<TILE_U><<<grid, LANES, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(users), static_cast<const float*>(items_t),
      static_cast<const int8_t*>(excl), static_cast<float*>(cand_v),
      static_cast<int*>(cand_i), static_cast<float*>(ghost), n_users, d,
      i_pad, block_i);
  return (int)cudaGetLastError();
}
