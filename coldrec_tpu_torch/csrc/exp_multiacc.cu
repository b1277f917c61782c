// Multi-accumulator streaming sweep for Hopper (sm_90a).
//
// Replaces the Pallas kernel tools/exp_multiacc.py::_multiacc_kernel (:72,
// with the merge _merge_two :49), launched by multiacc_sweep (:137,
// pallas_call :142). Contract as in stream_sweep_kernel
// (exp_retrieval_kernels.cu) plus P: inside each block of block_i items,
// slice s (the items base + s*128 + c) feeds accumulator group s % P, and
// the P groups' top-2 chains are merged pairwise ((0,1), (2,3), ... then the
// pairs' results, as the Pallas kernel's list reduction does) once per
// block. The merge keeps the lower slice on a tie, so the result is bit for
// bit that of the single chain (P = 1) and of stream_sweep_kernel.
//
// What bounds it on an H100: the products, as for the stream sweep: at
// B=2048, I_pad=270,336, d=64, 7.09e10 fp32 operations (1.058 ms at
// 67 TFLOP/s) against ~88 MB of compulsory traffic (26 us at 3.35 TB/s).
//
// Design: the stream sweep's kernel (128 threads, thread c owns lane class c
// for a tile of TU users, the user tile in shared memory) with its product
// loop unchanged: each slice is scored by the same FFMA chains, and only
// the top-2 chain is split into P independent ones, so P asks exactly how
// much instruction-level parallelism the single chain was missing. P = 1
// is the stream sweep's code. A thread holds 5*P chain registers and 17
// slot registers per user, so the user tile shrinks where P grows: TU = 4
// up to P = 4 and TU = 2 at P = 8 (the -Xptxas -v report in PERF.md shows
// the registers and spills of each instance).
#include "sweep_common.cuh"

namespace {

using namespace coldrec_exp;

template <int P, int TU>
__global__ void __launch_bounds__(LANES)
multiacc_sweep_kernel(const float* __restrict__ users,
                      const float* __restrict__ items_t,
                      const int8_t* __restrict__ excl,
                      float* __restrict__ cand_v, int* __restrict__ cand_i,
                      float* __restrict__ ghost, int n_users, int d,
                      int i_pad, int block_i) {
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
    Top2 t[TU][P];
#pragma unroll
    for (int u = 0; u < TU; ++u) {
#pragma unroll
      for (int p = 0; p < P; ++p) t[u][p].init();
    }
    for (int s0 = 0; s0 < slices; s0 += P) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int s = s0 + p;
        if (s < slices) {  // the same for every thread of the block
          const int item = base + s * LANES + c;
          float acc[TU];
          dot_column<TU>(items_t + item, (size_t)i_pad, su, TU, 0, d, acc);
          const bool ex = excl[item] != 0;
#pragma unroll
          for (int u = 0; u < TU; ++u) t[u][p].push(ex ? NEG : acc[u], s);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < TU; ++u) {
#pragma unroll
      for (int step = 1; step < P; step *= 2) {
#pragma unroll
        for (int q = 0; q + step < P; q += 2 * step) {
          t[u][q] = merge_two(t[u][q], t[u][q + step]);
        }
      }
      insert_block(rv[u], ri[u], gh[u], t[u][0], base + c);
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

template <int P, int TU>
int launch_multiacc(const void* users, const void* items_t, const void* excl,
                    void* cand_v, void* cand_i, void* ghost, int n_users,
                    int d, int i_pad, int block_i, cudaStream_t stream) {
  const size_t smem = sizeof(float) * TU * d;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(multiacc_sweep_kernel<P, TU>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n_users + TU - 1) / TU);
  multiacc_sweep_kernel<P, TU><<<grid, LANES, smem, stream>>>(
      static_cast<const float*>(users), static_cast<const float*>(items_t),
      static_cast<const int8_t*>(excl), static_cast<float*>(cand_v),
      static_cast<int*>(cand_i), static_cast<float*>(ghost), n_users, d,
      i_pad, block_i);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream), allocates nothing, does
// not synchronise, and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments outside the contract; P is one of
// 1, 2, 4, 8).
extern "C" int coldrec_multiacc_sweep(const void* users, const void* items_t,
                                      const void* excl, void* cand_v,
                                      void* cand_i, void* ghost, int n_users,
                                      int d, int i_pad, int block_i,
                                      int p_acc, void* stream) {
  if (d <= 0 || !valid_blocks(i_pad, block_i)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_users <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (p_acc) {
    case 1:
      return launch_multiacc<1, 4>(users, items_t, excl, cand_v, cand_i,
                                   ghost, n_users, d, i_pad, block_i, s);
    case 2:
      return launch_multiacc<2, 4>(users, items_t, excl, cand_v, cand_i,
                                   ghost, n_users, d, i_pad, block_i, s);
    case 4:
      return launch_multiacc<4, 4>(users, items_t, excl, cand_v, cand_i,
                                   ghost, n_users, d, i_pad, block_i, s);
    case 8:
      return launch_multiacc<8, 2>(users, items_t, excl, cand_v, cand_i,
                                   ghost, n_users, d, i_pad, block_i, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
