// Fused retrieval sweep for Hopper (sm_90a): fp32 scores + candidate
// exclusion + per-lane-class running top-8 with a ghost bound.
//
// Replaces the TPU kernel coldrec_tpu/ops/pallas/retrieval.py::_fused_kernel
// (launched by _fused_sweep). Contract, as in the Python wrapper
// coldrec_tpu_torch/ops/cuda/retrieval.py::fused_sweep:
//   in   users   (B, d)      f32, row-major
//        items_t (d, I_pad)  f32, row-major (the item table transposed,
//                            padded to a multiple of 128 items)
//        excl    (I_pad,)    int8, nonzero = candidate-excluded (score -> NEG)
//   out  cand_v  (B, 1024)   f32, column s*128 + c = slot s of lane class c
//        cand_i  (B, 1024)   i32, the item ids of those slots
//        ghost   (B, 128)    f32, per class the largest discarded value
// Lane class c holds items c, c+128, c+256, ... Each class keeps its exact
// sorted top-8 by (-value, id); unfilled slots hold (INIT_NEG, 0). A score
// that is NaN or not above INIT_NEG never enters a slot; a NaN score makes
// its class's ghost NaN for good (as the TPU kernel's jnp.maximum does), a
// score not above INIT_NEG leaves the ghost as it is. Every item that is
// not a candidate scores <= its class's ghost, unless that ghost is NaN.
//
// bf16 mode (coldrec_fused_sweep_bf16) replaces the same kernel fed bf16
// operands (_sweep_padded(bf16=True), retrieval.py:281-316): users and
// items_t are __nv_bfloat16, everything else is as above. The tile stages
// the items as bf16 and widens them to float in registers
// (sweep_tile.cuh), so the scores are the fp32 FFMA chains of the widened
// operands: every product of two bf16 values is exact in fp32, and the
// result is the exact top-k of the bf16-rounded scores with only the order
// of the fp32 sums free. Still CUDA-core FFMAs: the tensor cores' bf16
// rate is later work.
//
// What bounds it on an H100: the products. At B=2048, I=270,170, d=64 the
// sweep is 2*B*I*d = 7.1e10 fp32 operations (1.06 ms at 67 TFLOP/s outside
// the tensor cores; exact fp32 products are the contract, so no TF32 and no
// bf16), against ~88 MB of compulsory traffic (26 us at 3.35 TB/s). The
// TPU kernel's (8, 256, 128) f32+i32 VMEM scratch (2 MB) fits no SM, and
// the TPU's grid carries it from item block to item block in order.
//
// Design. The product loop is the shared tile of sweep_tile.cuh: the
// block's 16 users resident in shared memory, 8 item groups (1024 items) x
// 16 dimensions staged per step by cp.async in a ring of 2 stages, and per
// thread 8 users x 1 item of each of the 8 groups, so a step of one
// dimension reads 8 user and 8 item values from shared memory for 64
// FFMAs. Each thread owns 8 (user, class) pairs (8 users, one lane class)
// for the whole walk and keeps their sorted top-8 (value, id) and ghost in
// registers (136 of its 255). That state is what bounds the tile: the
// register file holds about 2048 such pairs per SM, so 16 users a block,
// one block of 8 warps a SM. A score that beats the pair's 8th slot is
// inserted behind its equals (items come in increasing id order, so an
// incumbent keeps its place on a tie); anything else only goes into the
// ghost with fmax_nan (one max.NaN, so a NaN score sticks).
//
// The item range is split into `parts` ranges on 128-item boundaries
// (blockIdx.y), chosen by the launcher so that the blocks fill every SM
// (coldrec_fused_sweep_parts). With parts > 1 each part writes its slots
// and ghosts to scratch, (parts, B, 1024) x2 and (parts, B, 128), and
// merge_parts_kernel folds them: per (user, class) the parts' slots go into
// one sorted top-8 in part order (a later part's ids are all larger), and
// the ghost is the max of the parts' ghosts and of every value the merge
// drops, which is the 9th value of the whole class (NaN where any part's
// ghost is NaN).
#include "sweep_tile.cuh"

namespace {

using namespace coldrec_tile;

// 16 users per block; per thread 8 users x 1 item of each of 8 groups
// (256 threads, the 32 lanes of a warp side by side along the items), 16
// dimensions per step, a ring of 2 steps.
using Sweep = Shape<16, 8, 1, 32, 8, 16, 2>;
constexpr int RU = Sweep::RU, RI = Sweep::RI;

// Per thread: the sorted top-8 and the ghost of its (user, class) pairs.
struct TopEpilogue {
  const int8_t* __restrict__ excl;
  int ig;  // the thread's item group: classes Sweep::item(ig, e)
  float rv[RU][RI][SLOTS];
  int ri[RU][RI][SLOTS];
  float gh[RU][RI];
  int8_t ex[Sweep::GS][RI];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int u = 0; u < RU; ++u) {
#pragma unroll
      for (int e = 0; e < RI; ++e) {
        gh[u][e] = INIT_NEG;
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          rv[u][e][s] = INIT_NEG;
          ri[u][e][s] = 0;
        }
      }
    }
  }

  // read the exclusion bytes early: they are used after the last chunk
  __device__ __forceinline__ void begin(int q, int g) {
#pragma unroll
    for (int e = 0; e < RI; ++e) {
      ex[q][e] = __ldg(excl + g * LANES + Sweep::item(ig, e));
    }
  }

  // the scores of groups g .. g + n - 1, in increasing id order
  __device__ __forceinline__ void step(int g, int n,
                                       const Acc<Sweep>& acc) {
#pragma unroll
    for (int q = 0; q < Sweep::GS; ++q) {
      if (q >= n) break;
#pragma unroll
      for (int u = 0; u < RU; ++u) {
#pragma unroll
        for (int e = 0; e < RI; ++e) {
          const float v = ex[q][e] ? NEG : acc[q][u][e];
          if (v > rv[u][e][SLOTS - 1]) {
            gh[u][e] = fmax_nan(gh[u][e],
                                insert_sorted(rv[u][e], ri[u][e], v,
                                              (g + q) * LANES +
                                                  Sweep::item(ig, e)));
          } else {
            gh[u][e] = fmax_nan(gh[u][e], v);  // a NaN score sticks
          }
        }
      }
    }
  }
};

template <class T, int LAYOUT, bool RESIDENT>
__global__ void __launch_bounds__(Sweep::THREADS, 1)
fused_sweep_kernel(const T* __restrict__ users,
                   const T* __restrict__ items_t,
                   const int8_t* __restrict__ excl,
                   float* __restrict__ out_v, int* __restrict__ out_i,
                   float* __restrict__ out_g, int n_users, int d, int i_pad,
                   int parts) {
  extern __shared__ float4 smem4[];
  const TileOf<T> t{users, items_t, n_users, d, i_pad,
                    (int)blockIdx.x * Sweep::TU};
  const int groups = i_pad / LANES;
  const int p = blockIdx.y;
  TopEpilogue epi;
  epi.excl = excl;
  epi.ig = Sweep::ig();
  epi.init();
  sweep_walk<Sweep, LAYOUT, RESIDENT>(t, part_lo(groups, parts, p),
                            part_lo(groups, parts, p + 1),
                            reinterpret_cast<float*>(smem4), epi);

  const int ug = Sweep::ug();
#pragma unroll
  for (int u = 0; u < RU; ++u) {
    const int user = t.u0 + Sweep::user(ug, u);
    if (user >= n_users) continue;  // pad users are never written
    const size_t row = (size_t)p * n_users + user;
#pragma unroll
    for (int e = 0; e < RI; ++e) {
      const int c = Sweep::item(epi.ig, e);
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        out_v[row * (SLOTS * LANES) + s * LANES + c] = epi.rv[u][e][s];
        out_i[row * (SLOTS * LANES) + s * LANES + c] = epi.ri[u][e][s];
      }
      out_g[row * LANES + c] = epi.gh[u][e];
    }
  }
}

// One thread per (user, class): fold the parts' slots and ghosts.
__global__ void __launch_bounds__(LANES)
merge_parts_kernel(const float* __restrict__ part_v,
                   const int* __restrict__ part_i,
                   const float* __restrict__ part_g, float* __restrict__ cand_v,
                   int* __restrict__ cand_i, float* __restrict__ ghost,
                   int n_users, int parts) {
  const int row = blockIdx.x;
  const int c = threadIdx.x;
  float rv[SLOTS];
  int ri[SLOTS];
  float gh = INIT_NEG;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    rv[s] = INIT_NEG;
    ri[s] = 0;
  }
  for (int p = 0; p < parts; ++p) {
    const size_t base = (size_t)p * n_users + row;
    gh = fmax_nan(gh, part_g[base * LANES + c]);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const size_t at = base * (SLOTS * LANES) + s * LANES + c;
      const float v = part_v[at];
      if (!(v > rv[SLOTS - 1])) {
        // the part's slots are sorted: none of the rest enters either
        gh = fmax_nan(gh, v);
        break;
      }
      gh = fmax_nan(gh, insert_sorted(rv, ri, v, part_i[at]));
    }
  }
  const size_t row_at = (size_t)row * (SLOTS * LANES) + c;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    cand_v[row_at + s * LANES] = rv[s];
    cand_i[row_at + s * LANES] = ri[s];
  }
  ghost[(size_t)row * LANES + c] = gh;
}

template <class T, int LAYOUT, bool RESIDENT>
int launch_sweep(const T* users, const T* items_t, const int8_t* excl,
                 float* out_v, int* out_i, float* out_g, int n_users, int d,
                 int i_pad, int parts, cudaStream_t stream) {
  const size_t smem = Sweep::smem_bytes<RESIDENT, T>(d);
  const cudaError_t e = cudaFuncSetAttribute(
      fused_sweep_kernel<T, LAYOUT, RESIDENT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n_users + Sweep::TU - 1) / Sweep::TU, parts);
  fused_sweep_kernel<T, LAYOUT, RESIDENT>
      <<<grid, Sweep::THREADS, smem, stream>>>(users, items_t, excl, out_v,
                                               out_i, out_g, n_users, d,
                                               i_pad, parts);
  return (int)cudaGetLastError();
}

template <class T, int LAYOUT>
int launch_sweep(const T* users, const T* items_t, const int8_t* excl,
                 float* out_v, int* out_i, float* out_g, int n_users, int d,
                 int i_pad, int parts, cudaStream_t stream) {
  return Sweep::resident<T>(d)
             ? launch_sweep<T, LAYOUT, true>(users, items_t, excl, out_v,
                                             out_i, out_g, n_users, d, i_pad,
                                             parts, stream)
             : launch_sweep<T, LAYOUT, false>(users, items_t, excl, out_v,
                                              out_i, out_g, n_users, d, i_pad,
                                              parts, stream);
}

template <class T>
int sweep_parts(int n_users, int d, int i_pad) {
  if (n_users <= 0 || d <= 0 || i_pad < LANES) return 1;
  const int groups = i_pad / LANES;
  const int parts =
      Sweep::resident<T>(d)
          ? choose_parts<Sweep>(fused_sweep_kernel<T, kRows16, true>,
                                Sweep::smem_bytes<true, T>(d), n_users,
                                groups)
          : choose_parts<Sweep>(fused_sweep_kernel<T, kRows16, false>,
                                Sweep::smem_bytes<false, T>(d), n_users,
                                groups);
  return parts > 0 ? parts : -1;
}

// the contract's checks of coldrec_fused_sweep(_bf16): an error code, or
// -1 where the arguments pass
int check_sweep(int n_users, int d, int i_pad, int parts) {
  if (d <= 0 || i_pad % LANES) return (int)cudaErrorInvalidValue;
  if (n_users <= 0 || i_pad <= 0) return (int)cudaSuccess;
  if (parts < 1 || parts > i_pad / LANES || parts > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return -1;
}

}  // namespace

// The number of item ranges coldrec_fused_sweep splits a sweep of n_users
// into on the current device (>= 1), or -1 on a CUDA error.
extern "C" int coldrec_fused_sweep_parts(int n_users, int d, int i_pad) {
  return sweep_parts<float>(n_users, d, i_pad);
}

// The same for coldrec_fused_sweep_bf16.
extern "C" int coldrec_fused_sweep_bf16_parts(int n_users, int d,
                                              int i_pad) {
  return sweep_parts<__nv_bfloat16>(n_users, d, i_pad);
}

// Launches on `stream` (PyTorch's current stream); allocates nothing and
// does not synchronise. With parts == 1 the outputs are cand_v, cand_i and
// ghost; with parts > 1 they are the parts' scratch, (parts, B, 1024) x2 and
// (parts, B, 128), for coldrec_merge_parts. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments outside the
// contract).
extern "C" int coldrec_fused_sweep(const void* users, const void* items_t,
                                   const void* excl, void* out_v, void* out_i,
                                   void* out_g, int n_users, int d, int i_pad,
                                   int parts, void* stream) {
  const int bad = check_sweep(n_users, d, i_pad, parts);
  if (bad >= 0) return bad;
  const float* u = static_cast<const float*>(users);
  const float* it = static_cast<const float*>(items_t);
  const int8_t* ex = static_cast<const int8_t*>(excl);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  float* og = static_cast<float*>(out_g);
  const cudaStream_t s = (cudaStream_t)stream;
  if (reinterpret_cast<uintptr_t>(items_t) % 16 == 0) {
    return launch_sweep<float, kRows16>(u, it, ex, ov, oi, og, n_users, d,
                                        i_pad, parts, s);
  }
  return launch_sweep<float, kRows4>(u, it, ex, ov, oi, og, n_users, d, i_pad,
                                     parts, s);
}

// coldrec_fused_sweep on __nv_bfloat16 users (B, d) and items_t (d, I_pad);
// items_t must be 16-byte aligned (cudaErrorInvalidValue otherwise).
extern "C" int coldrec_fused_sweep_bf16(const void* users,
                                        const void* items_t, const void* excl,
                                        void* out_v, void* out_i, void* out_g,
                                        int n_users, int d, int i_pad,
                                        int parts, void* stream) {
  const int bad = check_sweep(n_users, d, i_pad, parts);
  if (bad >= 0) return bad;
  if (reinterpret_cast<uintptr_t>(items_t) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_sweep<__nv_bfloat16, kRows16>(
      static_cast<const __nv_bfloat16*>(users),
      static_cast<const __nv_bfloat16*>(items_t),
      static_cast<const int8_t*>(excl), static_cast<float*>(out_v),
      static_cast<int*>(out_i), static_cast<float*>(out_g), n_users, d, i_pad,
      parts, (cudaStream_t)stream);
}

// Fold `parts` part outputs of coldrec_fused_sweep into cand_v, cand_i and
// ghost. Launches on `stream`, allocates nothing, does not synchronise.
extern "C" int coldrec_merge_parts(const void* part_v, const void* part_i,
                                   const void* part_g, void* cand_v,
                                   void* cand_i, void* ghost, int n_users,
                                   int parts, void* stream) {
  if (parts < 1) return (int)cudaErrorInvalidValue;
  if (n_users <= 0) return (int)cudaSuccess;
  merge_parts_kernel<<<n_users, LANES, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<const float*>(part_g), static_cast<float*>(cand_v),
      static_cast<int*>(cand_i), static_cast<float*>(ghost), n_users, parts);
  return (int)cudaGetLastError();
}

extern "C" const char* coldrec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
