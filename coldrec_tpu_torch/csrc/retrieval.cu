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
// What bounds the fp32 sweep on an H100: the products. At B=2048,
// I=270,170, d=64 the sweep is 2*B*I*d = 7.1e10 fp32 operations (1.06 ms at
// 67 TFLOP/s outside the tensor cores; exact fp32 products are the
// contract, so no TF32 and no bf16), against ~88 MB of compulsory traffic
// (26 us at 3.35 TB/s). The TPU kernel's (8, 256, 128) f32+i32 VMEM scratch
// (2 MB) fits no SM, and the TPU's grid carries it from item block to item
// block in order.
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
//
// bf16 mode (coldrec_fused_sweep_bf16, mma_sweep_kernel) replaces the same
// TPU kernel fed bf16 operands (_sweep_padded(bf16=True),
// retrieval.py:281-316, the MXU's bf16 product with fp32 accumulation):
// users and items_t are bf16, everything else is as above. The scores are
// Hopper's tensor-core products (mma.sync m16n8k16, bf16 operands, fp32
// accumulators; mma_tile.cuh), fed from the accumulator fragments straight
// into the same register-held top-8 and ghost, and the score plane is never
// written. Every product of two bf16 values is exact in fp32; the fp32 sums
// are the tensor cores' sums, not an fmaf chain in order j = 0..d-1, so
// they can differ from it in the last bits (as the MXU's do in the JAX
// package's bf16 mode). The result is the exact top-k of those scores;
// the ghost certificate, the part split (choose_parts at this kernel's own
// occupancy) and merge_parts_kernel are the fp32 sweep's. What bounds it:
// the 7.1e10 operations above take 0.072 ms at the tensor cores' 989
// TFLOP/s, so the epilogue decides its time: a select, a min, a max and a
// compare per score on the CUDA cores (553 M scores at that shape), and
// the insertions, which MmaTopEpilogue buffers and flushes a warp at a
// time; then the staging of the items (TMA boxes) through shared memory
// into ldmatrix.
#include "mma_tile.cuh"
#include "sweep_tile.cuh"

namespace {

using namespace coldrec_tile;
using coldrec_mma::MmaAcc;
using coldrec_mma::MmaSweep;

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

template <int LAYOUT, bool RESIDENT>
__global__ void __launch_bounds__(Sweep::THREADS, 1)
fused_sweep_kernel(const float* __restrict__ users,
                   const float* __restrict__ items_t,
                   const int8_t* __restrict__ excl,
                   float* __restrict__ out_v, int* __restrict__ out_i,
                   float* __restrict__ out_g, int n_users, int d, int i_pad,
                   int parts) {
  extern __shared__ float4 smem4[];
  const Tile t{users, items_t, n_users, d, i_pad,
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

// The bf16 sweep's epilogue: per thread the sorted top-8 and the ghost of
// its 8 (user, class) pairs, users 16(u/2) + 8(u%2) + l/4 (u = 0..3) of
// the block x classes cls0 + c (c = 0, 1), where cls0 = c0 + 8 * warp +
// 2 * (l % 4), on the accumulators of m16n8k16.
//
// A score that beats its pair's 8th slot (a candidate) is not inserted at
// once: a lane inserts while the other 31 of its warp wait, and past the
// first few hundred groups g a pair takes a candidate once in ~g/8 groups,
// so a warp would run the insertion for one or two lanes at most sites.
// The candidate goes to its pair's buffer in shared memory (CAND slots, in
// id order), and when some lane's pair holds CAND - GS + 1 (or at the end
// of the walk) the warp flushes: in rounds, round k inserting the k-th
// candidate of each pair that has one in some lane of the warp (-inf in
// the lanes where it has fewer), as many rounds as the fullest buffer has.
// The insertions of a round are independent and free of predicates
// (insert_masked), so they issue side by side. The
// slots are those of inserting at once, in id order: a score not above the
// 8th slot before its candidates are inserted is not above it after. The
// ghost takes min(score, 8th slot) of every score when it is seen, and
// again when a candidate is inserted: what the score drops (a candidate
// that beat the 8th slot drops the item in it, now or when the flush
// inserts it or a higher candidate before it).
struct MmaTopEpilogue {
  static constexpr int K = MmaSweep::CAND;
  int cls0;
  float rv[4][2][SLOTS];
  int ri[4][2][SLOTS];
  float gh[4][2];
  uint32_t cnt;  // 4 bits a pair (2u + c): its buffered candidates
  float2* buf;  // candidate k of pair p: buf[(p * K + k) * THREADS]

  __device__ __forceinline__ void init(float2* cand) {
    buf = cand;
    cnt = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        gh[u][c] = INIT_NEG;
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          rv[u][c][s] = INIT_NEG;
          ri[u][c][s] = 0;
        }
      }
    }
  }

  // the scores of groups g .. g + n - 1, in increasing id order; byte c of
  // x[q] is the exclusion byte of class cls0 + c in group g + q
  __device__ __forceinline__ void step(int g, int n,
                                       const uint32_t (&x)[MmaSweep::GS],
                                       const MmaAcc& acc) {
#pragma unroll
    for (int q = 0; q < MmaSweep::GS; ++q) {
      if (q >= n) break;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v = (x[q] >> (8 * c)) & 0xffu
                              ? NEG
                              : acc[q][u >> 1][2 * (u & 1) + c];
          const float last = rv[u][c][SLOTS - 1];
          gh[u][c] = fmax_nan(gh[u][c], fmin_nan(v, last));  // NaN sticks
          if (v > last) {
            const int p = 2 * u + c;
            const int k = (cnt >> (4 * p)) & 15;
            buf[(p * K + k) * MmaSweep::THREADS] = make_float2(
                v, __int_as_float((g + q) * LANES + cls0 + c));
            cnt += 1u << (4 * p);
          }
        }
      }
    }
    // the next step adds at most GS a pair: flush before one could overflow
    static_assert(K - MmaSweep::GS + 1 >= 1 && K <= 8, "4-bit counts");
    constexpr uint32_t ONES = 0x11111111u;
    const uint32_t near =
        (cnt + (8 - (K - MmaSweep::GS + 1)) * ONES) & 8 * ONES;
    if (__any_sync(0xffffffffu, near)) flush();
  }

  // Insert (v, id) as insert_sorted does, without a predicate: the values
  // by min/max, the ids by bitwise selects under masks from the sign of
  // rv[s] - v (all ones exactly where v > rv[s]: two floats differ by zero
  // only where they are equal, subnormals kept); v not above the 8th slot
  // (-inf included) leaves the slots as they are. Compares with a
  // predicate each chain through the few predicate registers a thread has.
  __device__ static __forceinline__ void insert_masked(float (&rv)[SLOTS],
                                                       int (&ri)[SLOTS],
                                                       float v, int id) {
    int gt[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      gt[s] = (int)__float_as_uint(rv[s] - v) >> 31;
    }
#pragma unroll
    for (int s = SLOTS - 1; s >= 1; --s) {
      rv[s] = fmaxf(rv[s], fminf(rv[s - 1], v));
      const int at = (id & gt[s]) | (ri[s] & ~gt[s]);
      ri[s] = (ri[s - 1] & gt[s - 1]) | (at & ~gt[s - 1]);
    }
    rv[0] = fmaxf(rv[0], v);
    ri[0] = (id & gt[0]) | (ri[0] & ~gt[0]);
  }

  // insert every buffered candidate (the whole warp): round k takes the
  // k-th candidate of each pair that has one in some lane of the warp,
  // -inf in the lanes where it has fewer, so the insertions of a round are
  // independent
  __device__ __forceinline__ void flush() {
    int most_p[8];  // the warp's fullest buffer of each pair
    int most = 0;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      most_p[p] = __reduce_max_sync(0xffffffffu, (cnt >> (4 * p)) & 15);
      most = max(most, most_p[p]);
    }
#pragma unroll 1
    for (int k = 0; k < most; ++k) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        if (k >= most_p[p]) continue;  // the same in every lane
        const float2 e = k < (int)((cnt >> (4 * p)) & 15)
                             ? buf[(p * K + k) * MmaSweep::THREADS]
                             : make_float2(-INFINITY, 0.0f);
        float(&slots)[SLOTS] = rv[p >> 1][p & 1];
        gh[p >> 1][p & 1] =
            fmax_nan(gh[p >> 1][p & 1], fmin_nan(e.x, slots[SLOTS - 1]));
        insert_masked(slots, ri[p >> 1][p & 1], e.x, __float_as_int(e.y));
      }
    }
    cnt = 0;
  }

  // after the walk: what is still buffered
  __device__ __forceinline__ void finish() {
    if (__any_sync(0xffffffffu, cnt)) flush();
  }
};

template <int MODE>
__global__ void __launch_bounds__(MmaSweep::THREADS, 1)
mma_sweep_kernel(const uint16_t* __restrict__ users,
                 const __grid_constant__ CUtensorMap items_map,
                 const int8_t* __restrict__ excl, float* __restrict__ out_v,
                 int* __restrict__ out_i, float* __restrict__ out_g,
                 int n_users, int d, int i_pad, int parts) {
  extern __shared__ float4 smem4[];
  const coldrec_mma::MmaTile t{
      users, &items_map, excl, n_users, d, i_pad,
      (int)(blockIdx.x / MmaSweep::HALVES) * MmaSweep::TU,
      (int)(blockIdx.x % MmaSweep::HALVES) * MmaSweep::COLS};
  const int groups = i_pad / LANES;
  const int p = blockIdx.y;
  const int lane = threadIdx.x & 31;
  MmaTopEpilogue epi;
  epi.cls0 = t.c0 + 8 * (int)(threadIdx.x >> 5) + 2 * (lane & 3);
  coldrec_mma::mma_walk<MODE>(t, part_lo(groups, parts, p),
                              part_lo(groups, parts, p + 1),
                              reinterpret_cast<uint8_t*>(smem4), epi);

  // the thread's two classes side by side: 8-byte stores
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int user = t.u0 + 16 * (u >> 1) + 8 * (u & 1) + (lane >> 2);
    if (user >= n_users) continue;  // pad users are never written
    const size_t row = (size_t)p * n_users + user;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const size_t at = row * (SLOTS * LANES) + s * LANES + epi.cls0;
      *reinterpret_cast<float2*>(out_v + at) =
          make_float2(epi.rv[u][0][s], epi.rv[u][1][s]);
      *reinterpret_cast<int2*>(out_i + at) =
          make_int2(epi.ri[u][0][s], epi.ri[u][1][s]);
    }
    *reinterpret_cast<float2*>(out_g + row * LANES + epi.cls0) =
        make_float2(epi.gh[u][0], epi.gh[u][1]);
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

template <int LAYOUT, bool RESIDENT>
int launch_sweep(const float* users, const float* items_t, const int8_t* excl,
                 float* out_v, int* out_i, float* out_g, int n_users, int d,
                 int i_pad, int parts, cudaStream_t stream) {
  const size_t smem = Sweep::smem_bytes<RESIDENT>(d);
  const cudaError_t e = cudaFuncSetAttribute(
      fused_sweep_kernel<LAYOUT, RESIDENT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n_users + Sweep::TU - 1) / Sweep::TU, parts);
  fused_sweep_kernel<LAYOUT, RESIDENT>
      <<<grid, Sweep::THREADS, smem, stream>>>(users, items_t, excl, out_v,
                                               out_i, out_g, n_users, d,
                                               i_pad, parts);
  return (int)cudaGetLastError();
}

template <int LAYOUT>
int launch_sweep(const float* users, const float* items_t, const int8_t* excl,
                 float* out_v, int* out_i, float* out_g, int n_users, int d,
                 int i_pad, int parts, cudaStream_t stream) {
  return Sweep::resident(d)
             ? launch_sweep<LAYOUT, true>(users, items_t, excl, out_v, out_i,
                                          out_g, n_users, d, i_pad, parts,
                                          stream)
             : launch_sweep<LAYOUT, false>(users, items_t, excl, out_v, out_i,
                                           out_g, n_users, d, i_pad, parts,
                                           stream);
}

int sweep_parts(int n_users, int d, int i_pad) {
  if (n_users <= 0 || d <= 0 || i_pad < LANES) return 1;
  const int groups = i_pad / LANES;
  const int parts =
      Sweep::resident(d)
          ? choose_parts<Sweep>(fused_sweep_kernel<kRows16, true>,
                                Sweep::smem_bytes<true>(d), n_users, groups)
          : choose_parts<Sweep>(fused_sweep_kernel<kRows16, false>,
                                Sweep::smem_bytes<false>(d), n_users,
                                groups);
  return parts > 0 ? parts : -1;
}

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime
// (the library does not link libcuda); null where libcuda has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return (EncodeTiled) nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of bf16 items_t (d, I_pad) in boxes of KC rows x COLS
// items, 128-byte swizzle, zeros outside the table. Returns a CUDA error
// code, or -1 where the map is made.
int make_items_map(CUtensorMap* map, const uint16_t* items_t, int d,
                   int i_pad) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)i_pad, (cuuint64_t)d};
  const cuuint64_t strides[1] = {(cuuint64_t)i_pad * 2};
  const cuuint32_t box[2] = {MmaSweep::COLS, MmaSweep::KC};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<uint16_t*>(items_t), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? -1 : (int)cudaErrorInvalidValue;
}

template <int MODE>
int launch_mma(const uint16_t* users, const uint16_t* items_t,
               const int8_t* excl, float* out_v, int* out_i, float* out_g,
               int n_users, int d, int i_pad, int parts,
               cudaStream_t stream) {
  CUtensorMap map;
  const int bad = make_items_map(&map, items_t, d, i_pad);
  if (bad >= 0) return bad;
  const size_t smem = MmaSweep::smem_bytes(MODE, d);
  const cudaError_t e = cudaFuncSetAttribute(
      mma_sweep_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(
      (n_users + MmaSweep::TU - 1) / MmaSweep::TU * MmaSweep::HALVES, parts);
  mma_sweep_kernel<MODE><<<grid, MmaSweep::THREADS, smem, stream>>>(
      users, map, excl, out_v, out_i, out_g, n_users, d, i_pad, parts);
  return (int)cudaGetLastError();
}

template <int MODE>
int mma_parts(int n_users, int d, int groups) {
  return choose_parts<MmaSweep>(mma_sweep_kernel<MODE>,
                                MmaSweep::smem_bytes(MODE, d), n_users,
                                groups, MmaSweep::HALVES);
}

int sweep_parts_bf16(int n_users, int d, int i_pad) {
  if (n_users <= 0 || d <= 0 || i_pad < LANES) return 1;
  const int groups = i_pad / LANES;
  int parts = 0;
  switch (MmaSweep::pick(d)) {
    case coldrec_mma::kARegs:
      parts = mma_parts<coldrec_mma::kARegs>(n_users, d, groups);
      break;
    case coldrec_mma::kAResident:
      parts = mma_parts<coldrec_mma::kAResident>(n_users, d, groups);
      break;
    default:
      parts = mma_parts<coldrec_mma::kAStaged>(n_users, d, groups);
  }
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
  return sweep_parts(n_users, d, i_pad);
}

// The same for coldrec_fused_sweep_bf16.
extern "C" int coldrec_fused_sweep_bf16_parts(int n_users, int d,
                                              int i_pad) {
  return sweep_parts_bf16(n_users, d, i_pad);
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
    return launch_sweep<kRows16>(u, it, ex, ov, oi, og, n_users, d, i_pad,
                                 parts, s);
  }
  return launch_sweep<kRows4>(u, it, ex, ov, oi, og, n_users, d, i_pad, parts,
                              s);
}

// coldrec_fused_sweep on bf16 users (B, d) and items_t (d, I_pad), on the
// tensor cores; items_t and excl must be 16-byte aligned
// (cudaErrorInvalidValue otherwise).
extern "C" int coldrec_fused_sweep_bf16(const void* users,
                                        const void* items_t, const void* excl,
                                        void* out_v, void* out_i, void* out_g,
                                        int n_users, int d, int i_pad,
                                        int parts, void* stream) {
  const int bad = check_sweep(n_users, d, i_pad, parts);
  if (bad >= 0) return bad;
  if (reinterpret_cast<uintptr_t>(items_t) % 16 ||
      reinterpret_cast<uintptr_t>(excl) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const uint16_t* u = static_cast<const uint16_t*>(users);
  const uint16_t* it = static_cast<const uint16_t*>(items_t);
  const int8_t* ex = static_cast<const int8_t*>(excl);
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  float* og = static_cast<float*>(out_g);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (MmaSweep::pick(d)) {
    case coldrec_mma::kARegs:
      return launch_mma<coldrec_mma::kARegs>(u, it, ex, ov, oi, og, n_users,
                                             d, i_pad, parts, s);
    case coldrec_mma::kAResident:
      return launch_mma<coldrec_mma::kAResident>(u, it, ex, ov, oi, og,
                                                 n_users, d, i_pad, parts, s);
    default:
      return launch_mma<coldrec_mma::kAStaged>(u, it, ex, ov, oi, og,
                                               n_users, d, i_pad, parts, s);
  }
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
