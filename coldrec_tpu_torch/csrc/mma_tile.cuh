// The tensor-core product tile of the bf16 retrieval sweep (retrieval.cu,
// coldrec_fused_sweep_bf16) on Hopper (sm_90a).
//
// A block owns TU = 32 users (two m16 tiles) and half of the lane classes,
// the COLS = 64 columns [c0, c0 + 64) of every group (group g is the 128
// items g*128 .. g*128+127, one of each lane class); two blocks cover a
// tile of users. It walks a range of item groups [g_lo, g_hi), GS groups
// and KC depth rows a step. Warp w multiplies the 32 users by the 8
// columns c0 + [8w, 8w + 8) of every group, one n8 tile for the two m16
// tiles of mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 per k-step of 16
// (bf16 operands, fp32 accumulators). The accumulator layout of m16n8k16
// gives lane l the rows l/4 and l/4 + 8 of each m16 tile and the columns
// 2(l%4), 2(l%4) + 1: 4 users x 2 lane classes, the same 8 (user, class)
// pairs at every group, so each pair sees its items in increasing id
// order. Each B fragment serves 32 users, so a score costs half the staged
// bytes (TMA writes, ldmatrix reads) of a block of 16 users and 128
// classes with the same 8 pairs a thread.
//
// Why mma.sync and not wgmma: the epilogue keeps a sorted top-8 and a ghost
// per (user, class) pair in registers, 17 a pair, and the register file
// holds about 2048 such pairs an SM. A wgmma tile has 64 rows: 64 users x
// 128 classes is 8192 pairs, four times that, so a block would own a
// quarter of the classes; m16n8k16 puts 8 pairs in each of 256 threads
// with 32 users a block. (A ninth warp to stage the ring would cost the
// others registers: ptxas budgets a block of 288 threads as one of 384,
// 168 registers a thread, and the state spills.)
//
// Staging. Each step's items (rows [c*KC, c*KC + KC) of the block's
// columns of its GS groups of the (d, I_pad) table) go into a ring of
// STAGES stages by the Tensor Memory Accelerator: 2-D tensor copies of
// boxes of 64 rows x 64 items, one a group
// (128 bytes a row) in the 128-byte swizzle, whose 16-byte chunk c of row
// k lands at chunk c ^ (k % 8), so the 8 rows one ldmatrix phase reads fall
// on distinct banks; the copies fill rows past d and items past I_pad with
// zeros, so the depth tail adds nothing and no stale value (a NaN of an
// earlier stage) reaches a product. With the step's last chunk a bulk copy
// brings the groups' exclusion bytes. While the warps multiply step s, one
// lane of warp (s + AHEAD) % WARPS issues the boxes of step s + AHEAD.
// (On an H100, clock64 around the loads at d=64: 16-byte cp.async from
// every thread held each warp ~1,200 cycles of a ~3,000-cycle step at the
// load pipe, and a bulk copy a 512-byte row ~5,600 cycles a step at the
// TMA's issue; a box is 8 KB.) Each stage has two mbarriers: `full`
// completes when the step's bytes have landed, `empty` when every warp has
// read it. No block-wide barrier: the warp refilling a stage waits only
// for the step STAGES - AHEAD before its own, so warps drift apart by up
// to that many steps where their epilogues take different times. B
// fragments come from the stage with ldmatrix.trans (k is the row, items
// are contiguous). The users' A fragments: with d <= KC they are loaded
// into registers once a walk (kARegs); up to the shared memory a block can
// have the (32, d) user tile stays resident, zero from d to the next
// multiple of 16, and each k-step reads its fragment with ldmatrix
// (kAResident); wider, each step stages the users' chunk beside the items
// (kAStaged).
//
// The walk calls epi.init(cand) first, with cand this thread's column of
// CAND_BYTES of shared memory for the epilogue's candidates (float2s, a row
// a THREADS apart), and epi.finish() last. After the last chunk of a step
// over groups g .. g + n - 1 (n: those below g_hi) it calls
// epi.step(g, n, x, acc), with x[q] the exclusion bytes of the thread's
// classes in group g + q (byte c of x[q]: class c0 + 8w + 2(l%4) + c) and
// acc[q][mt][e] the accumulator e of m16 tile mt for group g + q
// (m16n8k16's layout: e = 0, 1 user 16mt + l/4, e = 2, 3 user 16mt + l/4
// + 8; e even class c0 + 8w + 2(l%4), odd the class after it).
#pragma once

#include <cuda.h>  // CUtensorMap (the encoder is looked up at run time)
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_tile.cuh"

namespace coldrec_mma {

using coldrec_tile::LANES;

// How a block holds its users' A fragments (see above).
enum AMode {
  kARegs = 0,
  kAResident = 1,
  kAStaged = 2,
};

struct MmaSweep {
  static constexpr int TU = 32;  // users of a block: two m16 tiles
  static constexpr int HALVES = 2;  // blocks a tile of users
  static constexpr int COLS = LANES / HALVES;  // a block's classes
  static constexpr int WARPS = 8;  // warp w: classes c0 + [8w, 8w + 8)
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int GS = 2;  // groups per step
  static constexpr int KC = 64;  // depth rows per step
  static constexpr int KSTEPS = KC / 16;
  static_assert(WARPS * 8 == COLS, "a warp's n8 tile each");
  static constexpr int BOX_BYTES = COLS * KC * 2;  // a group's box
  static constexpr int EXCL_AT = GS * BOX_BYTES;  // stage offsets, bytes
  static constexpr int USERS_AT = EXCL_AT + GS * COLS;
  static constexpr int UROW = KC + 8;  // bf16 of a staged user row
  static constexpr size_t SMEM_MAX = 227 * 1024;  // a block's opt-in limit
  static constexpr int MAX_STAGES = 8;
  static constexpr int BARS = 16 * MAX_STAGES;  // full, empty: 8 bytes each
  static constexpr int ALIGN = 1024;  // of a 128-byte-swizzled box
  static constexpr int CAND = 5;  // candidates the epilogue buffers a pair
  static constexpr int CAND_BYTES = 8 * CAND * THREADS * 8;  // 8 pairs

  __host__ __device__ static constexpr int d16(int d) {
    return (d + 15) & ~15;
  }
  // bf16 of a user row in shared memory: padded by 8, so that a row's
  // stride is an odd multiple of 16 bytes and ldmatrix meets no conflict
  __host__ __device__ static constexpr int urow(int mode, int d) {
    return mode == kAStaged ? UROW : d16(d) + 8;
  }
  // stages of the ring, and steps in flight ahead of the walk: as many as
  // fit beside the candidates (the resident or staged users take room)
  __host__ __device__ static constexpr int stages(int mode) {
    return mode == kARegs ? MAX_STAGES : 6;
  }
  __host__ __device__ static constexpr int ahead(int mode) {
    return stages(mode) / 2;
  }
  // bytes of one stage of the ring: the boxes, the exclusion bytes, the
  // users' chunk if staged, up to the boxes' alignment
  __host__ __device__ static constexpr int stage_bytes(int mode) {
    return (USERS_AT + (mode == kAStaged ? 2 * TU * UROW : 0) + ALIGN - 1) /
           ALIGN * ALIGN;
  }
  // dynamic shared memory of a block: the ring's mbarriers, the resident
  // users, slack to align the ring, the ring, the epilogue's candidates
  static constexpr size_t smem_bytes(int mode, int d) {
    return BARS + (mode == kAStaged ? 0 : 2 * (size_t)TU * urow(mode, d)) +
           ALIGN + (size_t)stages(mode) * stage_bytes(mode) + CAND_BYTES;
  }
  // the mode a block at depth d takes
  static constexpr int pick(int d) {
    return d <= KC                                     ? kARegs
           : smem_bytes(kAResident, d) <= SMEM_MAX ? kAResident
                                                   : kAStaged;
  }
};

// acc[q][mt][e]: accumulator e of m16 tile mt for group q of a step
using MmaAcc = float[MmaSweep::GS][2][4];

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// four 8x8 b16 matrices; lanes 8m .. 8m + 7 give the row addresses of
// matrix m, which lands in x[m]
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&x)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
      : "r"(addr));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&x)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- mbarriers (phases by parity) and the TMA
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make this thread's mbarrier inits visible to the async proxy (the TMA
// completes its transactions on them), before the barrier that publishes
// them to the block
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_u32(bar))
      : "memory");
}

// arrive on `bar` and expect `bytes` more of its phase's copies
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, "
      "[%0], %1;\n}\n" ::"r"(smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      "LAB_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra DONE;\n"
      " bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// the box of `map` at (x, y) (x the inner coordinate) into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from device memory
// to shared memory by the TMA, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The table operands of one block, as raw bf16 bits.
struct MmaTile {
  const uint16_t* __restrict__ users;  // (n_users, d)
  const CUtensorMap* map;  // of items_t (d, I_pad): boxes (KC, COLS)
  const int8_t* __restrict__ excl;  // (I_pad,), 16-byte aligned
  int n_users, d, i_pad;
  int u0;  // first user of the block
  int c0;  // first class of the block: 0 or COLS
};

// Users [u0, u0 + TU) x dims [j0, j0 + cols) into rows of `stride` bf16 by
// plain loads and stores (rows of an odd d are not 4-byte aligned), thread
// `tid` of `nt`; zero past n_users and past d.
__device__ __forceinline__ void load_users(const MmaTile& t, uint16_t* su,
                                           int stride, int j0, int cols,
                                           int tid, int nt) {
  for (int e = tid; e < MmaSweep::TU * cols; e += nt) {
    const int u = e / cols;
    const int jj = e - u * cols;
    const int row = t.u0 + u;
    const int j = j0 + jj;
    su[u * stride + jj] =
        row < t.n_users && j < t.d ? t.users[(size_t)row * t.d + j] : 0;
  }
}

// Stage step (groups g .. g + GS - 1, chunk c) into `st` by the 32 lanes of
// one warp, on the stage's barrier `full` (32 arrivals, then the bytes of
// the copies): the users' chunk if staged (plain stores, released by each
// lane's arrival), a box of the block's COLS items of each group, and with
// the last chunk their exclusion bytes (of the groups below I_pad).
template <int MODE>
__device__ __forceinline__ void load_step(const MmaTile& t, uint8_t* st,
                                          uint64_t* full, int g, int c,
                                          int chunks, int lane) {
  using S = MmaSweep;
  const int j0 = c * S::KC;
  const bool last = c == chunks - 1;
  if constexpr (MODE == kAStaged) {
    load_users(t, reinterpret_cast<uint16_t*>(st + S::USERS_AT), S::UROW, j0,
               S::KC, lane, 32);
  }
  const int live = min(S::GS, t.i_pad / LANES - g);  // groups in the table
  if (lane == 0) {
    mbar_arrive_tx(full, S::GS * S::BOX_BYTES + (last ? live * S::COLS : 0));
  } else {
    mbar_arrive(full);
  }
  if (lane < S::GS) {
    tma_load_2d(st + lane * S::BOX_BYTES, t.map, (g + lane) * LANES + t.c0,
                j0, full);
  } else if (last && lane < S::GS + live) {
    const int q = lane - S::GS;
    bulk_copy(st + S::EXCL_AT + q * S::COLS,
              t.excl + (size_t)(g + q) * LANES + t.c0, S::COLS, full);
  }
}

template <class Acc>
__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int q = 0; q < MmaSweep::GS; ++q) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][n][e] = 0.0f;
    }
  }
}

// Walk groups [g_lo, g_hi) of the tile; `smem` holds
// MmaSweep::smem_bytes(MODE, d) bytes. Every thread of the block must call
// it.
template <int MODE, class Epi>
__device__ __forceinline__ void mma_walk(const MmaTile& t, int g_lo,
                                         int g_hi, uint8_t* smem, Epi& epi) {
  using S = MmaSweep;
  constexpr int STAGES = S::stages(MODE), AHEAD = S::ahead(MODE);
  static_assert(AHEAD < STAGES, "a refill waits for an earlier step");
  constexpr int STAGE = S::stage_bytes(MODE);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int dd = S::d16(t.d);
  const int chunks = (dd + S::KC - 1) / S::KC;
  const int steps = (g_hi - g_lo + S::GS - 1) / S::GS * chunks;
  const int ur = S::urow(MODE, t.d);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  uint16_t* su0 = reinterpret_cast<uint16_t*>(smem + S::BARS);
  uint8_t* ring = smem + S::BARS + (MODE == kAStaged ? 0 : 2 * S::TU * ur);
  ring += (S::ALIGN - (smem_u32(ring) & (S::ALIGN - 1))) & (S::ALIGN - 1);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 32);
      mbar_init(empty + i, S::WARPS);
    }
    fence_mbar_init();
  }
  if constexpr (MODE != kAStaged) {
    load_users(t, su0, ur, 0, dd, threadIdx.x, S::THREADS);
  }
  epi.init(reinterpret_cast<float2*>(ring + STAGES * STAGE) + threadIdx.x);
  __syncthreads();  // the mbarriers and the resident users are ready

  // the step s lives in stage s % STAGES; warp s % WARPS issues it AHEAD
  // steps before the walk reaches it
  auto load_next = [&](int s) {
    const int i = s % STAGES;
    if (s >= STAGES) mbar_wait(empty + i, (s / STAGES - 1) & 1);
    load_step<MODE>(t, ring + i * STAGE, full + i,
                    g_lo + s / chunks * S::GS, s % chunks, chunks, lane);
  };
#pragma unroll 1
  for (int s = warp; s < AHEAD && s < steps; s += S::WARPS) load_next(s);

  // ldmatrix row addresses: lanes 8m .. 8m + 7 give the rows of matrix m.
  // A (users x k) of m16 tile mt: m = 0..3 are (users 0-7, k 0-7), (8-15,
  // 0-7), (0-7, 8-15), (8-15, 8-15): a0..a3 of m16n8k16. B (k x items),
  // transposed, for a pair of k-steps: m = 0..3 are k 0-7, 8-15, 16-23,
  // 24-31 of the warp's 8 items, the b0, b1 of one k-step, then of the
  // next; the warp's items are the 16-byte chunk w of a box row, row k at
  // k * 128 bytes and its chunk w at w ^ (k % 8) (k % 8 = r8: the pairs of
  // k-steps start at multiples of 32).
  const int m = lane >> 3, r8 = lane & 7;
  const int a_off = ((m & 1) * 8 + r8) * ur + (m >> 1) * 8;
  const int b_off = (8 * m + r8) * 128 + ((warp ^ r8) << 4);
  const int x_off = 8 * warp + 2 * (lane & 3);  // the thread's classes
  unsigned areg[MODE == kARegs ? S::KSTEPS : 1][2][4];
  if constexpr (MODE == kARegs) {
#pragma unroll
    for (int ks = 0; ks < S::KSTEPS; ++ks) {
      if (ks * 16 >= dd) break;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldsm_x4(smem_u32(su0 + a_off + 16 * mt * ur + ks * 16), areg[ks][mt]);
      }
    }
  }
  MmaAcc acc;
  zero_acc(acc);
  int g = g_lo, c = 0;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    if (s + AHEAD < steps && (s + AHEAD) % S::WARPS == warp) {
      load_next(s + AHEAD);
    }
    const int i = s % STAGES;
    mbar_wait(full + i, (s / STAGES) & 1);
    const uint8_t* st = ring + i * STAGE;
    const uint16_t* su =
        (MODE == kAStaged ? reinterpret_cast<const uint16_t*>(st + S::USERS_AT)
                          : su0 + c * S::KC) +
        a_off;
    const bool last = c == chunks - 1;
    uint32_t x[S::GS];
    if (last) {
#pragma unroll
      for (int q = 0; q < S::GS; ++q) {
        x[q] = *reinterpret_cast<const uint16_t*>(st + S::EXCL_AT +
                                                  q * S::COLS + x_off);
      }
    }
    const int ksteps = min(S::KC, dd - c * S::KC) / 16;
#pragma unroll
    for (int kp = 0; kp < S::KSTEPS / 2; ++kp) {
      if (2 * kp >= ksteps) break;
      unsigned b[S::GS][4];
#pragma unroll
      for (int q = 0; q < S::GS; ++q) {
        ldsm_x4_t(smem_u32(st + q * S::BOX_BYTES + b_off + kp * 32 * 128),
                  b[q]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ks = 2 * kp + h;
        if (ks >= ksteps) break;
        unsigned a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if constexpr (MODE == kARegs) {
#pragma unroll
            for (int r = 0; r < 4; ++r) a[mt][r] = areg[ks][mt][r];
          } else {
            ldsm_x4(smem_u32(su + 16 * mt * ur + ks * 16), a[mt]);
          }
        }
#pragma unroll
        for (int q = 0; q < S::GS; ++q) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[q][mt], a[mt], b[q][2 * h], b[q][2 * h + 1]);
          }
        }
      }
    }
    __syncwarp();  // every lane's reads of the stage are done
    if (lane == 0) mbar_arrive(empty + i);
    if (last) {
      epi.step(g, min(S::GS, g_hi - g), x, acc);
      zero_acc(acc);
    }
    if (++c == chunks) {
      c = 0;
      g += S::GS;
    }
  }
  epi.finish();
}

}  // namespace coldrec_mma
