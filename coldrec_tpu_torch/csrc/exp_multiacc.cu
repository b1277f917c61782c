// Multi-accumulator streaming sweep for Hopper (sm_90a).
//
// Replaces the Pallas kernel tools/exp_multiacc.py::_multiacc_kernel (:72,
// with the merge _merge_two :49), launched by multiacc_sweep (:137,
// pallas_call :142). Contract as in coldrec_stream_sweep
// (exp_retrieval_kernels.cu) plus P: inside each block of block_i items,
// slice s (block-relative) feeds chain s % P of P independent top-2
// chains, written as the Pallas kernel writes them, with maximum and
// minimum (MaxChain in sweep_common.cuh); once per block the P chains are
// merged pairwise ((0,1), (2,3), ... then the pairs' results, as the Pallas
// kernel's list reduction does) with merge_two, which keeps the lower slice
// on a tie; then m1 and m2 cascade into the 8 slots with the TPU's strict
// `>`. On a table without NaN the merge is exact for any split of a
// block's slices into chains, so the result is bit for bit the single
// chain's (P = 1) and coldrec_stream_sweep's. A NaN score does not take
// the same way: it makes its chain NaN for the rest of the block (the
// chain adds nothing to the slots and turns the ghost NaN), and merge_two
// lets a NaN in the higher chain win, so on NaN tables the result depends
// on P and on which slices share a chain, as in JAX.
//
// What bounds it on an H100: the products, as for the stream sweep: at
// B=2048, I_pad=270,336, d=64, 7.09e10 fp32 operations (1.058 ms at
// 67 TFLOP/s) against ~88 MB of compulsory traffic (26 us at 3.35 TB/s).
//
// Design: the chain sweep of sweep_common.cuh (launch_chain<P, MaxChain>),
// the one the stream sweep runs at P = 1: the product loop of
// sweep_tile.cuh (the user tile resident in shared memory, or staged beside
// the items where d is too wide for it, item groups staged by cp.async, a
// register tile per thread), the one retrieval.cu's sweep runs on. Each
// thread owns its (user, class) pairs for the whole walk: P chains (5P
// registers), the 8 slot values and the ghost in registers, the 8 slot ids
// in shared memory (TileSlots: the ids move only at block ends). A block
// end may fall inside a step (block_i 256 closes a block every 2 groups of
// an 8-group step): the epilogue counts groups (BlockClock) and closes the
// block after the group that ends it. Group g of the walk feeds register
// chain g % P (a compile-time index); at a block end the chains are
// rotated by the block's first group mod P, which makes them the Pallas
// kernel's block-relative chains (no move when block_i / 128 is a multiple
// of P). The item range is not split: the strict cascade is not a stable
// merge, so parts could not be merged bit for bit; the parallelism comes
// from the users. The register tile shrinks where P grows (MultiShape; the
// build's -Xptxas -v report shows registers and spills of each instance).
#include "sweep_common.cuh"

// Launches on `stream` (PyTorch's current stream), allocates nothing, does
// not synchronise, and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments outside the contract: P is one of
// 1, 2, 4, 8; d is any positive depth).
extern "C" int coldrec_multiacc_sweep(const void* users, const void* items_t,
                                      const void* excl, void* cand_v,
                                      void* cand_i, void* ghost, int n_users,
                                      int d, int i_pad, int block_i,
                                      int p_acc, void* stream) {
  using coldrec_exp::launch_chain;
  using coldrec_exp::MaxChain;
  switch (p_acc) {
    case 1:
      return launch_chain<1, MaxChain>(users, items_t, excl, cand_v, cand_i,
                                       ghost, n_users, d, i_pad, block_i,
                                       stream);
    case 2:
      return launch_chain<2, MaxChain>(users, items_t, excl, cand_v, cand_i,
                                       ghost, n_users, d, i_pad, block_i,
                                       stream);
    case 4:
      return launch_chain<4, MaxChain>(users, items_t, excl, cand_v, cand_i,
                                       ghost, n_users, d, i_pad, block_i,
                                       stream);
    case 8:
      return launch_chain<8, MaxChain>(users, items_t, excl, cand_v, cand_i,
                                       ghost, n_users, d, i_pad, block_i,
                                       stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
