"""Experiment: P-way strided accumulator groups in the streaming sweep, on
the card.

The port's counterpart of ``tools/exp_multiacc.py``. The TPU's streaming
top-2 extraction was recorded as bound by the latency of its m1/m2
dependency chain; P independent accumulator groups (group p owns the item
slices s with s % P == p, merged into the exact block top-2 and 3rd-best
ghost once per block) ask the same question of the card: how much
instruction-level parallelism is missing. The CUDA kernel
(``coldrec_tpu_torch/csrc/exp_multiacc.cu``) runs on the shared product
tile of ``csrc/sweep_tile.cuh``, the one the production sweep runs on; P
changes the chains and, through their registers, the tile's users per
CTA.

On tables without NaN the merge is value- and id-identical to the single
chain, so ``multiacc_sweep`` then computes the same function as
``exp_retrieval_kernels.stream_sweep`` for every P. A NaN score does not
take the same way: the JAX kernel writes its chain with ``maximum`` and
``minimum``, so a NaN makes its chain NaN for the rest of the block (it
adds nothing to the slots and turns the ghost NaN), and ``_merge_two``
lets a NaN in the higher chain win. On NaN tables the result therefore
depends on P and on which slices share a chain (slice s of a block feeds
chain s % P), as in JAX; the plain version and the kernel follow that
arithmetic.

Usage:
    python -m coldrec_tpu_torch.tools.exp_multiacc [--check] [--users 4096]
        [--items 270336] [--tile_u 256] [--block_i 8192] [--iters 16]
        [--device cuda]

``--tile_u`` pads the users as the JAX tool does; the CUDA kernel chooses
its own user tile per P (16 users at P = 1 and 2, 8 at P = 4, 4 at P = 8),
which changes no result.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cuda.build import launch
from ..ops.cuda.retrieval import (
    _check_sweep_inputs, _resolve, _round_up, empty_candidates, fused_sweep,
)
from .exp_retrieval_kernels import (
    check_blocks, device_name, kernel_device, max_push, stream_sweep,
    stream_sweep_reference, time_ms,
)

DIM = 64
TOP_K = 20
MAX_RATED = 64
P_ACC = (1, 2, 4, 8)  # the kernel's instances


def multiacc_sweep(users: torch.Tensor, items_t: torch.Tensor,
                   excl: torch.Tensor, block_i: int, p_acc: int):
    """(cand_v (B, 1024) f32, cand_i (B, 1024) i32, ghost (B, 128) f32):
    the streaming sweep over blocks of ``block_i`` items with ``p_acc``
    strided accumulator groups merged once per block."""
    _check_sweep_inputs(users, items_t, excl, "multiacc_sweep")
    check_blocks(items_t.shape[1], block_i)
    if p_acc not in P_ACC:
        raise ValueError(f"p_acc={p_acc} must be one of {P_ACC}")
    if not kernel_device(users, "multiacc_sweep"):
        return multiacc_sweep_reference(users, items_t, excl, block_i, p_acc)
    b, d = users.shape
    cand_v, cand_i, ghost = empty_candidates(b, users.device)
    launch("coldrec_multiacc_sweep", users.device, users.data_ptr(),
           items_t.data_ptr(), excl.data_ptr(), cand_v.data_ptr(),
           cand_i.data_ptr(), ghost.data_ptr(), b, d, items_t.shape[1],
           block_i, p_acc)
    multiacc_sweep.launches += 1
    return cand_v, cand_i, ghost


multiacc_sweep.launches = 0


def multiacc_sweep_reference(users, items_t, excl, block_i, p_acc):
    """Plain version: the JAX kernel's arithmetic, literally (``max_push``
    chains fed slice s % ``p_acc`` of each block, ``merge_two``), vectorised
    over (B, 128) and looping over the slices."""
    return stream_sweep_reference(users, items_t, excl, block_i, p_acc,
                                  max_push)


def make_inputs(n_users, n_items, tile_u, block_i, seed=0, device="cuda"):
    """The JAX tool's tables from the same numpy stream, bit for bit:
    users (B_pad, 64) zero-padded to a multiple of ``tile_u``, items_t
    (64, I_pad) zero-padded to a multiple of ``block_i``, excl (I_pad,)
    int8 (the JAX tool's (1, I_pad) row; 20% of the items and every pad
    item excluded) and rated (B_pad, 64) int32 padded with n_items."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    i_pad = _round_up(n_items, block_i)
    b_pad = _round_up(n_users, tile_u)
    users = np.zeros((b_pad, DIM), np.float32)
    users[:n_users] = rng.standard_normal((n_users, DIM)).astype(np.float32)
    items_t = np.zeros((DIM, i_pad), np.float32)
    items_t[:, :n_items] = rng.standard_normal(
        (n_items, DIM)).astype(np.float32).T
    excl = np.ones(i_pad, np.int8)
    live = np.ones(n_items, np.int8)
    live[rng.choice(n_items, n_items // 5, replace=False)] = 0
    excl[:n_items] = 1 - live
    rated = np.full((b_pad, MAX_RATED), n_items, np.int32)
    for u in range(n_users):
        n = rng.integers(MAX_RATED // 4, MAX_RATED)
        rated[u, :n] = rng.choice(n_items, n, replace=False)
    return tuple(torch.as_tensor(a, device=dev)
                 for a in (users, items_t, excl, rated))


def check(n_users=1024, n_items=24576, tile_u=256, block_i=2048,
          device="cuda"):
    """multiacc at P = 2 and 4 must equal the stream sweep bit for bit (the
    tables hold no NaN), and so must their resolved top-k lists and
    exactness flags."""
    users, items_t, excl, rated = make_inputs(n_users, n_items, tile_u,
                                              block_i, device=device)
    ref = stream_sweep(users, items_t, excl, block_i)
    rv, ri, rs = _resolve(*ref, rated, TOP_K)
    for p in (2, 4):
        got = multiacc_sweep(users, items_t, excl, block_i, p)
        for name, a, b in zip("cv ci gh".split(), ref, got):
            if not torch.equal(a, b):
                bad = (a != b).any(dim=-1).nonzero()[:5, 0].tolist()
                raise AssertionError(
                    f"P={p} {name} MISMATCH rows {bad} (first: "
                    f"{a[bad[0]][:8].tolist()} vs {b[bad[0]][:8].tolist()})")
        gv, gi, gs = _resolve(*got, rated, TOP_K)
        if not (torch.equal(rv, gv) and torch.equal(ri, gi)
                and torch.equal(rs, gs)):
            raise AssertionError(f"P={p}: resolved lists differ")
        print(f"P={p}: bit-identical to the stream sweep "
              f"(flag rate {gs.float().mean().item():.4f})", flush=True)


def bench(n_users, n_items, tile_u, block_i, iters=16, device="cuda"):
    """Milliseconds per sweep of the production kernel and of P = 1, 2, 4,
    8."""
    users, items_t, excl, _ = make_inputs(n_users, n_items, tile_u, block_i,
                                          device=device)
    dev = users.device
    pairs = n_users * n_items
    print(f"device={device_name(dev)} B={n_users} I={n_items} d={DIM} "
          f"block_i={block_i}", flush=True)
    t = time_ms(lambda: fused_sweep(users, items_t, excl), iters, dev)
    print(f"prod: raw {pairs / t / 1e6:.1f} G pairs/s ({t:.2f} ms)",
          flush=True)
    for p in P_ACC:
        t = time_ms(lambda: multiacc_sweep(users, items_t, excl, block_i, p),
                    iters, dev)
        print(f"P={p} block_i={block_i}: raw {pairs / t / 1e6:.1f} G pairs/s"
              f" ({t:.2f} ms)", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--users", type=int, default=4096)
    ap.add_argument("--items", type=int, default=270336)
    ap.add_argument("--tile_u", type=int, default=256)
    ap.add_argument("--block_i", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.check:
        check(device=args.device)
    else:
        bench(args.users, args.items, args.tile_u, args.block_i, args.iters,
              args.device)


if __name__ == "__main__":
    main()
