"""Block-skip experiment on the streaming sweep, on the card.

The port's counterpart of ``tools/exp_blockskip.py``. Hypothesis under
test: compute each item block's max first and skip the block's top-2
extraction when the max cannot beat the running candidate floor. The skip
is decided per tile of ``tile_u`` users: it fires only when ALL users of the
tile are dominated, so the tile size is part of the function. On the TPU a
256-user tile was one grid program. The CUDA kernel
(``coldrec_tpu_torch/csrc/exp_blockskip.cu``) scores each block once on the
shared product tile of ``csrc/sweep_tile.cuh``: a CTA holds 16 users, and a
tile of more spans a thread-block cluster whose CTAs combine the predicate
through distributed shared memory (``skip_layout``).

The experiment measures:
  * two floors: rv[0], the min over lanes of each lane's top value, and
    rv[7], the min over lanes of the 8th value (weaker, earlier in the
    stream);
  * tile_u in {256, 64};
  * three table regimes: iid normal, popularity-skewed norms in arbitrary
    item order, and norm-sorted item order (the best case).

Exactness is unconditional by the ghost argument: a skipped block's values
are all "discarded" and the ghost takes the block max, so any user whose
true top-k lost an item that way is flagged by ``_resolve``;
``check_exact`` asserts that rows flagged by neither sweep have the
production kernel's lists.

Usage:
    python -m coldrec_tpu_torch.tools.exp_blockskip [--items 270336]
        [--users 4096] [--block_i 8192] [--iters 16] [--device cuda]

(The JAX tool's ``--interpret`` has no counterpart: ``--device cpu`` runs
the plain versions.)
"""
from __future__ import annotations

import argparse
import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cuda.build import launch, load_library
from ..ops.cuda.retrieval import (
    SLOTS, _check_sweep_inputs, _resolve, _round_up, _torch_tie_order,
    empty_candidates, fused_sweep,
)
from .exp_retrieval_kernels import (
    as_candidates, block_candidates, block_scores, check_blocks, device_name,
    kernel_device, merge_slots, new_slots, time_ms,
)

DIM = 64
TOP_K = 20
MAX_RATED = 64
USER_GROUP = 4  # tile_u is a multiple of this
CTA_TILES = (16, 32)  # the kernel's CTA tiles (users)
MAX_CLUSTER = 16  # CTAs of a cluster on an H100 (non-portable above 8)


def _check_skip_args(tile_u, floor_slot):
    if tile_u <= 0 or tile_u % USER_GROUP:
        raise ValueError(
            f"tile_u={tile_u} must be a positive multiple of {USER_GROUP}")
    if not 0 <= floor_slot < SLOTS:
        raise ValueError(f"floor_slot={floor_slot} must be in [0, {SLOTS})")


class SkipLayout(NamedTuple):
    """How the skip kernel lays ``b_pad`` users out in tiles of
    ``tile_u``: ``cta_tile`` users in a CTA's tile (the kernel instance);
    with ``cluster`` 1, each CTA holds ``cta_users`` rows (whole tiles), and
    otherwise a tile spans ``cluster`` CTAs, rank r holding its rows
    r*cta_tile .. (the last rank the rest); ``ctas`` in all."""
    cta_tile: int
    cta_users: int
    cluster: int
    ctas: int


def skip_layout(tile_u: int, b_pad: int) -> SkipLayout:
    """The kernel's layout for tiles of ``tile_u`` users (a positive
    multiple of 4 dividing ``b_pad``): the 16-user CTA tile up to tiles of
    16 x 16 users, the 32-user one above. A tile of more than 512 users
    needs a cluster of more than ``MAX_CLUSTER`` CTAs, which the card
    refuses at launch."""
    _check_skip_args(tile_u, 0)
    if b_pad <= 0 or b_pad % tile_u:
        raise ValueError(f"b_pad={b_pad} must be a positive multiple of "
                         f"tile_u={tile_u}")
    small, large = CTA_TILES
    cta_tile = small if tile_u <= small * MAX_CLUSTER else large
    if tile_u <= cta_tile:
        cta_users = cta_tile // tile_u * tile_u
        return SkipLayout(cta_tile, cta_users, 1, -(-b_pad // cta_users))
    cluster = -(-tile_u // cta_tile)
    return SkipLayout(cta_tile, cta_tile, cluster, b_pad // tile_u * cluster)


def skip_sweep(users: torch.Tensor, items_t: torch.Tensor,
               excl: torch.Tensor, tile_u: int, block_i: int,
               floor_slot: int):
    """(cand_v (B, 1024) f32, cand_i (B, 1024) i32, ghost (B, 128) f32,
    skips (ceil(B / tile_u),) i32): the streaming sweep over blocks of
    ``block_i`` items, skipping the extraction of a block when every user of
    a ``tile_u`` tile has a block max below its floor, the min over lanes
    of slot ``floor_slot``. Users are padded with zero rows to a multiple
    of ``tile_u`` (pad rows take part in the predicate); their rows are not
    returned. ``skips`` counts each tile's skipped blocks."""
    _check_sweep_inputs(users, items_t, excl, "skip_sweep")
    check_blocks(items_t.shape[1], block_i)
    _check_skip_args(tile_u, floor_slot)
    b, d = users.shape
    b_pad = _round_up(b, tile_u)
    if b_pad != b:
        users = torch.cat([users, users.new_zeros((b_pad - b, d))])
    if not kernel_device(users, "skip_sweep"):
        out = skip_sweep_reference(users, items_t, excl, tile_u, block_i,
                                   floor_slot)
    else:
        cand_v, cand_i, ghost = empty_candidates(b_pad, users.device)
        skips = torch.empty(b_pad // tile_u, dtype=torch.int32,
                            device=users.device)
        layout = skip_layout(tile_u, b_pad)
        launch("coldrec_skip_sweep", users.device, users.data_ptr(),
               items_t.data_ptr(), excl.data_ptr(), cand_v.data_ptr(),
               cand_i.data_ptr(), ghost.data_ptr(), skips.data_ptr(), b_pad,
               d, items_t.shape[1], block_i, tile_u, floor_slot,
               layout.cta_tile, layout.cta_users, layout.cluster)
        skip_sweep.launches += 1
        out = (cand_v, cand_i, ghost, skips)
    return tuple(t[:b] for t in out[:3]) + (out[3],)


skip_sweep.launches = 0


def max_active_clusters(device, d: int, tile_u: int, b_pad: int) -> int:
    """How many clusters of ``skip_layout(tile_u, b_pad)`` the card holds
    at once at depth ``d`` (cudaOccupancyMaxActiveClusters): a grid of more
    runs in waves."""
    layout = skip_layout(tile_u, b_pad)
    lib = load_library()
    with torch.cuda.device(device):
        n = lib.coldrec_skip_max_clusters(d, layout.cta_tile, layout.cluster)
    if n < 0:
        raise RuntimeError("coldrec_skip_max_clusters failed")
    return n


def skip_sweep_reference(users_pad, items_t, excl, tile_u, block_i,
                         floor_slot):
    """Plain version over users already padded to a multiple of
    ``tile_u``: the stream sweep's plain version, where before each block a
    tile whose users all have a block max below their floor keeps its slots
    and only raises its ghosts to the block max."""
    b_pad = users_pad.shape[0]
    rv, ri, gh = new_slots(b_pad, users_pad.device)
    skips = torch.zeros(b_pad // tile_u, dtype=torch.int32,
                        device=users_pad.device)
    excluded = excl.bool()
    for j in range(items_t.shape[1] // block_i):
        z = block_scores(users_pad, items_t, excluded, j, block_i)
        bmax = z.amax(dim=1)
        floor = rv[:, floor_slot].amin(dim=1)
        skip_tile = (bmax < floor).view(-1, tile_u).all(dim=1)
        skips += skip_tile.to(torch.int32)
        skip = skip_tile.repeat_interleave(tile_u)
        nv, ni, ng = merge_slots(rv, ri, gh, *block_candidates(z, j, block_i))
        rv = torch.where(skip[:, None, None], rv, nv)
        ri = torch.where(skip[:, None, None], ri, ni)
        gh = torch.where(skip[:, None], torch.maximum(gh, bmax[:, None]), ng)
    return as_candidates(rv, ri, gh) + (skips,)


def _pad_inputs(ue, ie, tile_u, block_i, device="cuda"):
    """users (B_pad, d) and items_t (d, I_pad) zero-padded, excl (I_pad,)
    int8 excluding only the pad items, on ``device``."""
    dev = resolve_device(device)
    n_users, d = ue.shape
    n_items = ie.shape[0]
    i_pad = _round_up(n_items, block_i)
    b_pad = _round_up(n_users, tile_u)
    users = torch.zeros((b_pad, d), dtype=torch.float32, device=dev)
    users[:n_users] = torch.as_tensor(ue, device=dev)
    items_t = torch.zeros((d, i_pad), dtype=torch.float32, device=dev)
    items_t[:, :n_items] = torch.as_tensor(ie, device=dev).T
    excl = torch.ones(i_pad, dtype=torch.int8, device=dev)
    excl[:n_items] = 0
    return users, items_t, excl


def check_exact(ue, ie, rat, tile_u, block_i, floor_slot, device="cuda"):
    """Final (vals, ids) of rows that neither sweep flags must equal the
    production kernel's. Returns the flag counts and the skip rate."""
    n_users, n_items = ue.shape[0], ie.shape[0]
    users, items_t, excl = _pad_inputs(ue, ie, tile_u, block_i, device)
    rated = torch.full((users.shape[0], rat.shape[1]), n_items,
                       dtype=torch.int32, device=users.device)
    rated[:n_users] = torch.as_tensor(rat, device=users.device)
    v0, i0, s0 = _resolve(*fused_sweep(users, items_t, excl), rated, TOP_K)
    cv1, ci1, gh1, sk = skip_sweep(users, items_t, excl, tile_u, block_i,
                                   floor_slot)
    v1, i1, s1 = _resolve(cv1, ci1, gh1, rated, TOP_K)
    # unflagged rows must agree exactly; flagged rows go to the exact
    # fallback in production, so any flag pattern is correct, but count it
    v0, i0 = _torch_tie_order(v0.cpu().numpy(), i0.cpu().numpy())
    v1, i1 = _torch_tie_order(v1.cpu().numpy(), i1.cpu().numpy())
    s0, s1 = s0.cpu().numpy(), s1.cpu().numpy()
    ok_rows = ~(s0 | s1)
    if not (np.array_equal(v1[ok_rows], v0[ok_rows])
            and np.array_equal(i1[ok_rows], i0[ok_rows])):
        raise AssertionError(
            f"tile_u={tile_u} floor=rv[{floor_slot}]: unflagged rows differ "
            "from the production kernel's")
    n_blocks = items_t.shape[1] // block_i
    return {
        "flags_prod": int(s0[:n_users].sum()),
        "flags_skip": int(s1[:n_users].sum()),
        "skip_rate": float(sk.float().mean().item() / n_blocks),
    }


def bench(sweep_fn, ue, ie, tile_u, block_i, iters=16, device="cuda"):
    """G pairs/s of ``sweep_fn(users, items_t, excl)`` on the padded
    tables."""
    users, items_t, excl = _pad_inputs(ue, ie, tile_u, block_i, device)
    ms = time_ms(lambda: sweep_fn(users, items_t, excl), iters, users.device)
    return ue.shape[0] * ie.shape[0] / (ms * 1e-3) / 1e9


def make_tables(regime, n_users, n_items, rng):
    """The JAX tool's tables from the same numpy generator, bit for bit
    (numpy arrays)."""
    ue = rng.standard_normal((n_users, DIM)).astype(np.float32)
    ie = rng.standard_normal((n_items, DIM)).astype(np.float32)
    if regime in ("skew", "skew_sorted"):
        # popularity-skewed norms: zipf-ish scale, heavy head
        scale = (1.0 / np.arange(1, n_items + 1) ** 0.35).astype(np.float32)
        rng.shuffle(scale)
        ie *= scale[:, None] * 3.0
    if regime == "skew_sorted":
        order = np.argsort(-np.linalg.norm(ie, axis=1))
        ie = ie[order]
    return ue, ie


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--users", type=int, default=4096)
    p.add_argument("--items", type=int, default=270336)
    p.add_argument("--block_i", type=int, default=8192)
    p.add_argument("--iters", type=int, default=16)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    print(f"device={device_name(dev)} B={args.users} I={args.items} d={DIM} "
          f"block_i={args.block_i}", flush=True)

    rat = np.full((args.users, MAX_RATED), args.items, dtype=np.int32)
    for u in range(args.users):
        n = rng.integers(MAX_RATED // 4, MAX_RATED)
        rat[u, :n] = rng.choice(args.items, n, replace=False)

    for regime in ("iid", "skew", "skew_sorted"):
        ue, ie = make_tables(regime, args.users, args.items, rng)
        prod = bench(fused_sweep, ue, ie, 256, args.block_i, args.iters, dev)
        print(f"[{regime}] production: {prod:.1f} G pairs/s", flush=True)
        for tile_u in (256, 64):
            for floor_slot in (0, SLOTS - 1):
                stats = check_exact(ue, ie, rat, tile_u, args.block_i,
                                    floor_slot, dev)
                sweep = functools.partial(skip_sweep, tile_u=tile_u,
                                          block_i=args.block_i,
                                          floor_slot=floor_slot)
                thr = bench(sweep, ue, ie, tile_u, args.block_i, args.iters,
                            dev)
                print(
                    f"[{regime}] skip tile={tile_u} floor=rv[{floor_slot}]: "
                    f"{thr:.1f} G pairs/s  skip_rate={stats['skip_rate']:.3f} "
                    f"flags prod={stats['flags_prod']} "
                    f"skip={stats['flags_skip']}", flush=True
                )


if __name__ == "__main__":
    main()
