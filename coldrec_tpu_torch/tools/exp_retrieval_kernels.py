"""Kernel-variant experiments for the retrieval sweep, on the card.

The port's counterpart of ``tools/exp_retrieval_kernels.py``. It times
isolated variants of the sweep to locate where the production kernel's time
goes. Each variant is a hand-written CUDA kernel
(``coldrec_tpu_torch/csrc/exp_retrieval_kernels.cu``) beside its plain
PyTorch version:
  dotonly   — scores + a running per-lane-class max only (the ceiling),
              items as (I, d)
  dotonly_t — the same with the transposed (d, I) item table
  stream2d  — the TPU kernel's algorithm: per block of ``block_i`` items
              each lane class's top-2 (the 3rd-best value into the ghost),
              then both into the sorted 8-slot cascade
  prod      — the port's production kernel (``ops/cuda/retrieval.py``)

Usage:
    python -m coldrec_tpu_torch.tools.exp_retrieval_kernels [--items 270336]
        [--users 1024] [--dim 64] [--iters 16] [--block_i 2048]
        [--only dotonly,stream2d,prod] [--device cuda]

Items are padded with zeros to a multiple of ``block_i`` (pad items are
excluded from stream2d and prod, and count in dotonly's max). ``--tile_u``
is taken for the JAX tool's command line: the CUDA kernels choose their own
user tile, which changes no result here. With ``--device cpu`` every variant
computes its plain version and the times are the host's.

Every wrapper launches its kernel for CUDA tensors and counts the launch in
``<wrapper>.launches``; for CPU tensors it computes the plain version. It
never falls back from a CUDA tensor.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cuda.build import launch, sweep_parts
from ..ops.cuda.retrieval import (
    CANDIDATES, INIT_NEG, LANES, NEG, SLOTS, _check_sweep_inputs,
    _round_up, empty_candidates, fused_sweep,
)
from ..runtime.eval import exact_scores
from ..utils.timing import time_ms

DOT_CHUNK = 1024  # users per score plane in dot_sweep_reference


def kernel_device(t: torch.Tensor, name: str) -> bool:
    """True when ``t`` lies on a card (launch the kernel), False on the CPU
    (compute the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no {name} kernel for device {t.device}")


def check_blocks(i_pad: int, block_i: int) -> None:
    """``block_i`` must be a positive multiple of 128 that divides I_pad:
    the TPU grid ``i_pad // block_i`` would drop a ragged tail silently."""
    if block_i <= 0 or block_i % LANES or i_pad % block_i:
        raise ValueError(
            f"block_i={block_i} must be a positive multiple of {LANES} "
            f"that divides I_pad={i_pad}"
        )


# ------------------------------------------------------------------ dotonly
def _check_dot_inputs(users, items, transposed):
    if users.dtype != torch.float32 or items.dtype != torch.float32:
        raise TypeError(
            f"dot_sweep takes float32 tables, got {users.dtype}/{items.dtype}")
    if users.dim() != 2 or items.dim() != 2:
        raise ValueError("users (B, d), items (I_pad, d) or (d, I_pad)")
    d, i_pad = items.shape if transposed else items.shape[::-1]
    if users.shape[1] != d:
        raise ValueError(f"users width {users.shape[1]} != item width {d}")
    if i_pad % LANES:
        raise ValueError(f"I_pad={i_pad} must be a multiple of {LANES}")
    if users.device != items.device:
        raise ValueError("users and items must be on one device")
    if not (users.is_contiguous() and items.is_contiguous()):
        raise ValueError("dot_sweep takes contiguous tensors")


def dot_sweep(users: torch.Tensor, items: torch.Tensor,
              transposed: bool = False) -> torch.Tensor:
    """(B, 128) f32: per user and lane class c, the max score over the
    items with id % 128 == c. ``items`` is (I_pad, d), or (d, I_pad) with
    ``transposed``. No exclusion: pad items count."""
    _check_dot_inputs(users, items, transposed)
    if not kernel_device(users, "dot_sweep"):
        return dot_sweep_reference(users, items, transposed)
    b, d = users.shape
    i_pad = items.shape[1] if transposed else items.shape[0]
    out = torch.empty((b, LANES), dtype=torch.float32, device=users.device)
    parts = sweep_parts("coldrec_dot_sweep_parts", users.device, b, d,
                        i_pad)
    scratch = (torch.empty((parts, b, LANES), dtype=torch.float32,
                           device=users.device) if parts > 1 else None)
    launch("coldrec_dot_sweep", users.device, users.data_ptr(),
           items.data_ptr(), out.data_ptr(),
           None if scratch is None else scratch.data_ptr(), b, d, i_pad,
           int(transposed), parts)
    dot_sweep.launches += 1
    return out


dot_sweep.launches = 0


def dot_sweep_reference(users: torch.Tensor, items: torch.Tensor,
                        transposed: bool = False) -> torch.Tensor:
    """Plain version: exact fp32 scores in user chunks, viewed as
    (B, I_pad/128, 128) lane classes, max over the classes' items."""
    items = items.T if transposed else items
    b = users.shape[0]
    out = torch.empty((b, LANES), dtype=torch.float32, device=users.device)
    for s in range(0, b, DOT_CHUNK):
        e = min(b, s + DOT_CHUNK)
        out[s:e] = exact_scores(users[s:e], items).view(
            e - s, -1, LANES).amax(1)
    return out


# ----------------------------------------------------------------- stream2d
# The block-local top-2 chains of the TPU kernels, over (B, 128) lane
# classes: a chain is (m1, m2, m3, a1, a2), values m1 >= m2 at slice
# indices a1, a2 and m3, the largest value dropped. Each variant keeps NaN
# as its own JAX tool's arithmetic does; ``>`` and ``==`` on NaN are false.
def new_chain(b: int, device):
    m = torch.full((b, LANES), INIT_NEG, dtype=torch.float32, device=device)
    a = torch.zeros((b, LANES), dtype=torch.int64, device=device)
    return m, m, m, a, a


def stream_push(chain, c, s: int):
    """The stream chain (``tools/exp_retrieval_kernels.py::_stream_kernel``,
    also the skip kernel's) for the values c of slice s: strict ``>``, so
    the earliest slice wins a tie, and a NaN never enters m1 or m2 but
    turns m3 NaN (``maximum``)."""
    m1, m2, m3, a1, a2 = chain
    gt1, gt2 = c > m1, c > m2
    return (torch.where(gt1, c, m1),
            torch.where(gt1, m1, torch.where(gt2, c, m2)),
            torch.maximum(m3, torch.where(gt2, m2, c)),
            torch.where(gt1, s, a1),
            torch.where(gt1, a1, torch.where(gt2, s, a2)))


def max_push(chain, c, s: int):
    """The multiacc chain (``tools/exp_multiacc.py::_multiacc_kernel``),
    written with ``maximum`` and ``minimum``: the same values as the stream
    chain on finite scores, but a NaN makes m1, m2 and m3 NaN for the rest
    of the block (ids stay as they were)."""
    m1, m2, m3, a1, a2 = chain
    gt1, gt2 = c > m1, c > m2
    return (torch.maximum(c, m1),
            torch.where(gt1, m1, torch.maximum(c, m2)),
            torch.maximum(m3, torch.minimum(c, m2)),
            torch.where(gt1, s, a1),
            torch.where(gt1, a1, torch.where(gt2, s, a2)))


def merge_two(ca, cb):
    """``tools/exp_multiacc.py::_merge_two``: the top-2 of two chains over
    disjoint slices, equal values keeping the lower slice. On a NaN m1 it
    is not symmetric: the second chain wins (a NaN there wins, a NaN in the
    first loses)."""
    m1a, m2a, m3a, a1a, a2a = ca
    m1b, m2b, m3b, a1b, a2b = cb
    w = (m1a > m1b) | ((m1a == m1b) & (a1a < a1b))
    lo1, lo1a = torch.where(w, m1b, m1a), torch.where(w, a1b, a1a)
    wm2, wm2a = torch.where(w, m2a, m2b), torch.where(w, a2a, a2b)
    w2 = (lo1 > wm2) | ((lo1 == wm2) & (lo1a < wm2a))
    d2 = torch.where(w2, wm2, lo1)  # the third of the four tops, dropped
    lm2 = torch.where(w, m2b, m2a)  # the losing chain's second, dropped
    return (torch.where(w, m1a, m1b), torch.where(w2, lo1, wm2),
            torch.maximum(torch.maximum(m3a, m3b), torch.maximum(d2, lm2)),
            torch.where(w, a1a, a1b), torch.where(w2, lo1a, wm2a))


def block_tops(z: torch.Tensor, p_acc: int = 1, push=stream_push):
    """A TPU kernel's extraction of a (B, block_i) score block, literally:
    slice s (items s*128 .. s*128+127 of the block, in order) feeds chain
    s % p_acc through ``push``, then the chains are merged pairwise,
    (0, 1), (2, 3), ... and then the pairs' results, with ``merge_two``.
    Returns (m1, a1, m2, a2, m3), (B, 128) each."""
    b, block_i = z.shape
    zz = z.view(b, block_i // LANES, LANES)
    chains = [new_chain(b, z.device) for _ in range(p_acc)]
    for s in range(zz.shape[1]):
        chains[s % p_acc] = push(chains[s % p_acc], zz[:, s], s)
    while len(chains) > 1:
        chains = [merge_two(chains[i], chains[i + 1])
                  for i in range(0, len(chains) - 1, 2)] + (
                      [chains[-1]] if len(chains) % 2 else [])
    m1, m2, m3, a1, a2 = chains[0]
    return m1, a1, m2, a2, m3


def merge_slots(rv, ri, gh, m1, i1, m2, i2, m3):
    """The TPU kernel's cascade of m1, then m2, into the sorted slots
    (B, SLOTS, 128), slot by slot with a strict ``>``. The ghost takes m3
    and both evictions. This is not a stable merge: a displaced incumbent
    is carried on past the slots that equal it, so tied ids can change
    order and a different one of them can be evicted."""
    rv, ri = list(rv.unbind(1)), list(ri.unbind(1))
    gh = torch.maximum(gh, m3)
    for cv, ci in ((m1, i1), (m2, i2)):
        for s in range(SLOTS):
            swap = cv > rv[s]
            rv[s], cv = (torch.where(swap, cv, rv[s]),
                         torch.where(swap, rv[s], cv))
            ri[s], ci = (torch.where(swap, ci, ri[s]),
                         torch.where(swap, ri[s], ci))
        gh = torch.maximum(gh, cv)
    return torch.stack(rv, 1), torch.stack(ri, 1), gh


def new_slots(b: int, device):
    """Empty running state: slots (INIT_NEG, id 0) and ghosts INIT_NEG."""
    return (
        torch.full((b, SLOTS, LANES), INIT_NEG, dtype=torch.float32,
                   device=device),
        torch.zeros((b, SLOTS, LANES), dtype=torch.int64, device=device),
        torch.full((b, LANES), INIT_NEG, dtype=torch.float32, device=device),
    )


def block_scores(users, items_t, excluded, j: int, block_i: int):
    """Exact fp32 scores of block j, excluded items set to NEG."""
    cols = slice(j * block_i, (j + 1) * block_i)
    return exact_scores(users, items_t[:, cols].T).masked_fill(
        excluded[None, cols], NEG)


def block_candidates(z, j: int, block_i: int, p_acc: int = 1,
                     push=stream_push):
    """(m1, id1, m2, id2, m3) of block j's scores (``block_tops``): ids
    are j*block_i + slice*128 + lane."""
    m1, a1, m2, a2, m3 = block_tops(z, p_acc, push)
    base = j * block_i + torch.arange(LANES, device=z.device)
    return m1, base + a1 * LANES, m2, base + a2 * LANES, m3


def as_candidates(rv, ri, gh):
    """(B, SLOTS, 128) state -> the (B, 1024) f32 / i32 + (B, 128) layout,
    column s*128 + c holding slot s of lane class c."""
    b = rv.shape[0]
    return (rv.reshape(b, CANDIDATES),
            ri.to(torch.int32).reshape(b, CANDIDATES), gh)


def stream_sweep(users: torch.Tensor, items_t: torch.Tensor,
                 excl: torch.Tensor, block_i: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cand_v (B, 1024) f32, cand_i (B, 1024) i32, ghost (B, 128) f32) of
    the TPU kernel's streaming top-2 sweep over blocks of ``block_i``
    items. users (B, d), items_t (d, I_pad), excl (I_pad,) int8."""
    _check_sweep_inputs(users, items_t, excl, "stream_sweep")
    check_blocks(items_t.shape[1], block_i)
    if not kernel_device(users, "stream_sweep"):
        return stream_sweep_reference(users, items_t, excl, block_i)
    b, d = users.shape
    cand_v, cand_i, ghost = empty_candidates(b, users.device)
    launch("coldrec_stream_sweep", users.device, users.data_ptr(),
           items_t.data_ptr(), excl.data_ptr(), cand_v.data_ptr(),
           cand_i.data_ptr(), ghost.data_ptr(), b, d, items_t.shape[1],
           block_i)
    stream_sweep.launches += 1
    return cand_v, cand_i, ghost


stream_sweep.launches = 0


def stream_sweep_reference(users, items_t, excl, block_i, p_acc=1,
                           push=stream_push):
    """Plain version: per block, the chains of ``block_tops`` over the
    slices (one stream chain; multiacc's plain version passes its own),
    then the TPU cascade of m1 and m2 into the slots, block after block."""
    rv, ri, gh = new_slots(users.shape[0], users.device)
    excluded = excl.bool()
    for j in range(items_t.shape[1] // block_i):
        z = block_scores(users, items_t, excluded, j, block_i)
        rv, ri, gh = merge_slots(
            rv, ri, gh, *block_candidates(z, j, block_i, p_acc, push))
    return as_candidates(rv, ri, gh)


# ------------------------------------------------------------------- timing
def graph_ms(fn, iters: int, device, repeats: int = 3) -> float:
    """Best milliseconds per call of ``iters`` calls of ``fn`` captured in
    one CUDA graph and replayed, timed with CUDA events: the device time
    without the host's cost per launch (checks, allocations, the ctypes
    call). What ``fn`` allocates comes from the graph's pool at capture,
    not in the timed replay. On the CPU: ``time_ms``."""
    device = torch.device(device)
    if device.type != "cuda":
        return time_ms(fn, iters, device, repeats)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu (plain versions)"


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--users", type=int, default=1024)
    p.add_argument("--items", type=int, default=270336)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--iters", type=int, default=16)
    p.add_argument("--tile_u", type=int, default=256)
    p.add_argument("--block_i", type=int, default=2048)
    p.add_argument("--only", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    only = set(filter(None, args.only.split(",")))
    dev = resolve_device(args.device)

    n_users, n_items, d = args.users, args.items, args.dim
    bi = args.block_i
    pairs = n_users * n_items
    rng = np.random.default_rng(0)
    ue = rng.standard_normal((n_users, d)).astype(np.float32)
    ie = rng.standard_normal((n_items, d)).astype(np.float32)
    excl = np.zeros(n_items, np.int8)
    excl[rng.choice(n_items, n_items // 5, replace=False)] = 1
    i_pad = _round_up(n_items, bi)
    items = torch.zeros((i_pad, d), dtype=torch.float32, device=dev)
    items[:n_items] = torch.as_tensor(ie, device=dev)
    items_t = items.T.contiguous()
    excl_row = torch.ones(i_pad, dtype=torch.int8, device=dev)
    excl_row[:n_items] = torch.as_tensor(excl, device=dev)
    users = torch.as_tensor(ue, device=dev)
    print(f"device={device_name(dev)} B={n_users} I={n_items} d={d} "
          f"tile_u={args.tile_u} block_i={bi}", flush=True)

    def report(name, ms):
        print(f"{name:<28s} {pairs / (ms * 1e-3) / 1e9:10.1f} G pairs/s   "
              f"({ms * 1e3:8.1f} us)", flush=True)

    if not only or "dotonly" in only:
        report("dot+rowmax", time_ms(
            lambda: dot_sweep(users, items, False), args.iters, dev))
        report("dot+rowmax (items^T)", time_ms(
            lambda: dot_sweep(users, items_t, True), args.iters, dev))
    if not only or "stream2d" in only:
        report("stream2d full", time_ms(
            lambda: stream_sweep(users, items_t, excl_row, bi), args.iters,
            dev))
    if not only or "prod" in only:
        report("prod kernel (no resolve)", time_ms(
            lambda: fused_sweep(users, items_t, excl_row), args.iters, dev))


if __name__ == "__main__":
    main()
