"""The retrieval sweep beside its ceilings and the plain path, on the card.

    python -m coldrec_tpu_torch.tools.ubench_sweep [--users 1024[,4096...]]
        [--items 270336] [--d 64[,256...]] [--dtype fp32,bf16] [--k 20]
        [--rated 64] [--iters 10] [--out FILE.json]
        [--device cuda]

One tool for four of the JAX package's: ``tools/ubench_retrieval.py``,
``tools/exp_bf16_isolate.py``, ``tools/exp_d256_bf16.py`` and
``tools/ubench_kernel_variants.py``. At each (users, d) of the grid, on
``ubench_retrieval``'s tables (N(0,1) users and items from seed 0, each
user rated on R/4 to R random items, a fifth of the items excluded), it
times with CUDA events (best of 3 runs of ``--iters`` calls after a
warm-up), for each ``--dtype``:

  * ``mm_rowmax``: the score matmul with a cheap consumer, its row max
    (fp32: TF32 off; bf16: the bf16 library matmul) — the ceiling of any
    sweep that computes every score;
  * ``mm_plane`` (fp32): the matmul whose (B, I) plane is read twice (its
    row max and min), so it is written to memory;
  * ``plain_topk`` (fp32): the plain path, the matmul + ``masked_topk``;
  * ``kernel_raw``: ``fused_sweep`` alone on operands padded and cast
    beforehand;
  * ``kernel_padded``: the call as serving pays it, table padded and cast,
    the kernel and ``_resolve`` over every chunk of users
    (``ubench_serving.serve_device``);

each beside its bound (the larger of its operations at the card's rate
for its type, fp32 at 67 TFLOP/s or bf16 at 989 TFLOP/s, and the bytes of
its inputs and outputs at 3.35 TB/s: ``utils/timing.py``) and scored
pairs/s; then the users the ghost flags for the exact fallback. Before
the times, each kernel is held bit for bit against its plain version
on integer tables in [-64, 64] at the same shape (every sum exact in
fp32, every value exact in bf16).

``--d 256`` is ``exp_d256_bf16``'s point, 1024 x 270,336 at d=256, R=64,
fp32 against bf16 beside the matmul ceilings. ``--out`` writes every
figure as JSON (never under ``tools/``). ``--device cpu`` runs the plain
versions by the host clock, which is never a device time.

The bf16 sweep's tile (``csrc/mma_tile.cuh``) has no shape to vary as
``ubench_kernel_variants`` varied ``tile_u`` and ``block_i``: its block is
fixed by the warp layout of ``mma.sync`` (32 users, half the 128 lane
classes) and the TMA box (64 rows x 64 items), and its one choice, where
the users' operand lives, is made by d. The fp32 tile's shapes are
``tools/tile_shapes.py``'s.
"""
from __future__ import annotations

import argparse
import itertools
import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cuda.retrieval import (
    _resolve, fused_sweep, fused_sweep_reference, pad_items,
)
from ..runtime.eval import exact_scores, masked_topk
from ..utils.timing import (
    bf16_bound, bf16_library, clock_name, device_name, sweep_bound,
    sweep_bytes, time_ms,
)
from .ubench_serving import serve_device

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
INT_MAX = 64


def sweep_inputs(device, n_users, n_items, d, rated_width, seed=0):
    """``ubench_retrieval``'s tables: users, items, rated (B, R) padded
    with ``n_items``, the excluded items."""
    rng = np.random.default_rng(seed)
    ue = rng.standard_normal((n_users, d)).astype(np.float32)
    ie = rng.standard_normal((n_items, d)).astype(np.float32)
    rated = np.full((n_users, rated_width), n_items, np.int64)
    nr = rng.integers(rated_width // 4, rated_width, size=n_users)
    for u in range(n_users):
        rated[u, : nr[u]] = rng.choice(n_items, nr[u], replace=False)
    excl = np.zeros(n_items, bool)
    excl[rng.choice(n_items, n_items // 5, replace=False)] = True
    return tuple(torch.as_tensor(a, device=device)
                 for a in (ue, ie, rated, excl))


def check_exact(device, n_users, n_items, d, dtypes=("fp32", "bf16"),
                seed=3) -> dict:
    """{dtype: max abs err} of the kernel against its plain version on
    integer tables in [-64, 64] (a quarter of the items excluded); raises
    unless every output is bit for bit equal."""
    rng = np.random.default_rng(seed)
    users = torch.as_tensor(rng.integers(-INT_MAX, INT_MAX + 1, (
        n_users, d)).astype(np.float32), device=device)
    items = torch.as_tensor(rng.integers(-INT_MAX, INT_MAX + 1, (
        n_items, d)).astype(np.float32), device=device)
    excl = torch.as_tensor(rng.random(n_items) < 0.25, device=device)
    items_t, excl_row = pad_items(items, excl)
    ref = fused_sweep_reference(users, items_t, excl_row)
    out = {}
    for name in dtypes:
        kind = DTYPES[name]
        got = fused_sweep(users.to(kind), items_t.to(kind), excl_row)
        out[name] = max(float((g.double() - r.double()).abs().max())
                        for g, r in zip(got, ref))
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"fused_sweep {name} at {n_users} x "
                                 f"{n_items} d={d} differs from its plain "
                                 f"version on integer tables: {out[name]}")
        print(f"  integer tables {n_users} x {n_items} d={d}: fused_sweep "
              f"{name} bit-equal to its plain version", flush=True)
    return out


def point(device, n_users, n_items, d, dtypes, k=20, rated_width=64,
          iters=10) -> dict:
    """Every form's ms, bound and pairs/s at one (users, items, d)."""
    ue, ie, rated, excl = sweep_inputs(device, n_users, n_items, d,
                                       rated_width)
    res = {"users": n_users, "items": n_items, "d": d, "k": k,
           "rated": rated_width, "forms": {}}
    res["max_abs_err"] = check_exact(device, n_users, n_items, d, dtypes)
    pairs = n_users * n_items
    flops = 2.0 * pairs * d
    out_bytes = n_users * k * (4 + 8)  # values and ids
    rated_bytes = rated.numel() * 8 + n_items

    def form(name, dtype, fn, bytes_moved):
        ms = time_ms(fn, iters, device)
        elem = 2 if dtype == "bf16" else 4
        bound, by = (bf16_bound if elem == 2 else sweep_bound)(
            flops, bytes_moved)
        res["forms"][f"{name}_{dtype}"] = {
            "ms": ms, "bound_ms": bound, "bound_by": by,
            "gpairs_s": pairs / ms / 1e6}
        print(f"  {name:<20s} {dtype} {ms:9.3f} ms  bound {bound:7.3f} ms "
              f"({by})  {pairs / ms / 1e6:8.1f} G pairs/s", flush=True)

    for name in dtypes:
        kind = DTYPES[name]
        elem = 2 if name == "bf16" else 4
        table_bytes = (n_users + n_items) * d * elem
        u, i = ue.to(kind), ie.to(kind)
        if name == "fp32":
            form("mm_rowmax", name, lambda: exact_scores(u, i).amax(1),
                 table_bytes + n_users * 4)

            def plane():
                s = exact_scores(u, i)
                return s.amax(1) + s.amin(1)

            form("mm_plane", name, plane, table_bytes + n_users * 4)
            form("plain_topk", name, lambda: masked_topk(
                exact_scores(u, i), rated, excl, k),
                table_bytes + rated_bytes + out_bytes)
        else:
            _, score = bf16_library(device)
            form("mm_rowmax", name, lambda: score(u, i).amax(1),
                 table_bytes + n_users * 4)
        items_t, excl_row = pad_items(i, excl)
        form("kernel_raw", name, lambda: fused_sweep(u, items_t, excl_row),
             sweep_bytes(n_users, d, items_t.shape[1], elem))
        form("kernel_padded", name, lambda: serve_device(
            ue, ie, rated, excl, k, name == "bf16"),
            (n_users + n_items) * d * 4 + rated_bytes + out_bytes)
        cv, ci, gh = fused_sweep(u, items_t, excl_row)
        flagged = int(_resolve(cv, ci, gh, rated, k)[2].sum())
        res[f"fallback_users_{name}"] = flagged
        print(f"  {name} ghost-flagged users: {flagged}/{n_users} (the "
              f"exact fallback's rows)", flush=True)
    f = res["forms"]
    if {"fp32", "bf16"} <= set(dtypes):
        for form_name in ("mm_rowmax", "kernel_raw", "kernel_padded"):
            res[f"bf16_speedup_{form_name}"] = (
                f[f"{form_name}_fp32"]["ms"] / f[f"{form_name}_bf16"]["ms"])
        print("  bf16 speed-up: " + ", ".join(
            f"{n} {res[f'bf16_speedup_{n}']:.3f}x" for n in (
                "mm_rowmax", "kernel_raw", "kernel_padded")), flush=True)
    return res


def run(device, users, items, dims, dtypes, k=20, rated_width=64,
        iters=10) -> list:
    device = resolve_device(device)
    name, clock = device_name(device), clock_name(device)
    out = []
    for n_users, d in itertools.product(users, dims):
        print(f"device={name} B={n_users} I={items} d={d} k={k} "
              f"R={rated_width} iters={iters} clock={clock}", flush=True)
        res = point(device, n_users, items, d, dtypes, k, rated_width,
                    iters)
        res.update(device=name, clock=clock)
        out.append(res)
    return out


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def main(argv: Optional[Sequence[str]] = None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--users", default="1024")
    p.add_argument("--items", type=int, default=270_336)
    p.add_argument("--d", default="64")
    p.add_argument("--dtype", default="fp32,bf16")
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--rated", type=int, default=64)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    dtypes = [t for t in a.dtype.split(",") if t]
    unknown = set(dtypes) - set(DTYPES)
    if unknown:
        raise ValueError(f"--dtype {sorted(unknown)}: not in {list(DTYPES)}")
    out = run(a.device, _ints(a.users), a.items, _ints(a.d), dtypes, a.k,
              a.rated, a.iters)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
