"""Headline benchmark of the port: scored user-item pairs a second of the
retrieval sweep on the card (the port's counterpart of the JAX package's
``bench.py``).

    python -m coldrec_tpu_torch.bench [--device cuda|cpu] [--users N --items N]

Prints ONE JSON line on stdout (stage messages go to stderr). The figures:

* the production path, ``retrieval_topk`` (``pad_items``, the hand-written
  ``fused_sweep`` kernel, ``_resolve``, the exact fallback), at
  book-crossing width (4096 users x 270,336 items, d=64, up to 64 rated
  items a user, 20% of the items excluded; ``_make_problem``, a copy of
  ``bench.py``'s, bit-identical arrays): the device figure is pairs/s of
  ``fused_sweep`` + ``_resolve`` on tensors already on the card, CUDA
  events around 20 sweeps after a warm-up, the median of 5 runs; the end-
  to-end figure a host clock around whole ``retrieval_topk`` calls from
  numpy to numpy (best of 5, fresh user rows each). JAX timed chains of 64
  and 32 sweeps and took the difference to cancel its remote dispatch's
  constant; CUDA events time the device alone, so no subtraction is
  needed;
* the same at MovieLens-1M shape (6,040 x 3,706), with the port's plain
  route beside it (exact fp32 scores + ``masked_topk`` in 1024-user
  chunks, ``bench_xla_sweep``'s counterpart: the field
  ``movielens_scale_xla_path_pairs_per_sec`` is
  ``movielens_scale_plain_path_pairs_per_sec`` here);
* the bf16 instance (``retrieval_topk(..., bf16=True)``) at book-crossing
  width;
* the MF training step at book-crossing table shapes (92,107 x 270,170,
  d=64, bs 4096, BPR + L2 at reg 1e-4, ``torch.optim.Adam(lr=1e-3)``):
  64 steps on one stacked upload, enqueued back to back with no host
  sync, as ``--fused_steps`` runs them, CUDA events around them after a
  warm-up pass; ms a step and trained pairs/s;
* one LightGCN-shaped ELL SpMM apply (346,112 rows, K=24, zipf degrees;
  ``ops/spmm.py::ell_apply``) beside two ceilings measured on the same
  card: streaming (``y = x + 1`` on 2^26 floats) and random row gathers
  (``x[idx]``, 256-byte rows, as many as the SpMM reads);
* the baselines, on the same card: the reference's eval path (matmul with
  TF32 off, the rated and excluded masks, ``topk(20)``, 512 users a chunk)
  gives ``vs_baseline``, and its dense MF step (``nn.Parameter`` tables,
  BPR + L2, Adam over both tables) gives ``train_vs_baseline``; each best
  of 3, with the spread. The JAX bench ran them on the host's CPU and
  paused background lanes around them (``_paused_parity_lanes``); on the
  card there is nothing to pause, so that guard is not carried over.

Shares of a peak are against the H100's published rates
(``utils/timing.py``): 67 TFLOP/s fp32 for the fp32 sweep (2*d FLOP a
pair), 989 TFLOP/s bf16 for the bf16 sweep, 3.35 TB/s of HBM. The line
names the card (``device_kind``, ``device_count``) and its ``nvidia-smi``
name and power limit.

``--device cpu`` runs the sweeps' plain versions at the given shape: every
figure that is a device time is ``null`` (not measured) and only the
host-clock figure (``e2e_pairs_per_sec``) is filled. Without a card the
default device raises; it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .device import resolve_device
from .models.mf import MF
from .ops.cuda.retrieval import (
    launch_counts, pad_items, resolved_chunks, retrieval_topk,
)
from .ops.spmm import EllGraph, ell_apply
from .runtime.eval import exact_scores, masked_topk
from .utils.timing import (
    BF16_PEAK_FLOPS, FP32_PEAK_FLOPS, HBM_BYTES_S, bf16_bound, run_ms,
    sweep_bound, sweep_bytes, time_ms,
)

DIM = 64
TOP_K = 20
MAX_RATED = 64
BC_ITEMS = 270336
BC_USERS = 4096
ML_USERS = 6040
ML_ITEMS = 3706
REPEATS = 5
SWEEP_ITERS = 20  # sweeps a timed run
MF_SHAPE = (92107, 270170)  # book-crossing's users and items
MF_REG = 1e-4


def _stage(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _make_problem(n_users, n_items, seed=0):
    """Users, items, padded rated ids (pad = n_items) and the excluded
    items: a copy of ``bench.py``'s, the same arrays bit for bit."""
    rng = np.random.default_rng(seed)
    user_emb = rng.standard_normal((n_users, DIM)).astype(np.float32)
    item_emb = rng.standard_normal((n_items, DIM)).astype(np.float32)
    rated = np.full((n_users, MAX_RATED), n_items, dtype=np.int32)
    n_rated = rng.integers(MAX_RATED // 4, MAX_RATED, size=n_users)
    for u in range(n_users):
        rated[u, : n_rated[u]] = rng.choice(n_items, n_rated[u], replace=False)
    excluded = np.zeros(n_items, dtype=bool)
    excluded[rng.choice(n_items, n_items // 5, replace=False)] = True
    return user_emb, item_emb, rated, excluded


def _events_ms(fn, device, iters, repeats, stat):
    """``stat`` of the per-run ms a call (CUDA events), None off the card:
    no host-clock number goes under a device figure's name."""
    if torch.device(device).type != "cuda":
        return None
    return stat(run_ms(fn, iters, device, repeats))


def bench_sweep(problem, device, bf16=False, iters=SWEEP_ITERS):
    """The production path at the problem's shape: {"device_pps" (None off
    the card), "e2e_pps", "ids" (the lists of the first, warm-up call),
    "bound_pps"}."""
    user_emb, item_emb, rated, excluded = problem
    dev = resolve_device(device)
    n_users, n_items = user_emb.shape[0], item_emb.shape[0]
    kind = torch.bfloat16 if bf16 else torch.float32
    ue = torch.as_tensor(user_emb, device=dev)
    ie = torch.as_tensor(item_emb, device=dev)
    rat = torch.as_tensor(rated, device=dev).long()
    exc = torch.as_tensor(excluded, device=dev)
    items_t, excl_row = pad_items(ie.to(kind), exc)
    uk = ue.to(kind)

    def sweep():
        for _ in resolved_chunks(uk, items_t, excl_row, rat, TOP_K):
            pass

    ms = _events_ms(sweep, dev, iters, REPEATS, statistics.median)
    flops = 2.0 * n_users * n_items * DIM
    moved = sweep_bytes(n_users, DIM, items_t.shape[1], 2 if bf16 else 4)
    bound_ms = (bf16_bound if bf16 else sweep_bound)(flops, moved)[0]
    _, ids = retrieval_topk(user_emb, item_emb, rated, excluded, TOP_K,
                            device=dev, bf16=bf16)  # warms the e2e path
    best = float("inf")
    for r in range(REPEATS):
        # fresh user rows a call, uploaded by the call as a client's are
        ue_r = np.roll(user_emb, r + 1, axis=0)
        t0 = time.perf_counter()
        retrieval_topk(ue_r, item_emb, rated, excluded, TOP_K, device=dev,
                       bf16=bf16)
        best = min(best, time.perf_counter() - t0)
    pairs = n_users * n_items
    return {"device_pps": None if ms is None else pairs / (ms / 1e3),
            "e2e_pps": pairs / best, "ids": ids,
            "bound_pps": pairs / (bound_ms / 1e3)}


def bench_plain_sweep(problem, device, batch=1024, iters=4):
    """The port's plain route (exact fp32 scores + ``masked_topk``) over
    every user in ``batch``-user chunks, as ``bench.py``'s
    ``bench_xla_sweep``: pairs/s on the card (median of 5 runs), None off
    it."""
    user_emb, item_emb, rated, excluded = problem
    dev = resolve_device(device)
    n_users, n_items = user_emb.shape[0], item_emb.shape[0]
    n_chunks = -(-n_users // batch)
    pad = n_chunks * batch
    uid = torch.as_tensor(np.arange(pad) % n_users, device=dev)
    ue = torch.as_tensor(user_emb, device=dev)
    ie = torch.as_tensor(item_emb, device=dev)
    rat = torch.as_tensor(rated, device=dev).long()[uid]
    exc = torch.as_tensor(excluded, device=dev)

    def sweep():
        for c in range(0, pad, batch):
            rows = uid[c:c + batch]
            masked_topk(exact_scores(ue[rows], ie), rat[c:c + batch], exc,
                        TOP_K)

    ms = _events_ms(sweep, dev, iters, REPEATS, statistics.median)
    return None if ms is None else pad * n_items / (ms / 1e3)


def bench_mf_train_step(device, n_iter=64, bs=4096, shape=MF_SHAPE):
    """(ms a step, trained pairs/s) of the MF step at ``shape`` tables:
    ``n_iter`` batches from ``np.random.default_rng(3)`` uploaded as one
    stack, their steps enqueued back to back with no host sync (as
    ``--fused_steps`` runs them), the best of 3 timed passes after a
    warm-up pass (CUDA events on the card, the host clock elsewhere)."""
    dev = resolve_device(device)
    n_users, n_items = shape
    model = MF(n_users, n_items, DIM, seed=0, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    rng = np.random.default_rng(3)
    batches = {
        key: torch.as_tensor(rng.integers(0, n, (n_iter, bs),
                                          dtype=np.int32), device=dev)
        for key, n in (("user", n_users), ("pos_item", n_items),
                       ("neg_item", n_items))}
    batches["weight"] = torch.ones((n_iter, bs), device=dev)

    def steps():
        for i in range(n_iter):
            loss = model.loss({k: v[i] for k, v in batches.items()}, MF_REG)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()

    t_step = time_ms(steps, 1, dev) / n_iter
    return t_step, bs / (t_step / 1e3)


def ell_problem(n=346112, k=24):
    """``bench.py``'s ELL arrays (zipf degrees, 1/degree weights, pad
    column 0 with weight 0) and the generator they were drawn from, which
    draws the SpMM's inputs next."""
    rng = np.random.default_rng(1)
    deg = np.minimum(rng.zipf(1.7, n) + 4, k).astype(np.int32)
    cols = np.zeros((n, k), np.int32)
    vals = np.zeros((n, k), np.float32)
    for s in range(0, n, 65536):
        e = min(s + 65536, n)
        c = rng.integers(0, n, (e - s, k), dtype=np.int32)
        m = np.arange(k)[None, :] < deg[s:e, None]
        cols[s:e] = np.where(m, c, 0)
        vals[s:e] = np.where(m, 1.0 / np.maximum(deg[s:e, None], 1), 0.0)
    return cols, vals, rng


def bench_spmm_roofline(device, n=346112, k=24, n_iter=20,
                        stream_floats=1 << 26):
    """One ELL SpMM apply at the book-crossing slab beside two ceilings
    measured on the same card: the stream ceiling (``y = x + 1`` on 2^26
    floats: read and write) and the random-gather ceiling (``x[idx]`` of
    n*k random 256-byte rows, the rows the SpMM reads). Best of 3 runs,
    CUDA events. The same byte counts and field names as ``bench.py``."""
    dev = resolve_device(device)
    cols, vals, rng = ell_problem(n, k)
    empty = torch.zeros(0, dtype=torch.long, device=dev)
    graph = EllGraph(
        ell_cols=torch.as_tensor(cols, device=dev).long(),
        ell_vals=torch.as_tensor(vals, device=dev),
        tail_rows=empty, tail_cols=empty,
        tail_vals=torch.zeros(0, device=dev), n_rows=n)
    x = torch.as_tensor(rng.standard_normal((n, DIM)).astype(np.float32),
                        device=dev)
    t_spmm = time_ms(lambda: ell_apply(graph, x), n_iter, dev) / 1e3
    # gather reads (n*k rows of d fp32) + cols + vals + out
    spmm_bytes = n * k * DIM * 4 + n * k * 8 + n * DIM * 4
    spmm_gbps = spmm_bytes / t_spmm / 1e9
    big = torch.as_tensor(
        rng.standard_normal(stream_floats).astype(np.float32), device=dev)
    t_stream = time_ms(lambda: big + 1.0, 50, dev) / 1e3
    stream_gbps = 2 * big.numel() * 4 / t_stream / 1e9
    idx = torch.as_tensor(rng.integers(0, n, n * k, dtype=np.int32),
                          device=dev).long()
    t_gather = time_ms(lambda: x[idx], 8, dev) / 1e3
    gather_gbps = idx.numel() * DIM * 4 / t_gather / 1e9
    return {
        "lightgcn_ell_spmm_ms_bc": t_spmm * 1e3,
        "spmm_achieved_gbps": spmm_gbps,
        "stream_gbps_measured": stream_gbps,
        "gather_random_read_gbps_measured": gather_gbps,
        "spmm_vs_stream_ceiling": spmm_gbps / stream_gbps,
        "spmm_vs_gather_ceiling": t_gather / t_spmm,
        "spmm_bound_ms": spmm_bytes / HBM_BYTES_S * 1e3,
        "hbm_peak_gbps": HBM_BYTES_S / 1e9,
    }


def bench_torch_baseline(problem, device, n_bench_users=2048, batch=512):
    """The reference's eval path on the card (fp32 matmul with TF32 off,
    the excluded items and each user's rated items masked to -10e8 through
    a widened plane, ``torch.topk``), ``batch`` users a chunk; the rated
    ids lie on the card beforehand. (best pairs/s, std) over 3 runs of
    ``n_bench_users`` users."""
    user_emb, item_emb, rated, excluded = problem
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    n_users, n_items = user_emb.shape[0], item_emb.shape[0]
    ue = torch.as_tensor(user_emb, device=dev)
    ie = torch.as_tensor(item_emb, device=dev)
    rat = torch.as_tensor(rated, device=dev).long()
    exc_idx = torch.as_tensor(np.where(excluded)[0], device=dev)
    rows = torch.arange(batch, device=dev)[:, None]
    offsets = torch.arange(batch, device=dev)

    def sweep():
        for start in range(0, n_bench_users, batch):
            users = (offsets + start) % n_users
            scores = ue[users] @ ie.T
            wide = torch.cat([scores, torch.zeros(batch, 1, device=dev)],
                             dim=1)
            wide[rows, rat[users]] = -10e8
            sc = wide[:, :n_items]
            sc[:, exc_idx] = -10e8
            torch.topk(sc, TOP_K, dim=1)

    pps = [n_bench_users * n_items / (ms / 1e3)
           for ms in run_ms(sweep, 1, dev, 3)]
    return max(pps), float(np.std(pps))


def bench_torch_train_baseline(device, n_steps=16, bs=4096, shape=MF_SHAPE):
    """The reference's MF training step on the card at ``shape`` tables:
    full ``nn.Parameter`` tables, row indexing, BPR + L2 (eps 1e-5), dense
    ``torch.optim.Adam`` over both tables (reference model/MF.py:12-28).
    (best trained pairs/s, std) over 3 runs of ``n_steps`` steps."""
    dev = resolve_device(device)
    n_users, n_items = shape
    g = torch.Generator().manual_seed(0)
    user_emb = torch.nn.Parameter(
        (torch.randn(n_users, DIM, generator=g) * 0.01).to(dev))
    item_emb = torch.nn.Parameter(
        (torch.randn(n_items, DIM, generator=g) * 0.01).to(dev))
    opt = torch.optim.Adam([user_emb, item_emb], lr=1e-3)
    rng = np.random.default_rng(3)
    users, pos, neg = (
        torch.as_tensor(rng.integers(0, n, (n_steps, bs)), device=dev)
        for n in (n_users, n_items, n_items))

    def steps():
        for i in range(n_steps):
            u, p, n = user_emb[users[i]], item_emb[pos[i]], item_emb[neg[i]]
            loss = -torch.log(
                1e-5 + torch.sigmoid((u * p).sum(1) - (u * n).sum(1))
            ).mean()
            loss = loss + MF_REG * (u.norm(2) + p.norm(2) + n.norm(2)) / bs
            opt.zero_grad()
            loss.backward()
            opt.step()

    pps = [n_steps * bs / (ms / 1e3) for ms in run_ms(steps, 1, dev, 3)]
    return max(pps), float(np.std(pps))


def power_limit() -> Optional[str]:
    """``nvidia-smi``'s name and power limit line, None without it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def _ratio(a, b):
    return None if a is None or b is None else a / b


def run(device="cuda", shape=None) -> dict:
    """Every figure of the line on ``device``; ``shape`` (users, items)
    replaces both sweep problems' shapes (default: book-crossing and
    MovieLens-1M)."""
    dev = resolve_device(device)
    card = dev.type == "cuda"
    bc = _make_problem(*(shape or (BC_USERS, BC_ITEMS)))
    ml = _make_problem(*(shape or (ML_USERS, ML_ITEMS)), seed=1)
    _stage(f"kernel sweep (book-crossing shape {bc[0].shape[0]} x "
           f"{bc[1].shape[0]})")
    bc_out = bench_sweep(bc, dev)
    _stage("kernel sweep (movielens shape)")
    ml_out = bench_sweep(ml, dev)
    _stage("plain sweep (movielens shape)")
    ml_plain = bench_plain_sweep(ml, dev)
    _stage("bf16 kernel sweep (book-crossing shape)")
    b16_out = bench_sweep(bc, dev, bf16=True)
    mf_step_ms = mf_pps = torch_pps = torch_train_pps = None
    base_std = train_std = None
    roofline = dict.fromkeys((
        "lightgcn_ell_spmm_ms_bc", "spmm_achieved_gbps",
        "stream_gbps_measured", "gather_random_read_gbps_measured",
        "spmm_vs_stream_ceiling", "spmm_vs_gather_ceiling",
        "spmm_bound_ms"))
    roofline["hbm_peak_gbps"] = HBM_BYTES_S / 1e9
    if card:
        _stage("mf train step (64 steps, one upload)")
        mf_step_ms, mf_pps = bench_mf_train_step(dev)
        _stage("spmm roofline")
        roofline = bench_spmm_roofline(dev)
        _stage("torch baseline (the reference's eval path on the card)")
        torch_pps, torch_std = bench_torch_baseline(bc, dev)
        base_std = torch_std / torch_pps
        _stage("torch train baseline (the reference's MF step on the card)")
        torch_train_pps, torch_train_std = bench_torch_train_baseline(dev)
        train_std = torch_train_std / torch_train_pps
    bc_pps, b16_pps = bc_out["device_pps"], b16_out["device_pps"]
    return {
        "metric": "scored_pairs_per_sec_bookcrossing",
        "value": bc_pps,
        "unit": "pairs/s",
        "device": dev.type,
        "vs_baseline": _ratio(bc_pps, torch_pps),
        "baseline_std_frac": base_std,
        "e2e_pairs_per_sec": bc_out["e2e_pps"],
        "sweep_bound_pairs_per_sec": bc_out["bound_pps"] if card else None,
        "movielens_scale_pairs_per_sec": ml_out["device_pps"],
        "movielens_scale_plain_path_pairs_per_sec": ml_plain,
        # pairs/s -> FLOP/s (2*d FLOP a scored pair)
        "sweep_flop_share_of_fp32_peak": _ratio(
            None if bc_pps is None else bc_pps * 2 * DIM, FP32_PEAK_FLOPS),
        "fp32_peak_tflops": FP32_PEAK_FLOPS / 1e12,
        "bf16_sweep_pairs_per_sec": b16_pps,
        "bf16_sweep_bound_pairs_per_sec": (b16_out["bound_pps"] if card
                                           else None),
        "bf16_sweep_flop_share_of_bf16_peak": _ratio(
            None if b16_pps is None else b16_pps * 2 * DIM, BF16_PEAK_FLOPS),
        "bf16_peak_tflops": BF16_PEAK_FLOPS / 1e12,
        "mf_fused_train_step_ms": mf_step_ms,
        "mf_train_pairs_per_sec": mf_pps,
        "train_vs_baseline": _ratio(mf_pps, torch_train_pps),
        "train_baseline_std_frac": train_std,
        **roofline,
        "device_kind": torch.cuda.get_device_name(dev) if card else "cpu",
        "device_count": torch.cuda.device_count() if card else 0,
        "power_limit": power_limit() if card else None,
        # this process's launches of each kernel (every figure above)
        "kernel_launches": launch_counts(),
        "baseline_caveat": (
            "baselines = the PyTorch reference's eval path (TF32-off matmul, "
            "masks, topk) and dense MF training step, run on the same card "
            "with CUDA events, best of 3 with std"),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--users", type=int, default=None)
    parser.add_argument("--items", type=int, default=None)
    args = parser.parse_args(argv)
    if (args.users is None) != (args.items is None):
        parser.error("--users and --items go together")
    shape = None if args.users is None else (args.users, args.items)
    print(json.dumps(run(args.device, shape)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
