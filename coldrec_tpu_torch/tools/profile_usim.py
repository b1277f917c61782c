"""USIM at book-crossing scale, phase by phase, each beside a ceiling.

    python -m coldrec_tpu_torch.tools.profile_usim [--workdir DIR]
        [--batches 3] [--bs 0] [--reps 3] [--out FILE] [--device cuda]

One tool for the JAX package's ``tools/profile_usim.py`` (the epoch),
``tools/profile_usim_bx.py`` (rollout against PPO) and
``tools/usim_roofline.py`` (each phase against an in-place ceiling). It
builds USIM (``--backbone MF``) on ``scale_run``'s book-crossing workdir,
which must hold MF's bus (``python -m coldrec_tpu_torch.tools.scale_run
--shape bx --model MF`` writes it), then reports:

- the epoch: the trainer's set-up, the first and the steady train batches,
  the batches per epoch (one per ``bs`` unique train items) and the train
  phase's seconds, ``_eval_tables`` twice, and the validation sweep
  (``valid("all")``, through ``fused_sweep``) with its launches;
- the step: one batch step split by CUDA events at ``USIM.marks``
  (:func:`usim_step_split`), each phase beside its bound
  (:func:`usim_bounds`), grouped into the JAX tool's phases (rollout and
  overhead = the hoisted top-ks + the rollouts; the PPO targets; the 5 PPO
  iterations; the termination step on its own); ``_rollouts`` alone; the
  ceilings measured in place, the chained (B, d+1) @ (d+1, users) product
  with a logsumexp and with a top-10 (:func:`ceilings`); each phase's
  fraction of its floor by the JAX formulas (:func:`floor_fraction`), and
  the sum of the phases against the step's own events.

The JSON of the JAX tool's keys, with the card's name and power limit, goes
to ``--out`` (default ``coldrec_tpu_torch/_scale/usim_roofline.json``,
which git ignores). At book-crossing scale the PPO runs in chunks, as the
trainer's does (T * users > ``USIM._DENSE_OPT_ELEMS``).

The JAX tools time copies of the step truncated at each stage, each kept
whole by a ``1e-38`` perturbation of its output, because XLA drops work no
output needs and ``jax.jit`` traces at the first call. Eager PyTorch does
neither, so one real step split by CUDA events gives the same phases; the
rollout-only figure runs ``_rollouts`` alone where the JAX tool replaced
the optimiser by an identity. On the CPU (``--device cpu``) every time is
the host clock. The first line printed is the card's name; without
``--device`` the tool asks for the card and raises, before it builds
anything, if there is none.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..bench import power_limit
from ..config import make_args
from ..device import resolve_device
from ..models import model_factory
from ..models import usim as usim_mod
from ..ops.cuda.retrieval import launch_counts, reset_launches
from ..runtime.trainer import Config
from ..utils.seeding import set_seed
from ..utils.timing import (
    device_name, peak_gib, peak_start, sweep_bound, sync, time_ms,
    two_point_ms,
)
from . import scale_run as sr

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(PACKAGE, "_scale", "usim_roofline.json")
CEILING_ITERS = 8  # tools/usim_roofline.py:292-293
CONSISTENCY_RTOL = 1e-3  # the phases' sum against the step's own span
CONSISTENCY_ATOL_MS = 0.01  # an event's resolution, ten intervals


def _seconds(fn, device):
    """(fn's result, its seconds by the host clock, the device drained)."""
    sync(device)
    t = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t


# ------------------------------------------------------------------ build
def build_trainer(workdir: str, device, bs: int = 0, dataset: str = "bx",
                  flags: Sequence[str] = ()):
    """USIM (``--backbone MF``) on ``dataset``'s split under ``workdir``,
    one epoch, with the CLI ``flags``; returns (trainer, set-up seconds).
    Raises
    ``FileNotFoundError`` naming the command that writes MF's bus where
    it is missing."""
    device = resolve_device(device)
    bus = os.path.join(workdir, "emb", f"{dataset}_cold_item_MF_emb.npz")
    if not os.path.exists(bus):
        raise FileNotFoundError(
            f"MF's bus {bus} is missing: run python -m "
            f"coldrec_tpu_torch.tools.scale_run --shape {dataset} --model MF"
            + (f" --workdir {workdir}"
               if workdir != sr.default_workdir(dataset) else "")
            + " first")
    argv = ["--dataset", dataset, "--model", "USIM", "--cold_object", "item",
            "--data_dir", os.path.join(workdir, "data"),
            "--emb_dir", os.path.join(workdir, "emb"),
            "--backbone", "MF", "--epochs", "1", "--save_emb", "false",
            "--device", str(device), *flags]
    if bs:
        argv += ["--bs", str(bs)]
    args = make_args(argv)
    set_seed(args.seed)
    tm, secs = _seconds(lambda: model_factory(Config(args)), device)
    return tm, secs


def batches_per_epoch(tm) -> int:
    """One batch per ``bs`` unique train items (USIM.py:791-818)."""
    n = np.unique(tm.data.train_pairs[:, 1]).shape[0]
    return int(math.ceil(n / tm.batch_size))


def config_block(tm) -> dict:
    """The JSON's ``config``: the step's shape and the epoch's counts."""
    m = tm.model
    return {"bs": tm.batch_size, "max_time": m.max_time, "n_user": m.n_user,
            "n_cold": int(tm.cold_idx.shape[0]), "n_ppo": m.n_ppo,
            "infer_blk": int(tm._infer_blk),
            "batches_per_epoch": batches_per_epoch(tm)}


# ------------------------------------------------------------------ epoch
def train_batches(tm, n: int = 3) -> list:
    """Seconds of the first ``n + 1`` train batches of an epoch (upload and
    step, the device drained after each): the first, then the steady."""
    it = iter(tm.batches())
    out = []
    for i in range(n + 1):
        batch = next(it)
        _, secs = _seconds(lambda: tm.train_step(tm.upload(batch)),
                           tm.device)
        out.append(secs)
        print(f"train batch {i}: {secs:.2f}s"
              + (" (first: allocations)" if i == 0 else ""), flush=True)
    return out


def eval_report(tm, reps: int = 2) -> dict:
    """``_eval_tables`` ``reps`` times (the greedy inference of the cold
    items, in chunks of ``_infer_blk``), then the validation sweep
    ``valid("all")`` on its tables with its kernel launches. Returns
    {"eval_tables_s": [...], "validation_s", "launches"}."""
    times = []
    for rep in range(reps):
        tables, secs = _seconds(tm._eval_tables, tm.device)
        times.append(secs)
        print(f"_eval_tables rep {rep}: {secs:.2f}s ({tm.cold_idx.shape[0]} "
              f"cold items, chunk {tm._infer_blk}, max_time "
              f"{tm.model.max_time})", flush=True)
    tm.user_emb, tm.item_emb = tables
    reset_launches()
    _, secs = _seconds(lambda: tm.valid("all"), tm.device)
    launches = launch_counts()
    print(f"validation sweep: {secs:.2f}s, kernel launches {launches}",
          flush=True)
    return {"eval_tables_s": times, "validation_s": secs,
            "launches": launches}


# ------------------------------------------------------------------- step
def usim_bounds(n_user, d, bs, max_time, n_ppo, blk):
    """{phase: (products, plane passes, rows)} of a USIM batch step as the
    code runs it, and the bound of each (``sweep_bound``): a product is
    2 * rows * n_user * d fp32 operations, a pass reads or writes one
    (rows, n_user) fp32 plane."""
    steps = usim_mod.ROLLOUTS * max_time
    t_rows = steps * bs
    phases = {
        # z and the target score of the batch's items, each with a top-k
        "hoisted top-ks": (2, 4, bs),
        # each step: sim (top-k) and z (logsumexp, max, argmax)
        "rollouts": (2 * steps, 4 * steps, bs),
        # the target actor's z over every transition, its logsumexp
        "ppo targets": (1, 2, t_rows),
        **{f"ppo {i + 1}": (2, 4, t_rows) for i in range(n_ppo)},
        "termination": (0, 0, bs),
        # each step: z, its logsumexp and max
        "inference chunk": (max_time, 2 * max_time, blk),
    }
    out = {}
    for name, (prods, passes, rows) in phases.items():
        flops = prods * 2.0 * rows * n_user * d
        bytes_moved = passes * 4.0 * rows * n_user
        ms, by = sweep_bound(flops, bytes_moved)
        out[name] = {"flops": flops, "bytes": bytes_moved, "bound_ms": ms,
                     "bound_by": by}
    return out


def usim_step_split(tm, seed=0, blk=4096):
    """One batch step of USIM trainer ``tm`` (after one warm-up step)
    split into its phases by CUDA events at the model's marks (the host
    clock on the CPU): the hoisted top-ks, the rollouts, the PPO targets,
    each PPO iteration and the termination step, each phase's host enqueue
    beside its device time and its bound; then the greedy inference of one
    ``blk``-item chunk of cold items; the card's peak memory over the
    step. Returns {phase: numbers}; ``"step"`` also holds the step's own
    span from its first mark to its last (``events_ms``)."""
    device, bs, d = tm.device, tm.batch_size, tm.emb_size
    cuda = device.type == "cuda"
    m = tm.model
    tm.host_rng = np.random.default_rng(seed)
    batches = [tm.upload(b) for _, b in zip(range(2), tm.batches())]
    tm.train_step(batches[0])
    sync(device)
    base = peak_start(device)
    m.marks = []
    t0 = time.perf_counter()
    tm.train_step(batches[-1])
    enqueue_s = time.perf_counter() - t0
    sync(device)
    marks, m.marks = m.marks, None
    peak = peak_gib(device, 0)  # the trainer's tables and content with it
    step_peak = peak_gib(device, base)
    content = m.content[tm.cold_idx[:blk]]
    bounds = usim_bounds(m.n_user, d, bs, m.max_time, m.n_ppo,
                         content.shape[0])
    out = {}
    for (_, h0, e0), (name, h1, e1) in zip(marks[:-1], marks[1:]):
        dev_ms = e0.elapsed_time(e1) if cuda else (h1 - h0) * 1e3
        out[name] = {"ms": dev_ms, "host_ms": (h1 - h0) * 1e3,
                     **bounds[name]}
    events_ms = (marks[0][2].elapsed_time(marks[-1][2]) if cuda
                 else (marks[-1][1] - marks[0][1]) * 1e3)
    out["inference chunk"] = {
        "ms": time_ms(lambda: m._infer(m.actor, content), 3, device,
                      repeats=1), **bounds["inference chunk"]}
    t_rows = usim_mod.ROLLOUTS * m.max_time * bs
    step_ms = sum(v["ms"] for k, v in out.items() if k != "inference chunk")
    bound_ms = sum(v["bound_ms"] for k, v in out.items()
                   if k != "inference chunk")
    print(f"  USIM step split at bs {bs} x {m.n_user} actions, d={d} "
          f"(max_time {m.max_time}, k {m.k}, {m.n_ppo} PPO iterations over "
          f"{t_rows} transitions, chunked: "
          f"{t_rows * m.n_user > m._DENSE_OPT_ELEMS}"
          f"): step {step_ms:.3f} ms on the device, {enqueue_s * 1e3:.3f} ms "
          f"of host enqueue (to its return), bound {bound_ms:.3f} ms; peak "
          f"card memory {peak:.2f} GiB, {step_peak:.2f} GiB of it the step's",
          flush=True)
    for name, v in out.items():
        print(f"    {name}: {v['ms']:.3f} ms"
              + (f" (host {v['host_ms']:.3f} ms)" if "host_ms" in v else "")
              + f", {100 * v['ms'] / step_ms:.1f}% of the step; bound "
              f"{v['bound_ms']:.3f} ms ({v['bound_by']}: {v['flops']:.3e} "
              f"FLOP, {v['bytes']:.3e} B)", flush=True)
    out["step"] = {"ms": step_ms, "enqueue_ms": enqueue_s * 1e3,
                   "bound_ms": bound_ms, "peak_gib": peak,
                   "step_peak_gib": step_peak, "events_ms": events_ms}
    return out


def rollout_only_ms(tm, reps: int = 1) -> float:
    """``_rollouts`` alone on the first batch of an epoch and one batch of
    draws: ms, best of ``reps`` after one warm-up (CUDA events on the
    card, the host clock on the CPU). The weights do not change."""
    m = tm.model
    batch = tm.upload(next(iter(tm.batches())))
    draws = tm.draw(tm.batch_size)
    items = batch["items"].long()
    return time_ms(lambda: m._rollouts(items, batch["weight"], draws), 1,
                   tm.device, repeats=reps)


def ceilings(tm, iters: int = CEILING_ITERS, repeats: int = 3) -> dict:
    """The in-place ceilings (``tools/usim_roofline.py:252-293``): the
    chained (B, d+1) @ (d+1, users) product followed by a logsumexp over
    each row, and by a top-10, N(0,1) operands from seeds 0 and 1, ms a
    call by the two-point difference (T(2 iters) - T(iters)) / iters, each
    T the best of ``repeats`` runs after a warm-up call."""
    m, device = tm.model, tm.device
    d, n_user, b = tm.emb_size, m.n_user - 1, tm.batch_size
    emb0 = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (b, d + 1)).astype(np.float32), device=device)
    wmat = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (n_user, d + 1)).astype(np.float32), device=device)

    def mm_lse(x):
        z = x[:, : d + 1] @ wmat.T
        return x + 1e-38 * torch.logsumexp(z, dim=1)[:, None]

    def mm_topk(x):
        z = x[:, : d + 1] @ wmat.T
        v, _ = usim_mod._stream_topk(z, 10)
        return x + 1e-38 * v[:, :1]

    def chained(body):
        x = [emb0]

        def call():
            x[0] = body(x[0])
        return call

    return {name: two_point_ms(chained(body), 2 * iters, device, repeats)
            for name, body in (("matmul_lse_rowreduce", mm_lse),
                               ("matmul_stream_topk", mm_topk))}


def floor_fraction(config: dict, phases_ms: dict, ceilings_ms: dict,
                   inference_ms: float) -> dict:
    """Each phase's floor over its time, by ``tools/usim_roofline.py``'s
    formulas (:296-305): a rollout step is two products with a row reduce
    and one with a top-k, plus the two hoisted top-ks; the targets one
    product with a logsumexp a chunk; a PPO iteration three a chunk; the
    inference one a step of each chunk, scaled to its width."""
    lse = ceilings_ms["matmul_lse_rowreduce"]
    topk = ceilings_ms["matmul_stream_topk"]
    mt, blk, b = config["max_time"], config["infer_blk"], config["bs"]
    n_chunks = 3 * mt
    floors = {
        "rollout_and_overhead": 3 * mt * (2 * lse + topk) + 2 * topk,
        "ppo_target_prep": n_chunks * lse,
        "ppo_5_iterations": config["n_ppo"] * n_chunks * 3 * lse,
        "inference": (int(np.ceil(config["n_cold"] / blk)) * mt * lse
                      * (blk / b)),
    }
    got = {**{k: phases_ms[k] for k in floors if k != "inference"},
           "inference": inference_ms}
    return {k: round(v / got[k], 3) if got[k] > 0 else None
            for k, v in floors.items()}


def roofline(tm, split: dict, ceilings_ms: dict, inference_ms: float,
             rollout_ms: float) -> dict:
    """The JAX tool's JSON (``tools/usim_roofline.py:312-358``) from one
    split step, the ceilings, the inference's ms an epoch and the
    rollout-only ms, with the card's name and power limit."""
    config = config_block(tm)
    n_ppo = config["n_ppo"]
    t_roll = split["hoisted top-ks"]["ms"] + split["rollouts"]["ms"]
    t_target = split["ppo targets"]["ms"]
    t_ppo5 = sum(split[f"ppo {i + 1}"]["ms"] for i in range(n_ppo))
    t_term = split["termination"]["ms"]
    t_real = split["step"]["events_ms"]
    phases = {"rollout_and_overhead": t_roll, "ppo_target_prep": t_target,
              "ppo_5_iterations": t_ppo5,
              "ppo_per_iteration": t_ppo5 / n_ppo, "termination": t_term}
    n_batches = config["batches_per_epoch"]
    train_s = t_real * n_batches / 1e3
    return {
        "config": config,
        "device": {"name": device_name(tm.device),
                   "power_limit": (power_limit() if tm.device.type == "cuda"
                                   else None)},
        # the phases each JAX stage copy kept, summed from the one step
        "stage_walls_ms": {"rollout": t_roll, "target": t_roll + t_target,
                           "iters": t_roll + t_ppo5, "full": t_real},
        "real_step_ms": t_real,
        "rollout_only_ms": rollout_ms,
        "phases_ms_per_batch": phases,
        "phase_share_of_step": {
            k: phases[k] / t_real for k in ("rollout_and_overhead",
                                            "ppo_target_prep",
                                            "ppo_5_iterations",
                                            "termination")},
        "bounds_ms": {k: v["bound_ms"] for k, v in split.items()
                      if k != "step"},
        "inference_ms_per_epoch": inference_ms,
        "ceilings_ms": dict(ceilings_ms),
        "floor_fraction": floor_fraction(config, phases, ceilings_ms,
                                         inference_ms),
        "epoch_accounting_s": {
            "train_phase": train_s, "inference": inference_ms / 1e3,
            "total_excl_eval": train_s + inference_ms / 1e3},
        "consistency_check": {
            "sum_of_phases_ms": t_roll + t_target + t_ppo5 + t_term,
            "full_stage_ms": t_real},
        "peak_gib": split["step"]["peak_gib"],
        "methodology": (
            "one real batch step split by CUDA events at USIM.marks (the "
            "host clock on the CPU); rollout-only is _rollouts alone; "
            "ceilings are the chained (N,d+1)@(d+1,n_user) product + full-row "
            "logsumexp or top-10 at the same shapes on the same card, by "
            "the two-point difference; the inference is _eval_tables, best "
            "of its timed reps"),
    }


def hold_consistency(report: dict) -> None:
    """The phases' sum against the step's own span (``AssertionError``
    beyond ``CONSISTENCY_RTOL`` of it and ``CONSISTENCY_ATOL_MS``)."""
    c = report["consistency_check"]
    gap = abs(c["sum_of_phases_ms"] - c["full_stage_ms"])
    if not gap <= CONSISTENCY_RTOL * c["full_stage_ms"] + CONSISTENCY_ATOL_MS:
        raise AssertionError(f"USIM phases sum to {c['sum_of_phases_ms']} "
                             f"ms, the step spans {c['full_stage_ms']} ms")


def print_report(report: dict) -> None:
    ph, ff = report["phases_ms_per_batch"], report["floor_fraction"]
    ce = report["ceilings_ms"]
    print(f"ceilings: matmul + logsumexp {ce['matmul_lse_rowreduce']:.3f} ms, "
          f"matmul + top-10 {ce['matmul_stream_topk']:.3f} ms", flush=True)
    for k in ("rollout_and_overhead", "ppo_target_prep", "ppo_5_iterations"):
        print(f"{k}: {ph[k]:.3f} ms, floor fraction {ff[k]}", flush=True)
    print(f"ppo_per_iteration: {ph['ppo_per_iteration']:.3f} ms; "
          f"termination: {ph['termination']:.3f} ms; rollout only "
          f"{report['rollout_only_ms']:.3f} ms", flush=True)
    print(f"inference: {report['inference_ms_per_epoch']:.3f} ms/epoch, "
          f"floor fraction {ff['inference']}", flush=True)
    c = report["consistency_check"]
    print(f"consistency: phases sum {c['sum_of_phases_ms']:.3f} ms, the "
          f"step's events {c['full_stage_ms']:.3f} ms", flush=True)


def step_report(tm, inference_ms: float, reps: int = 1,
                iters: int = CEILING_ITERS, seed: int = 0) -> dict:
    """The split step, ``_rollouts`` alone, the ceilings and the JSON;
    the consistency held."""
    split = usim_step_split(tm, seed=seed, blk=tm._infer_blk)
    rollout_ms = rollout_only_ms(tm, reps)
    ceil = ceilings(tm, iters)
    report = roofline(tm, split, ceil, inference_ms, rollout_ms)
    print_report(report)
    hold_consistency(report)
    return report


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", default="")
    p.add_argument("--batches", type=int, default=3)
    p.add_argument("--bs", type=int, default=0, help="override batch size")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    print(f"device: {device_name(device)}", flush=True)
    workdir = os.path.abspath(a.workdir or sr.default_workdir("bx"))
    tm, init_s = build_trainer(workdir, device, a.bs)
    config = config_block(tm)
    print(f"init (incl first _eval_tables): {init_s:.1f}s bs={tm.batch_size}"
          f" max_time={config['max_time']} n_user={config['n_user']} "
          f"cold={config['n_cold']}", flush=True)
    times = train_batches(tm, a.batches)
    steady = float(np.median(times[1:])) if len(times) > 1 else times[0]
    n_batches = config["batches_per_epoch"]
    print(f"steady train batch: {steady:.2f}s x {n_batches} batches "
          f"= {steady * n_batches:.0f}s/epoch train phase", flush=True)
    ev = eval_report(tm, max(2, a.reps))
    inference_ms = min(ev["eval_tables_s"][1:]) * 1e3
    report = step_report(tm, inference_ms, a.reps)
    report["epoch"] = {"init_s": init_s, "train_batches_s": times,
                       "steady_batch_s": steady, **ev}
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    print(f"-> {a.out}", flush=True)
    return report


if __name__ == "__main__":
    main()
