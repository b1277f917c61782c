"""Where one MF training step's time goes, on the card.

    python -m coldrec_tpu_torch.tools.profile_train [--users 92107]
        [--items 270170] [--inter 1031175] [--d 64] [--bs 4096]
        [--steps 50] [--device cuda]

Builds the synthetic dataset at the given shape (book-crossing's by
default) and an ``MFTrainer``, then reports, in milliseconds per step:
host batch building (``pairwise_batches``), the upload, the step's host
enqueue (and that of its loss, backward and Adam), the step with the
device drained after it, CUDA-event device time
of steps on batches already on the card, and the whole loop as the trainer
runs it. Then the operations that synchronise the host with the card during
a step (``torch.cuda.set_sync_debug_mode``) and the device time of a step by
kernel (``torch.profiler``). ``--device cpu`` runs the same on the CPU at a
small size (host clock only, no profile of device time).
"""
from __future__ import annotations

import argparse
import time
import warnings

import torch

from ..config import default_args
from ..data.synthetic import synthetic_dataset
from ..device import resolve_device
from ..models.mf import MFTrainer
from ..runtime.trainer import Config


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _per_step_ms(fn, n, device):
    _sync(device)
    t = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(device)
    return (time.perf_counter() - t) * 1e3 / n


def profile(device, n_users, n_items, n_inter, d=64, bs=4096, steps=50,
            seed=0):
    """Print and return the per-step split (ms)."""
    device = resolve_device(device)
    data, _ = synthetic_dataset(n_users, n_items, n_inter, seed=seed)
    tm = MFTrainer(Config(default_args(
        model="MF", emb_size=d, bs=bs, seed=seed, save_emb=False,
        device=str(device)), data))
    batches = iter(tm.batches())
    host = [next(batches) for _ in range(steps)]
    out = {"host_batch_ms": _per_step_ms(lambda: next(batches), steps,
                                         device)}
    it = iter(host)
    out["upload_ms"] = _per_step_ms(lambda: tm.upload(next(it)), steps,
                                    device)
    dev = [tm.upload(b) for b in host]
    for b in dev[:5]:  # warm-up: allocations, Adam state
        tm.train_step(b)
    it = iter(dev)
    out["step_synced_ms"] = _per_step_ms(
        lambda: (tm.train_step(next(it)), _sync(device)), steps, device)
    it = iter(dev)
    _sync(device)
    t = time.perf_counter()
    for b in dev:
        tm.train_step(b)
    out["step_enqueue_ms"] = (time.perf_counter() - t) * 1e3 / steps
    _sync(device)
    # the enqueue by part: loss (gathers, BPR + L2), backward, Adam
    parts = dict.fromkeys(("loss", "backward", "adam"), 0.0)
    for b in dev:
        t0 = time.perf_counter()
        loss = tm.loss(b)
        t1 = time.perf_counter()
        tm.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        t2 = time.perf_counter()
        tm.optimizer.step()
        t3 = time.perf_counter()
        parts["loss"] += t1 - t0
        parts["backward"] += t2 - t1
        parts["adam"] += t3 - t2
    for k, v in parts.items():
        out[f"enqueue_{k}_ms"] = v * 1e3 / steps
    _sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for b in dev:
            tm.train_step(b)
        end.record()
        end.synchronize()
        out["step_device_ms"] = start.elapsed_time(end) / steps
    it = iter(host)
    out["loop_ms"] = _per_step_ms(
        lambda: tm.train_step(tm.upload(next(it))), steps, device)
    for k, v in out.items():
        print(f"{k}: {v:.4f}")

    if device.type == "cuda":
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for b in dev[:3]:
                    tm.train_step(b)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message).splitlines()[0] for w in caught
                 if "prototype feature" not in str(w.message)]
        print(f"synchronising operations in 3 steps: {len(syncs)}")
        for msg in sorted(set(syncs)):
            print(f"  {msg}")
        out["syncs_per_step"] = len(syncs) / 3
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        _sync(device)
        with torch.profiler.profile(activities=acts) as prof:
            for b in dev[:10]:
                tm.train_step(b)
            _sync(device)
        # the kernels, copies and fills themselves: not the host ops that
        # launched them, nor the device span of an annotated region (Adam's
        # step), which carry the same device time again
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation]
        busy = sum(e.self_device_time_total for e in rows) / 1e3 / 10
        out["device_busy_ms"] = busy
        print(f"device busy per step (profiler, sum of kernel times): "
              f"{busy:.4f} ms")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
            print(f"  {e.self_device_time_total / 1e3 / 10:9.4f} ms "
                  f"{e.count / 10:5.1f}x  {e.key[:90]}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--users", type=int, default=92_107)
    p.add_argument("--items", type=int, default=270_170)
    p.add_argument("--inter", type=int, default=1_031_175)
    p.add_argument("--d", type=int, default=64)
    p.add_argument("--bs", type=int, default=4096)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    return profile(a.device, a.users, a.items, a.inter, a.d, a.bs, a.steps)


if __name__ == "__main__":
    main()
