"""Where one MF training step's time goes, on the card.

    python -m coldrec_tpu_torch.tools.profile_train [--users 92107]
        [--items 270170] [--inter 1031175] [--d 64] [--bs 4096]
        [--steps 50] [--device cuda]
    python -m coldrec_tpu_torch.tools.profile_train --split [--chain]
        [--scatter] [--device cuda]

Without a mode it builds the synthetic dataset at the given shape
(book-crossing's by default) and an ``MFTrainer``, then reports, in
milliseconds per step: host batch building (``pairwise_batches``), the
upload, the step's host enqueue (and that of its loss, backward and Adam),
the step with the device drained after it, CUDA-event device time of steps
on batches already on the card, and the whole loop as the trainer runs it.
Then the operations that synchronise the host with the card during a step
(``torch.cuda.set_sync_debug_mode``) and the device time of a step by kernel
(``torch.profiler``). ``--device cpu`` runs the same on the CPU at a small
size (host clock only, no profile of device time).

The modes are the port's counterparts of the JAX package's MF step tools,
each at its problem (MF at 92,107 x 270,170, d=64, bs 4096, reg 1e-4, Adam
lr 1e-3; no dataset is built):

- ``--split`` (``tools/exp_mf_step_decomp.py``, ``tools/exp_grad_sorted.py``):
  the full step (``MF.loss``, which ``MFTrainer.loss`` is on one device, and
  ``torch.optim.Adam`` as the trainer makes it), the full step through the
  sorted lookup (:class:`SortedLookup`), grad only, Adam only on fixed dense
  gradients of 1e-3, and the forward only, each in ms per step, then the
  gradient A/B plain, sorted, plain, sorted;
- ``--chain`` (``tools/check_mfstep.py``): the stacked full step over 64,
  32, 64 and 32 batches, 5 reps each from the previous rep's weights, the
  reps sorted;
- ``--scatter`` (``tools/exp_scatter_variants.py``): the dense gradient of
  12,288 rows into 270,170 x 64 by ``index_add_`` (v0), by the backward of
  ``table[idx]`` that the port's gather runs (``index_put_`` with
  accumulate), sorted by id (v1) and with duplicates combined first (v2),
  each held to ``np.add.at`` (max error below 1e-3) before it is timed.

A per-step figure is the JAX tools' two-point difference (T(32) - T(16)) /
16 (``utils.timing.two_point_ms``), where T(n) is n steps enqueued back to
back with no host sync (CUDA events on the card, the host clock on the
CPU), best of 3 runs after a warm-up step. Eager PyTorch has no dead-code elimination and no deferred tracing,
so the JAX tools' ``1e-38`` perturbations, which keep XLA from dropping a
body's work, have no counterpart: each body is the real step or part of it.
Every mode prints the card's name on its first line; without ``--device``
it asks for the card and raises, before it builds anything, if there is
none.
"""
from __future__ import annotations

import argparse
import itertools
import time
import warnings

import numpy as np
import torch

from ..config import default_args
from ..data.synthetic import synthetic_dataset
from ..device import resolve_device
from ..models.mf import MF, MFTrainer
from ..ops.losses import bpr_l2_from_parts
from ..runtime.trainer import Config
from ..utils.timing import device_name, sync as _sync, two_point_ms

# The JAX tools' MF problem (tools/exp_mf_step_decomp.py:58-59) and their
# scatter problem (tools/exp_scatter_variants.py:29)
N_USERS, N_ITEMS, DIM, BS, REG, LR, N_ITER = (92_107, 270_170, 64, 4096,
                                              1e-4, 1e-3, 32)
SCATTER_B = 12_288
SCATTER_TOL = 1e-3  # each variant against np.add.at (exp_scatter_variants:103)
CHAIN_SIZES = (64, 32, 64, 32)  # tools/check_mfstep.py:36


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


# ---------------------------------------------------------------- --split
class SortedLookup(torch.autograd.Function):
    """``table[ids]`` whose backward sorts the ids first (``argsort``,
    stable) and adds the rows in that order by ``index_add_``: the
    counterpart of the JAX ``lookup`` (``tools/exp_mf_step_decomp.py:33-55``).
    Plain indexing's backward is ``index_put_`` with accumulate."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        return table[ids]

    @staticmethod
    def backward(ctx, ct):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1).long()
        rows = ct.reshape(flat.shape[0], -1)
        order = torch.argsort(flat, stable=True)
        grad = rows.new_zeros(ctx.table_shape).index_add_(
            0, flat[order], rows[order])
        return grad, None


def sorted_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return SortedLookup.apply(table, ids)


def mf_batches(n: int, device, n_users=N_USERS, n_items=N_ITEMS, bs=BS,
               seed=3) -> dict:
    """``n`` stacked batches drawn as the JAX tools draw them
    (``default_rng(seed)``: users, positives, negatives; weight 1), on
    ``device``."""
    rng = np.random.default_rng(seed)
    out = {key: rng.integers(0, hi, (n, bs), dtype=np.int32)
           for key, hi in (("user", n_users), ("pos_item", n_items),
                           ("neg_item", n_items))}
    out["weight"] = np.ones((n, bs), np.float32)
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


def batch_at(stacked: dict, i: int) -> dict:
    return {k: v[i] for k, v in stacked.items()}


class MFStep:
    """The decomposition's MF: the two tables (``MF``, xavier from ``seed``,
    or ``tables``, numpy arrays keyed ``user_emb`` / ``item_emb``) and
    ``torch.optim.Adam`` over them as ``MFTrainer`` makes it, with the
    bodies the tools time. Each body takes one device batch."""

    def __init__(self, device, n_users=N_USERS, n_items=N_ITEMS, d=DIM,
                 reg=REG, lr=LR, seed=0, tables=None):
        device = resolve_device(device)
        self.model = (MF(n_users, n_items, d, seed=seed, device=device)
                      if tables is None else
                      MF.from_jax_params(tables, device=device))
        self.reg = reg
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = torch.optim.Adam(self.params, lr=lr)
        self.fixed_grads = [torch.full_like(p, 1e-3) for p in self.params]

    def loss(self, batch, lookup=None):
        """``MF.loss`` (plain indexing), or the same loss through
        ``lookup(table, ids)``."""
        if lookup is None:
            return self.model.loss(batch, self.reg)
        parts = self.model.loss_parts(
            batch, lambda name, ids: lookup(getattr(self.model, name), ids))
        return bpr_l2_from_parts(parts, self.reg)

    def full(self, batch, lookup=None):
        """One training step: ``WarmBackboneTrainer.train_step``'s body."""
        loss = self.loss(batch, lookup)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def full_sorted(self, batch):
        return self.full(batch, sorted_lookup)

    def grad_only(self, batch, lookup=None):
        """Zero the gradients, the loss, its backward."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(batch, lookup)
        loss.backward()
        return loss.detach()

    def grad_sorted(self, batch):
        return self.grad_only(batch, sorted_lookup)

    def adam_only(self, batch=None):
        """One Adam step on the fixed dense gradients (1e-3 everywhere)."""
        for p, g in zip(self.params, self.fixed_grads):
            p.grad = g
        self.optimizer.step()

    @torch.no_grad()
    def forward_only(self, batch):
        return self.loss(batch)


def _cycling(body, xs):
    """A call of ``body`` on the next of the stacked batches ``xs``."""
    it = itertools.cycle(range(next(iter(xs.values())).shape[0]))
    return lambda: body(batch_at(xs, next(it)))


def split(device, n_users=N_USERS, n_items=N_ITEMS, d=DIM, bs=BS,
          iters=N_ITER, repeats=3) -> dict:
    """``--split``: ms per step of each body, then the gradient A/B."""
    device = resolve_device(device)
    xs = mf_batches(iters, device, n_users, n_items, bs)
    step = MFStep(device, n_users, n_items, d)
    out = {}
    for name, label, body in (
            ("full", "full step", step.full),
            ("full_sorted", "full step (sorted lookup)", step.full_sorted),
            ("grad_only", "grad only", step.grad_only),
            ("adam_only", "adam only", step.adam_only),
            ("forward_only", "fwd only", step.forward_only)):
        out[name] = two_point_ms(_cycling(body, xs), iters, device, repeats)
        print(f"{label:9s} : {out[name]:7.3f} ms", flush=True)
    for name, body in (("plain", step.grad_only), ("sorted", step.grad_sorted),
                       ("plain2", step.grad_only),
                       ("sorted2", step.grad_sorted)):
        out[f"grad_{name}"] = two_point_ms(_cycling(body, xs), iters,
                                           device, repeats)
        print(f"grad {name}: {out[f'grad_{name}']:7.3f} ms", flush=True)
    return out


def chain(device, n_users=N_USERS, n_items=N_ITEMS, d=DIM, bs=BS,
          sizes=CHAIN_SIZES, reps=5) -> dict:
    """``--chain``: the full step over the first n of ``max(sizes)``
    stacked batches, for each n of ``sizes`` one warm-up run, then ``reps``
    runs each from the previous run's weights, each timed by the host clock
    around work that ends in a sync. Returns {n: sorted ms} of the last run
    of each n."""
    device = resolve_device(device)
    xs = mf_batches(max(sizes), device, n_users, n_items, bs)
    step = MFStep(device, n_users, n_items, d)
    out = {}
    def run(n):
        _sync(device)
        t = time.perf_counter()
        for i in range(n):
            step.full(batch_at(xs, i))
        _sync(device)
        return (time.perf_counter() - t) * 1e3

    for n in sizes:
        run(n)
        ts = [run(n) for _ in range(reps)]
        out[n] = sorted(ts)
        print(f"chain {n}: reps = {[f'{t:.1f}' for t in out[n]]} ms",
              flush=True)
    return out


# -------------------------------------------------------------- --scatter
def scatter_v0(idx, g, n_items):
    """v0: ``zeros.index_add_(0, idx, g)``."""
    return g.new_zeros((n_items, g.shape[1])).index_add_(0, idx, g)


def scatter_gather_backward(idx, g, n_items):
    """The backward of ``table[idx]`` (autograd's ``index_put_`` with
    accumulate into zeros): what the port's plain gather runs."""
    return g.new_zeros((n_items, g.shape[1])).index_put_(
        (idx,), g, accumulate=True)


def scatter_v1(idx, g, n_items):
    """v1: rows sorted by id, then ``index_add_``."""
    order = torch.argsort(idx, stable=True)
    return g.new_zeros((n_items, g.shape[1])).index_add_(
        0, idx[order], g[order])


def scatter_v2(idx, g, n_items):
    """v2: the rows sorted by id, each run of one id summed onto its first
    row by a prefix-sum difference, each other row sent to a dump row of
    its own, so that the ids are unique and a scatter without accumulation
    writes the result (``tools/exp_scatter_variants.py:69-87``)."""
    b = idx.shape[0]
    order = torch.argsort(idx, stable=True)
    si, sg = idx[order], g[order]
    row = torch.arange(b, device=idx.device)
    change = si[1:] != si[:-1]
    one = torch.ones(1, dtype=torch.bool, device=idx.device)
    is_first = torch.cat([one, change])
    is_last = torch.cat([change, one])
    prefix = torch.cumsum(sg, dim=0)
    # the last row of each row's run: a reverse running minimum
    last_of_run = torch.where(is_last, row, b - 1).flip(0).cummin(
        0).values.flip(0)
    base = torch.where((row > 0)[:, None], prefix[(row - 1).clamp_min(0)],
                       0.0)
    run_sum = prefix[last_of_run] - base  # right at the first rows
    tgt = torch.where(is_first, si, n_items + row)
    out = g.new_zeros((n_items + b, g.shape[1])).index_put_(
        (tgt,), torch.where(is_first[:, None], run_sum, 0.0))
    return out[:n_items]


SCATTERS = (("v0 baseline", scatter_v0),
            ("v0 gather backward", scatter_gather_backward),
            ("v1 sorted", scatter_v1), ("v2 unique", scatter_v2))


def scatter(device, n_items=N_ITEMS, d=DIM, b=SCATTER_B, iters=N_ITER,
            repeats=3) -> dict:
    """``--scatter``: the variants on ``iters`` draws of ``default_rng(0)``
    (ids, N(0,1) rows), each held to ``np.add.at`` on the first draw (max
    error below ``SCATTER_TOL``, else ``AssertionError``), then timed."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, n_items, (iters, b), dtype=np.int32)
    g = rng.standard_normal((iters, b, d)).astype(np.float32)
    ref = np.zeros((n_items, d), np.float32)
    np.add.at(ref, idx[0], g[0])
    xs = {"idx": torch.as_tensor(idx, device=device).long(),
          "g": torch.as_tensor(g, device=device)}
    out = {}
    for name, fn in SCATTERS:
        got = fn(xs["idx"][0], xs["g"][0], n_items).cpu().numpy()
        err = float(np.abs(got - ref).max())
        print(f"{name} max|err| = {err:.2e}", flush=True)
        if not err < SCATTER_TOL:
            raise AssertionError(f"{name}: max|err| {err} against np.add.at")
        out[name] = {"max_abs_err": err}
    for name, fn in SCATTERS:
        ms = two_point_ms(_cycling(lambda x: fn(x["idx"], x["g"], n_items),
                                   xs), iters, device, repeats)
        out[name]["ms"] = ms
        print(f"{name}: {ms:7.3f} ms", flush=True)
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
    p.add_argument("--split", action="store_true",
                   help="the MF step decomposition and the gradient A/B")
    p.add_argument("--chain", action="store_true",
                   help="the stacked MF step over 64, 32, 64, 32 batches")
    p.add_argument("--scatter", action="store_true",
                   help="the scatter-add variants of the backward")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    print(f"device: {device_name(device)}", flush=True)
    if not (a.split or a.chain or a.scatter):
        return profile(device, a.users, a.items, a.inter, a.d, a.bs,
                       a.steps)
    out = {}
    if a.split:
        out["split"] = split(device)
    if a.chain:
        out["chain"] = chain(device)
    if a.scatter:
        out["scatter"] = scatter(device)
    return out


if __name__ == "__main__":
    main()
