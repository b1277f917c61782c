"""K training steps one batch at a time against the ``--fused_steps K``
path, at a published dataset shape.

    python -m coldrec_tpu_torch.tools.exp_fused_steps [--model LightGCN]
        [--shape xing] [--k 32] [--iters 3] [--workdir DIR] [--device cuda]

The port's counterpart of the JAX package's ``tools/exp_fused_steps.py``.
The dataset is ``scale_run``'s at ``--shape`` (built by its
``build_dataset`` under ``--workdir``, by default ``scale_run``'s own
workdir of the shape, unless built there already). The trainer is the CLI's
(``model_factory`` from ``make_args``, seed 2024), and the K batches are
the first K of its own sampler. Like the JAX tool's assertion, the tool
refuses a model whose step is not the plain warm-backbone step: one whose
trainer keeps the per-batch loop (``_fused_ok`` False: BatchNorm state, or
an optimizer of its own; the JAX package's ``stateful``), or one whose loss
draws noise from the trainer's generator (JAX's ``uses_rng_in_loss``).

From copies of one initial state (the module's and the optimizer's), the
K steps run as ``train_step(upload(batch))`` one by one and as the
``--fused_steps K`` path runs them (``upload_group``: each key's K batches
stacked and uploaded at once, then the K steps on its slices with no host
sync in between). Their losses must agree within rtol 2e-4 and their final
parameters within rtol 3e-4, atol 3e-6 (the JAX tool's limits: the SpMM
tail's ``index_add_`` sums by atomics on the card, so the two are not
bitwise equal there); then each path is timed from the same initial state,
by the host clock around work that ends in a sync, best of ``--iters``
after one warm-up, the fused path with its upload. JAX's fused path is one
``lax.scan``, compiled once; eager PyTorch enqueues the same K steps in
both paths, so what the timing parts is the per-batch upload and the
losses read back (none inside either timed loop). The first line printed
is the card's name; without ``--device`` the tool asks for the card and
raises, before it builds anything, if there is none.
"""
from __future__ import annotations

import argparse
import copy
import itertools
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import make_args
from ..data.builder import ColdStartDataset
from ..device import resolve_device
from ..models import model_factory
from ..runtime.trainer import Config
from ..utils.seeding import set_seed
from ..utils.timing import device_name, sync
from . import scale_run as sr

LOSS_RTOL = 2e-4  # tools/exp_fused_steps.py:106-114
PARAM_RTOL, PARAM_ATOL = 3e-4, 3e-6
SEED = 2024  # the JAX tool's set_seed


def build_trainer(model: str, shape: str, workdir: str, device,
                  data: Optional[ColdStartDataset] = None,
                  flags: Sequence[str] = ()):
    """The CLI's trainer of ``model`` on ``scale_run``'s dataset at
    ``shape`` under ``workdir`` (built there first unless it is), one
    epoch, seed 2024, and the CLI ``flags``. ``data``: the split, already
    read."""
    device = resolve_device(device)
    sr.build_dataset(workdir, shape)
    set_seed(SEED)
    args = make_args([
        "--model", model, "--dataset", shape,
        "--data_dir", os.path.join(workdir, "data"),
        "--emb_dir", os.path.join(workdir, "emb"),
        "--epochs", "1", "--device", str(device), *flags,
    ])
    if data is None:
        data = ColdStartDataset.from_split_dir(args.data_dir, args.dataset,
                                               args.cold_object)
    return model_factory(Config(args, data))


def draws_in_loss(tm, batch) -> bool:
    """Whether the trainer's loss of ``batch`` draws from its generator
    (the generator's state is put back)."""
    state = tm.generator.get_state()
    with torch.no_grad():
        tm.loss(tm.upload(batch))
    drew = not torch.equal(state, tm.generator.get_state())
    tm.generator.set_state(state)
    return drew


def refusal(tm, batch) -> Optional[str]:
    """Why the experiment refuses trainer ``tm`` (None: it takes it)."""
    if not getattr(tm, "_fused_ok", False):
        return ("its trainer keeps the per-batch loop (fused_ok False: "
                "state such as BatchNorm's, or an optimizer of its own)")
    if draws_in_loss(tm, batch):
        return "its loss draws noise from the trainer's generator"
    return None


def snapshot(tm) -> tuple:
    return (copy.deepcopy(tm.model.state_dict()),
            copy.deepcopy(tm.optimizer.state_dict()))


def restore(tm, state) -> None:
    tm.model.load_state_dict(state[0])
    tm.optimizer.load_state_dict(state[1])


def _params(tm) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in tm.model.named_parameters()}


def sequential(tm, batches) -> list:
    """K ``train_step(upload(batch))``; returns the losses (no sync)."""
    return [tm.train_step(tm.upload(b)) for b in batches]


def fused(tm, batches) -> list:
    """The ``--fused_steps K`` path: one stacked upload, then K steps."""
    return [tm.train_step(b) for b in tm.upload_group(batches)]


def hold_equivalence(seq_losses, fused_losses, seq_params, fused_params):
    """The JAX tool's limits (``AssertionError`` beyond them)."""
    np.testing.assert_allclose(np.asarray(fused_losses),
                               np.asarray(seq_losses), rtol=LOSS_RTOL)
    assert seq_params.keys() == fused_params.keys()
    for k, v in seq_params.items():
        np.testing.assert_allclose(fused_params[k], v, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


def run(tm, k: int = 32, iters: int = 3) -> dict:
    """The equivalence, then the timing, on trainer ``tm``; prints the JAX
    tool's lines and returns {"k", "bs", "loss_max_rel", "param_max_abs",
    "sequential_ms", "fused_ms", "speedup"}."""
    device = tm.device
    batches = list(itertools.islice(tm.batches(), k))
    why = refusal(tm, batches[0])
    if why is not None:
        raise ValueError(f"{tm.model_name}: {why}; the experiment targets "
                         "the plain warm-backbone step")
    k = len(batches)
    init = snapshot(tm)
    seq_losses = torch.stack(sequential(tm, batches)).tolist()
    seq_params = _params(tm)
    restore(tm, init)
    fused_losses = torch.stack(fused(tm, batches)).tolist()
    fused_params = _params(tm)
    hold_equivalence(seq_losses, fused_losses, seq_params, fused_params)
    loss_rel = float(np.max(np.abs(np.subtract(fused_losses, seq_losses))
                            / np.abs(seq_losses)))
    param_abs = max(float(np.abs(fused_params[n] - v).max())
                    for n, v in seq_params.items())
    print(f"equivalence OK over {k} steps (losses + final params)",
          flush=True)

    def timed(path):
        restore(tm, init)
        sync(device)
        t = time.perf_counter()
        path(tm, batches)
        sync(device)
        return time.perf_counter() - t

    timed(sequential)
    timed(fused)
    seq = min(timed(sequential) for _ in range(iters))
    fus = min(timed(fused) for _ in range(iters))
    print(
        f"model={tm.model_name} shape={tm.dataset_name} "
        f"K={k} B={tm.batch_size}\n"
        f"sequential: {seq*1e3:9.1f} ms  ({seq/k*1e3:7.2f} ms/step)\n"
        f"fused scan: {fus*1e3:9.1f} ms  ({fus/k*1e3:7.2f} ms/step)\n"
        f"speedup: {seq/fus:.2f}x", flush=True)
    return {"k": k, "bs": tm.batch_size, "loss_max_rel": loss_rel,
            "param_max_abs": param_abs, "sequential_ms": seq * 1e3,
            "fused_ms": fus * 1e3, "speedup": seq / fus}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="LightGCN")
    p.add_argument("--shape", default="xing", choices=list(sr.SHAPES))
    p.add_argument("--k", type=int, default=32)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--workdir", default="")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    print(f"device: {device_name(device)}", flush=True)
    workdir = os.path.abspath(a.workdir or sr.default_workdir(a.shape))
    tm = build_trainer(a.model, a.shape, workdir, device)
    return run(tm, a.k, a.iters)


if __name__ == "__main__":
    main()
