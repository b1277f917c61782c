"""A rank of ``tests/test_torch_mesh_train.py`` and
``tests/test_torch_mesh_dropoutnet.py``: runs each job of a JSON spec (a
model and its flags) on the process group the ``COLDREC_*`` variables
configure, on the CPU, and writes what each run leaves (:func:`summary`) to
``<out>/<job>_rank<r>.npz``. A job named ``syncbn...`` runs
:func:`syncbn` instead. Imports no JAX.

    python tests/torch_mesh_child.py SPEC.json
"""
import json
import pickle
import sys

import numpy as np
import torch

from coldrec_tpu_torch.config import default_args
from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from coldrec_tpu_torch.models import TRAINERS, model_factory
from coldrec_tpu_torch.models.common import MaskedBatchNorm1d
from coldrec_tpu_torch.models.mf import MFTrainer
from coldrec_tpu_torch.parallel.distributed import (
    host_block, init_distributed, process_count, process_index,
    shutdown_distributed,
)
from coldrec_tpu_torch.parallel.mesh import make_mesh
from coldrec_tpu_torch.runtime.trainer import Config

# the sync-BN case: a global batch of SYNCBN_ROWS rows, SYNCBN_DIM features
SYNCBN_ROWS, SYNCBN_DIM = 16, 6


def summary(m) -> dict:
    """A finished run's eval tables, per-batch losses, test metrics, overall
    test lists and the shapes of its (local) parameters; for DropoutNet
    also its bus tables gathered whole, its tower weights, its BatchNorm
    running statistics and the global masks it drew."""
    out = {}
    if hasattr(m, "drawn"):
        bns = [b for b in m.model.modules() if isinstance(b, MaskedBatchNorm1d)]
        with torch.no_grad():
            out = {
                "tables": torch.cat([m.full_table(n).reshape(-1) for n in
                                     ("user_emb", "item_emb")]).numpy(),
                "towers": torch.cat([p.detach().reshape(-1) for n, p in
                                     m.model.named_parameters()
                                     if "tower" in n]).numpy(),
                # without the Linear biases ahead of a BatchNorm (exact
                # gradient 0: Adam walks them on rounding noise)
                "towers_core": torch.cat([
                    p.detach().reshape(-1) for n, p in
                    m.model.named_parameters() if "tower" in n
                    and not (".lins." in n and n.endswith(".bias"))]).numpy(),
                "table_shapes": np.asarray([tuple(m.model.user_emb.shape),
                                            tuple(m.model.item_emb.shape)]),
                "bn": torch.cat([t for b in bns for t in
                                 (b.running_mean, b.running_var)]).numpy(),
                "masks": torch.stack(m.drawn).numpy(),
            }
    return {**out,
        "user_emb": m.user_emb.numpy(), "item_emb": m.item_emb.numpy(),
        "losses": np.asarray([x for s in m.epoch_stats for x in s["losses"]]),
        "overall": np.asarray(m.overall_test_results),
        "cold": np.asarray(m.cold_test_results),
        "warm": np.asarray(m.warm_test_results),
        "lists": m.test("all"),
        "shapes": np.asarray([tuple(p.shape) for p in m.model.parameters()
                              if p.dim() == 2]),
    }


def run(data, common: dict, kw: dict, init=None):
    """One run of ``kw["model"]`` on ``data`` (MF from ``init``). DropoutNet
    records the global masks it draws (``drawn``); ``kw["jax_init"]``, a
    pickle of the JAX trainer's (params, net_state), carries its weights
    and ``kw["masks"]``, an npz of the JAX run's (steps, 2, n) masks,
    replaces its draws."""
    kw = dict(kw)
    jax_init, masks = kw.pop("jax_init", None), kw.pop("masks", None)
    args = default_args(**{**common, "device": "cpu", **kw})
    if kw["model"] == "MF":
        m = MFTrainer(Config(args, data), init_params=init)
    elif jax_init:
        with open(jax_init, "rb") as f:
            params, state = pickle.load(f)
        m = TRAINERS[kw["model"]](Config(args, data), init_params=params,
                                  init_state=state)
    else:
        m = model_factory(Config(args, data))
    if kw["model"] == "DropoutNet":
        draw, m.drawn = m.draw_masks, []
        queue = list(np.load(masks)["masks"]) if masks else None

        def recorded(n):
            out = (tuple(torch.from_numpy(x) for x in queue.pop(0))
                   if queue is not None else draw(n))
            m.drawn.append(torch.stack(out))
            return out

        m.draw_masks = recorded
    m.run()
    return m


def syncbn_case(seed: int = 0):
    """The sync-BN case's global batch: x, real / pad weights and the
    upstream gradient of the output."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(SYNCBN_ROWS, SYNCBN_DIM, generator=g) * 2 + 0.5
    w = (torch.rand(SYNCBN_ROWS, generator=g) > 0.25).float()
    up = torch.randn(SYNCBN_ROWS, SYNCBN_DIM, generator=g)
    return x, w, up


def syncbn(block=None, group=None) -> dict:
    """Two training passes of a ``MaskedBatchNorm1d`` over a block of the
    case's global batch (all of it with ``block`` None), the loss the sum
    of output times the upstream gradient: the block's input gradient, the
    scale and bias gradients and the running statistics."""
    x, w, up = syncbn_case()
    bn = MaskedBatchNorm1d(SYNCBN_DIM, momentum=0.1, eps=1e-3)
    bn.group = group
    if block is not None:
        x, w, up = (host_block(t, *block) for t in (x, w, up))
    x = x.clone().requires_grad_()
    for _ in range(2):
        (bn(x, w) * up).sum().backward()
    return {"x_grad": x.grad.numpy(), "scale_grad": bn.scale.grad.numpy(),
            "bias_grad": bn.bias.grad.numpy(),
            "running": torch.cat([bn.running_mean,
                                  bn.running_var]).numpy()}


def main(spec_path: str) -> None:
    torch.set_num_threads(1)
    init_distributed(device="cpu")
    with open(spec_path) as f:
        spec = json.load(f)
    init = dict(np.load(spec["init"])) if spec.get("init") else None
    data, _ = synthetic_dataset(**spec["kw"])
    for name, kw in spec["jobs"]:
        if name.startswith("syncbn"):
            mesh = make_mesh(process_count(), 1)
            res = syncbn((mesh.n_data, mesh.data_index), mesh.data_group)
        else:
            res = summary(run(data, spec["common"], kw, init))
        np.savez(f"{spec['out']}/{name}_rank{process_index()}.npz", **res)
    shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1])
