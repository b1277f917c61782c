"""A rank of ``tests/test_torch_mesh_train.py``: runs each job of a JSON
spec (a model and its flags) on the process group the ``COLDREC_*``
variables configure, on the CPU, and writes what each run leaves
(:func:`summary`) to ``<out>/<job>_rank<r>.npz``. Imports no JAX.

    python tests/torch_mesh_child.py SPEC.json
"""
import json
import sys

import numpy as np
import torch

from coldrec_tpu_torch.config import default_args
from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from coldrec_tpu_torch.models import model_factory
from coldrec_tpu_torch.models.mf import MFTrainer
from coldrec_tpu_torch.parallel.distributed import (
    init_distributed, process_index, shutdown_distributed,
)
from coldrec_tpu_torch.runtime.trainer import Config


def summary(m) -> dict:
    """A finished run's eval tables, per-batch losses, test metrics, overall
    test lists and the shapes of its (local) parameters."""
    return {
        "user_emb": m.user_emb.numpy(), "item_emb": m.item_emb.numpy(),
        "losses": np.asarray([x for s in m.epoch_stats for x in s["losses"]]),
        "overall": np.asarray(m.overall_test_results),
        "cold": np.asarray(m.cold_test_results),
        "warm": np.asarray(m.warm_test_results),
        "lists": m.test("all"),
        "shapes": np.asarray([tuple(p.shape) for p in m.model.parameters()]),
    }


def run(data, common: dict, kw: dict, init=None):
    """One run of ``kw["model"]`` on ``data`` (MF from ``init``)."""
    args = default_args(**{**common, "device": "cpu", **kw})
    if kw["model"] == "MF":
        m = MFTrainer(Config(args, data), init_params=init)
    else:
        m = model_factory(Config(args, data))
    m.run()
    return m


def main(spec_path: str) -> None:
    torch.set_num_threads(1)
    init_distributed(device="cpu")
    with open(spec_path) as f:
        spec = json.load(f)
    init = dict(np.load(spec["init"]))
    data, _ = synthetic_dataset(**spec["kw"])
    for name, kw in spec["jobs"]:
        m = run(data, spec["common"], kw, init)
        np.savez(f"{spec['out']}/{name}_rank{process_index()}.npz",
                 **summary(m))
    shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1])
