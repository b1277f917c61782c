"""A rank of ``tests/test_torch_mesh_train.py``,
``tests/test_torch_mesh_dropoutnet.py``, ``tests/test_torch_mesh_graph.py``,
``tests/test_torch_mesh_cgrc.py`` and the cold models' mesh tests
(``tests/torch_mesh_cold_case.py``): runs each job of a JSON spec (a
model and its flags) on the process group the ``COLDREC_*`` variables
configure, on the CPU, and writes what each run leaves (:func:`summary`) to
``<out>/<job>_rank<r>.npz``. A job named ``syncbn...`` runs
:func:`syncbn` instead, one named ``step...`` :func:`one_step`. Imports no
JAX.

    python tests/torch_mesh_child.py SPEC.json
"""
import contextlib
import json
import os
import pickle
import sys
import time

import numpy as np
import torch

from coldrec_tpu_torch.config import default_args
from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from coldrec_tpu_torch.models import TRAINERS, model_factory
from coldrec_tpu_torch.models import ncl as ncl_mod
from coldrec_tpu_torch.models.common import MaskedBatchNorm1d
from coldrec_tpu_torch.models.mf import MFTrainer
from coldrec_tpu_torch.parallel.distributed import (
    host_block, init_distributed, localize, process_count, process_index,
    shutdown_distributed,
)
from coldrec_tpu_torch.parallel.mesh import make_mesh
from coldrec_tpu_torch.runtime.trainer import Config

# the sync-BN case: a global batch of SYNCBN_ROWS rows, SYNCBN_DIM features
SYNCBN_ROWS, SYNCBN_DIM = 16, 6


def summary(m) -> dict:
    """A finished run's eval tables, per-batch losses, test metrics, overall
    test lists, the shapes of its (local) parameters, the names of its
    row-sharded tables and any BatchNorm running statistics; for DropoutNet
    also its bus tables gathered whole, its tower weights, its BatchNorm
    running statistics and the global masks it drew; for NGCF its Linears,
    for NCL its last clusters; for CGRC its replicated weights but the edge
    MLP's output bias (exact gradient 0: Adam walks it on rounding
    noise)."""
    out = {}
    if hasattr(m.model, "edge_mlp"):
        out["weights"] = np.concatenate([
            p.detach().numpy().reshape(-1)
            for n, p in m.model.named_parameters()
            if n not in ("user_emb", "edge_mlp.1.bias")])
    if hasattr(m.model, "W_gc"):
        out["linears"] = torch.cat([p.detach().reshape(-1) for n, p in
                                    m.model.named_parameters()
                                    if n.startswith("W_")]).numpy()
    if getattr(m, "clusters", None) is not None:
        out["centroids"] = torch.cat([m.clusters[0], m.clusters[2]]).numpy()
        out["assign"] = torch.cat([m.clusters[1], m.clusters[3]]).numpy()
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
    bns = [b for b in m.model.modules() if isinstance(b, MaskedBatchNorm1d)]
    if bns and "bn" not in out:
        out["bn"] = torch.cat([t for b in bns for t in
                               (b.running_mean, b.running_var)]).numpy()
    return {**out,
        "sharded": np.asarray(sorted(m.sharded), dtype=str),
        "user_emb": m.user_emb.numpy(), "item_emb": m.item_emb.numpy(),
        "losses": np.asarray([x for s in m.epoch_stats for x in s["losses"]]),
        "overall": np.asarray(m.overall_test_results),
        "cold": np.asarray(m.cold_test_results),
        "warm": np.asarray(m.warm_test_results),
        "lists": m.test("all"),
        "shapes": np.asarray([tuple(p.shape) for p in m.model.parameters()
                              if p.dim() == 2]),
    }


def wait_for(path: str, timeout: float = 200.0) -> None:
    """Until ``path`` exists (the test writes it while the ranks start,
    whole, by a rename)."""
    end = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(f"{path} never came")
        time.sleep(0.05)


def trainer(data, common: dict, kw: dict, init=None):
    """The trainer of ``kw["model"]`` on ``data`` (MF from ``init``);
    ``kw["jax_init"]``, a pickle of the JAX trainer's (params, net_state),
    carries its weights (waited for: :func:`wait_for`)."""
    kw = dict(kw)
    jax_init = kw.pop("jax_init", None)
    args = default_args(**{**common, "device": "cpu", **kw})
    if kw["model"] == "MF":
        return MFTrainer(Config(args, data), init_params=init)
    if jax_init:
        wait_for(jax_init)
        with open(jax_init, "rb") as f:
            params, state = pickle.load(f)
        extra = {} if state is None else {"init_state": state}
        return TRAINERS[kw["model"]](Config(args, data), init_params=params,
                                     **extra)
    return model_factory(Config(args, data))


@contextlib.contextmanager
def proto_from(epoch):
    """NCL's proto term (and its e-step) on from ``epoch`` (its warm-up of
    ``WARMUP_EPOCHS`` as it is with None)."""
    was = ncl_mod.WARMUP_EPOCHS
    if epoch is not None:
        ncl_mod.WARMUP_EPOCHS = epoch
    try:
        yield
    finally:
        ncl_mod.WARMUP_EPOCHS = was


def run(data, common: dict, kw: dict, init=None):
    """One run of ``kw["model"]`` on ``data`` (:func:`trainer`). DropoutNet
    records the global masks it draws (``drawn``); ``kw["masks"]``, an npz
    of the JAX run's (steps, 2, n) masks, replaces its draws. NCL:
    ``kw["proto_from"]`` turns its proto term and e-step on from that
    epoch; ``kw["clusters"]``, an npz of (user centroids, user -> cluster,
    item centroids, item -> cluster), holds the proto term on with those
    clusters and no e-step. ``kw["draws"]`` (AGNN, GoRec, CLCRec): an npz
    of the JAX run's draws, replacing the loss's (:func:`inject_draws`)."""
    kw = dict(kw)
    masks, clusters = kw.pop("masks", None), kw.pop("clusters", None)
    epoch = kw.pop("proto_from", None)
    draws = kw.pop("draws", None)
    m = trainer(data, common, kw, init)
    if draws:
        inject_draws(m, draws)
    if clusters:
        c = np.load(clusters)
        m.clusters = tuple(torch.from_numpy(c[k]) for k in
                           ("uc", "u2c", "ic", "i2c"))
        m._proto_on = True
        m.epoch_hook = lambda epoch: None
    if kw["model"] == "DropoutNet":
        draw, m.drawn = m.draw_masks, []
        queue = list(np.load(masks)["masks"]) if masks else None

        def recorded(n):
            out = (tuple(torch.from_numpy(x) for x in queue.pop(0))
                   if queue is not None else draw(n))
            m.drawn.append(torch.stack(out))
            return out

        m.draw_masks = recorded
    with proto_from(epoch):
        m.run()
    return m


def inject_draws(m, path: str) -> None:
    """The loss's draws of each step from ``path``, an npz of the JAX run's
    global draws stacked by step: AGNN's ``masks`` (steps, 4, n, 2d) and
    ``normal``, GoRec's ``z``, ``zgc`` and ``keep``, CLCRec's
    ``rand_index``."""
    f = np.load(path)
    steps = iter(range(f[f.files[0]].shape[0]))

    def step():
        i = next(steps)
        return {k: torch.from_numpy(f[k][i]) for k in f.files}

    if m.model_name == "CLCRec":
        m.draw_rand_index = lambda n: step()["rand_index"]
    elif m.model_name == "AGNN":
        def agnn(n):
            d = step()
            return {"masks": list(d["masks"]), "normal": d["normal"]}
        m.draw = agnn
    else:
        m.draw = lambda n: step()


def one_step(data, common: dict, kw: dict) -> dict:
    """The loss of one batch (``kw["batch"]``, an npz of the global host
    batch) with the noise of ``kw["noise"]`` (an npz whose keys are the
    loss's keyword arguments, ``"draws/z"`` an entry of the dict ``draws``)
    injected, and the gradient of every parameter after the sum over the
    data axis, the sharded tables gathered whole; MetaEmbedding's inner
    gradient too (``inner``)."""
    kw = dict(kw)
    batch, noise = dict(np.load(kw.pop("batch"))), np.load(kw.pop("noise"))
    m = trainer(data, common, kw)
    extra = {}
    for k in noise.files:  # "draws/z": extra["draws"]["z"]
        head, _, key = k.partition("/")
        x = torch.from_numpy(noise[k])
        if key:
            extra.setdefault(head, {})[key] = x
        else:
            extra[head] = x
    if "noise_pair" in extra:
        extra["noise_pair"] = tuple(extra["noise_pair"])
    inner = []
    if hasattr(m, "inner_grad"):  # MetaEmbedding: record its inner step
        grad = m.inner_grad

        def recorded(*args):
            inner.append(grad(*args))
            return inner[-1]

        m.inner_grad = recorded
    loss = m.loss(m.upload(batch), **extra)
    loss.backward()
    m._reduce_grads()
    out = {"loss": loss.detach().numpy()}
    if inner:
        out["inner"] = inner[0].detach().numpy()
    for name, p in m.model.named_parameters():
        g = p.grad
        if name in m.sharded:
            g = localize(g, m.mesh.model_group)
        out[f"grad/{name}"] = g.numpy()
    return out


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
        elif name.startswith("step"):
            res = one_step(data, spec["common"], kw)
        else:
            res = summary(run(data, spec["common"], kw, init))
        np.savez(f"{spec['out']}/{name}_rank{process_index()}.npz", **res)
    shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1])
