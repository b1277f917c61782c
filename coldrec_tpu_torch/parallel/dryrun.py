"""Dry run of the mesh on N ranks, each phase against one rank.

    python -m coldrec_tpu_torch.parallel.dryrun --ranks N [--device cpu|cuda]

The port's counterpart of ``__graft_entry__.py::dryrun_multichip``, which
runs the JAX package's sharded step and retrieval on a virtual device mesh
in one process. Here the ranks are real processes (``launch_ranks``: gloo
over localhost; on the card every rank computes on ``cuda:(rank % cards)``),
laid out as a ``D x M`` mesh with M = 2 where N is even (else 1) and
D = N / M. The phases, on one tiny synthetic split, each run by the ranks
and by this process alone (no group), and held against each other:

  * ``mf``: one MF train step (d=16, bs 64) under ``--mesh DxM``: the loss
    and the tables after Adam bit-equal to one rank's where D = 1, else
    within ``TOL``;
  * ``lightgcn``: one LightGCN step (2 layers; the sharded SpMM where
    M > 1), loss and tables within ``TOL``;
  * ``serve``: one request to a mesh ``RetrievalServer`` (1000 items, every
    9th excluded, k=10), ids equal to the unsharded server's; on the card
    every rank must have launched ``fused_sweep`` on its item block.

  * ``bus``: one MF epoch (bs 256) under the mesh writing the embedding
    bus (rank 0 writes), its tables against one rank's bus;
  * ``dropoutnet``: one DropoutNet epoch on that bus under the mesh (its
    BatchNorm statistics over the global batch) with a train state
    checkpoint, its eval tables and BatchNorm running statistics within
    ``TOL`` (bit-equal where D = 1);
  * ``resume``: the same run resumed to epoch 2 from the checkpoint, its bus
    tables row-sharded again (each rank ``1 / M`` of the rows), its eval
    tables within ``TOL`` of one rank's resumed run;
  * ``cgrc``: one CGRC epoch (bs 256) on the item-cold split with its
    content, the user table row-sharded over the model axis, every
    propagation on the gathered table (the JAX dry run's phase 3): test
    metrics finite, the local user table ``1 / M`` of the rows, the eval
    tables within ``TOL`` of one rank's;
  * ``xsimgcl``: one XSimGCL epoch (2 layers, bs 256): its noise drawn as
    the whole plane on every rank, its InfoNCE over the global batch, the
    sharded SpMM where M > 1; the user and item tables row-sharded, the
    losses and eval tables within ``TOL`` of one rank's;
  * ``gar``: one GAR epoch on the bus phase's bus, its (fine-tuned) bus
    tables row-sharded (each rank ``1 / M`` of the rows), the losses and
    eval tables within ``TOL`` of one rank's (bit-equal where D = 1);
  * ``gorec``: one GoRec epoch on that bus (content dropout on): both
    BatchNorms and the uniformity term over the global batch, the losses,
    eval tables and BatchNorm running statistics within ``TOL`` of one
    rank's (every rank's statistics equal: ``ranks_agree``).

Prints one JSON line with each phase's result and exits non-zero on any
failed rank or check.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

from .distributed import (
    init_distributed, launch_ranks, process_count, process_index,
    rank_device, shutdown_distributed,
)

TOL = 1e-5  # LightGCN, and MF over a data axis: sums in another order
PHASES = ("mf", "lightgcn", "serve", "bus", "dropoutnet", "resume", "cgrc",
          "xsimgcl", "gar", "gorec")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def layout(n: int):
    """(D, M) of ``n`` ranks."""
    n_model = 2 if n % 2 == 0 else 1
    return n // n_model, n_model


def _step(model: str, spec: str, device: str, **kw) -> dict:
    from ..config import default_args
    from ..data.synthetic import synthetic_dataset
    from ..models import model_factory
    from ..runtime.trainer import Config

    data, _ = synthetic_dataset(n_users=96, n_items=80, n_inter=1800,
                                cold_object="item", seed=91)
    args = default_args(model=model, dataset="synth", epochs=1, bs=64,
                        emb_size=16, seed=5, save_emb=False, mesh=spec,
                        device=device, **kw)
    trainer = model_factory(Config(args, data))
    batch = next(iter(trainer.batches()))
    loss = trainer.train_step(trainer.upload(batch))
    trainer.refresh_tables()
    return {"loss": loss.cpu().numpy(),
            "user_emb": trainer.user_emb.cpu().numpy(),
            "item_emb": trainer.item_emb.cpu().numpy()}


def _on_the_bus(spec: str, device: str, work: str) -> dict:
    """Phases bus, dropoutnet, resume, gar and gorec under mesh ``spec`` in
    ``work`` (the bus and the checkpoint there)."""
    from ..config import default_args
    from ..data.synthetic import synthetic_dataset
    from ..models import model_factory
    from ..models.common import MaskedBatchNorm1d
    from ..runtime.checkpoints import load_embeddings
    from ..runtime.trainer import Config
    from .distributed import barrier

    data, _ = synthetic_dataset(n_users=96, n_items=80, n_inter=1800,
                                cold_object="item", seed=91)
    emb, ckpt = os.path.join(work, "emb"), os.path.join(work, "dn.ckpt")
    common = dict(dataset="synth", bs=256, emb_size=16, seed=5, mesh=spec,
                  device=device, emb_dir=emb, early_stop=10)

    def run(model, **kw):
        trainer = model_factory(Config(default_args(
            model=model, **common, **kw), data))
        with contextlib.redirect_stdout(io.StringIO()):
            trainer.run()
        return trainer

    run("MF", epochs=1, save_emb=True)
    barrier()
    bus = load_embeddings(emb, "synth", "item", "MF")
    out = {"bus/user_emb": bus["user_emb"], "bus/item_emb": bus["item_emb"]}
    for phase, epochs in (("dropoutnet", 1), ("resume", 2)):
        t = run("DropoutNet", epochs=epochs, save_emb=False, state_ckpt=ckpt,
                dropoutnet_hidden1=16, dropoutnet_hidden2=8)
        bns = [b for b in t.model.modules()
               if isinstance(b, MaskedBatchNorm1d)]
        out.update({
            f"{phase}/user_emb": t.user_emb.cpu().numpy(),
            f"{phase}/item_emb": t.item_emb.cpu().numpy(),
            f"{phase}/bn": torch.cat([x for b in bns for x in (
                b.running_mean, b.running_var)]).cpu().numpy(),
            f"{phase}/table_rows": np.asarray(
                [t.model.user_emb.shape[0], t.model.item_emb.shape[0]]),
        })
    t = run("GAR", epochs=1, save_emb=False)
    out.update(_summary("gar", t, table_rows=np.asarray(
        [t.model.user_emb.shape[0], t.model.item_emb.shape[0]])))
    t = run("GoRec", epochs=1, save_emb=False, pre_cluster_num=8,
            dropout=0.2)
    bns = [b for b in t.model.modules() if isinstance(b, MaskedBatchNorm1d)]
    out.update(_summary("gorec", t, bn=torch.cat([x for b in bns for x in (
        b.running_mean, b.running_var)]).cpu().numpy()))
    return out


def _summary(phase: str, trainer, **extra) -> dict:
    """A one-epoch run's losses and eval tables (and ``extra``), keyed
    ``phase/...``."""
    return {f"{phase}/{k}": v for k, v in {
        "losses": np.asarray(trainer.epoch_stats[0]["losses"]),
        "user_emb": trainer.user_emb.cpu().numpy(),
        "item_emb": trainer.item_emb.cpu().numpy(), **extra}.items()}


def _epoch(model: str, spec: str, device: str, **kw) -> dict:
    """One epoch of ``model`` under mesh ``spec`` (bs 256): its per-batch
    losses, eval tables, overall test metrics and local table heights."""
    from ..config import default_args
    from ..data.synthetic import synthetic_dataset
    from ..models import model_factory
    from ..runtime.trainer import Config

    data, _ = synthetic_dataset(n_users=96, n_items=80, n_inter=1800,
                                cold_object="item", seed=91)
    trainer = model_factory(Config(default_args(
        model=model, dataset="synth", epochs=1, bs=256, emb_size=16, seed=5,
        save_emb=False, early_stop=2, mesh=spec, device=device, **kw),
        data))
    with contextlib.redirect_stdout(io.StringIO()):
        trainer.run()
    m = trainer.model
    return {"losses": np.asarray(trainer.epoch_stats[0]["losses"]),
            "user_emb": trainer.user_emb.cpu().numpy(),
            "item_emb": trainer.item_emb.cpu().numpy(),
            "metrics": np.asarray(trainer.overall_test_results, float),
            "table_rows": np.asarray([m.user_emb.shape[0]] + (
                [m.item_emb.shape[0]] if hasattr(m, "item_emb") else []))}


def _serve(spec: str, device: str) -> dict:
    from ..ops.cuda.retrieval import fused_sweep
    from ..runtime.serving import RetrievalServer
    from .mesh import make_mesh, parse_mesh

    rng = np.random.default_rng(23)
    users = rng.standard_normal((64, 16)).astype(np.float32)
    items = rng.standard_normal((1000, 16)).astype(np.float32)
    mesh = make_mesh(*parse_mesh(spec)) if spec else None
    fused_sweep.launches = 0
    srv = RetrievalServer(users, items, exclude_items=np.arange(0, 1000, 9),
                          device=device, mesh=mesh)
    vals, ids = srv.topk(np.arange(24), 10, exclude_rated=False)
    return {"vals": vals, "ids": ids,
            "launches": np.asarray(fused_sweep.launches)}


def phases(spec: str, device: str, work: Optional[str] = None) -> dict:
    """Every phase under mesh ``spec`` ("" = one rank), flattened to
    ``{phase/key: array}``; the bus and the checkpoint go under ``work``
    (a temporary directory if None)."""
    out = {}
    for name, res in (("mf", _step("MF", spec, device)),
                      ("lightgcn", _step("LightGCN", spec, device, layers=2)),
                      ("serve", _serve(spec, device)),
                      ("cgrc", _epoch("CGRC", spec, device)),
                      ("xsimgcl", _epoch("XSimGCL", spec, device,
                                         layers=2))):
        out.update({f"{name}/{k}": v for k, v in res.items()})
    with contextlib.ExitStack() as stack:
        if work is None:
            work = stack.enter_context(tempfile.TemporaryDirectory())
        out.update(_on_the_bus(spec, device, work))
    return out


def compare(ranks: dict, one: dict, n_data: int, n_model: int,
            cuda: bool) -> dict:
    """Each phase's verdict: {"ok", "max_abs_err", ...}."""
    def gap(phase, keys):
        return max(float(np.abs(ranks[f"{phase}/{k}"]
                                - one[f"{phase}/{k}"]).max()) for k in keys)

    keys = ("loss", "user_emb", "item_emb")
    mf_gap = gap("mf", keys)
    lg_gap = gap("lightgcn", keys)
    ids_equal = bool(np.array_equal(ranks["serve/ids"], one["serve/ids"]))
    launches = int(ranks["serve/launches"])
    tables = ("user_emb", "item_emb")
    bus_gap = gap("bus", tables)
    dn_gap = gap("dropoutnet", tables + ("bn",))
    resume_gap = gap("resume", tables + ("bn",))
    rows = one["resume/table_rows"] // n_model
    sharded = bool(np.array_equal(ranks["resume/table_rows"], rows))
    epochs = {}
    for phase in ("cgrc", "xsimgcl"):
        err = gap(phase, ("losses",) + tables)
        rows_ok = bool(np.array_equal(ranks[f"{phase}/table_rows"],
                                      one[f"{phase}/table_rows"] // n_model))
        finite = bool(np.isfinite(ranks[f"{phase}/metrics"]).all())
        epochs[phase] = {"ok": err <= TOL and rows_ok and finite,
                         "max_abs_err": err, "finite_metrics": finite,
                         "sharded_rows":
                         ranks[f"{phase}/table_rows"].tolist()}
    for phase, keys in (("gar", ("losses",) + tables),
                        ("gorec", ("losses", "bn") + tables)):
        err = gap(phase, keys)
        epochs[phase] = {"ok": err == 0.0 if n_data == 1 else err <= TOL,
                         "max_abs_err": err, "bit_equal": err == 0.0}
    gar_rows = one["gar/table_rows"] // n_model
    epochs["gar"]["sharded_rows"] = ranks["gar/table_rows"].tolist()
    epochs["gar"]["ok"] &= bool(np.array_equal(ranks["gar/table_rows"],
                                               gar_rows))
    return {
        "bus": {"ok": bus_gap == 0.0 if n_data == 1 else bus_gap <= TOL,
                "max_abs_err": bus_gap},
        "dropoutnet": {"ok": dn_gap == 0.0 if n_data == 1 else dn_gap <= TOL,
                       "max_abs_err": dn_gap, "bit_equal": dn_gap == 0.0},
        "resume": {"ok": (resume_gap == 0.0 if n_data == 1
                          else resume_gap <= TOL) and sharded,
                   "max_abs_err": resume_gap, "sharded_rows":
                   ranks["resume/table_rows"].tolist()},
        "mf": {"ok": mf_gap == 0.0 if n_data == 1 else mf_gap <= TOL,
               "max_abs_err": mf_gap, "bit_equal": mf_gap == 0.0},
        "lightgcn": {"ok": lg_gap <= TOL, "max_abs_err": lg_gap},
        "serve": {"ok": ids_equal and (launches > 0 or not cuda),
                  "ids_equal": ids_equal, "fused_sweep_launches": launches,
                  "max_abs_err": float(np.abs(ranks["serve/vals"]
                                              - one["serve/vals"]).max())},
        **epochs,
    }


def child(out_dir: str, device: str) -> None:
    init_distributed(device=device)
    dev = str(rank_device(device))
    n_data, n_model = layout(process_count())
    res = phases(f"{n_data}x{n_model}", dev, os.path.join(out_dir, "work"))
    np.savez(os.path.join(out_dir, f"rank{process_index()}.npz"), **res)
    shutdown_distributed()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=600)
    a = ap.parse_args(argv)
    if a.child:
        child(a.child, a.device)
        return 0
    cuda = torch.device(a.device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("--device cuda asked for, and torch.cuda.is_available() is "
              "False", file=sys.stderr)
        return 1
    n_data, n_model = layout(a.ranks)
    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
        # the ranks share the host's cores
        env.setdefault("OMP_NUM_THREADS",
                       str(max(1, (os.cpu_count() or 1) // a.ranks)))
        runs = launch_ranks(
            [sys.executable, "-m", "coldrec_tpu_torch.parallel.dryrun",
             "--device", a.device, "--child", tmp], a.ranks,
            timeout=a.timeout, env=env)
        for r, (code, out) in enumerate(runs):
            if code != 0:
                print(f"rank {r} exited {code}:\n{out[-4000:]}",
                      file=sys.stderr)
                return 1
        per_rank = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                    for r in range(a.ranks)]
        one = phases("", a.device, os.path.join(tmp, "one"))
    verdict = {"ranks": a.ranks, "mesh": f"{n_data}x{n_model}",
               "device": a.device,
               **compare(per_rank[0], one, n_data, n_model, cuda)}
    # every rank of a phase holds the same replicated result
    verdict["ranks_agree"] = all(
        np.array_equal(res[k], per_rank[0][k]) for res in per_rank[1:]
        for k in res if not k.endswith("launches"))
    print(json.dumps(verdict))
    ok = verdict["ranks_agree"] and all(verdict[p]["ok"] for p in PHASES)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
