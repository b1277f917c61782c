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

Prints one JSON line with each phase's result and exits non-zero on any
failed rank or check. The DropoutNet (BatchNorm), resume and CGRC phases of
the JAX dry run wait for ROADMAP.md Queue 1, item 7b.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from .distributed import (
    init_distributed, launch_ranks, process_count, process_index,
    rank_device, shutdown_distributed,
)

TOL = 1e-5  # LightGCN, and MF over a data axis: sums in another order
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


def phases(spec: str, device: str) -> dict:
    """Every phase under mesh ``spec`` ("" = one rank), flattened to
    ``{phase/key: array}``."""
    out = {}
    for name, res in (("mf", _step("MF", spec, device)),
                      ("lightgcn", _step("LightGCN", spec, device, layers=2)),
                      ("serve", _serve(spec, device))):
        out.update({f"{name}/{k}": v for k, v in res.items()})
    return out


def compare(ranks: dict, one: dict, n_data: int, cuda: bool) -> dict:
    """Each phase's verdict: {"ok", "max_abs_err", ...}."""
    def gap(phase, keys):
        return max(float(np.abs(ranks[f"{phase}/{k}"]
                                - one[f"{phase}/{k}"]).max()) for k in keys)

    keys = ("loss", "user_emb", "item_emb")
    mf_gap = gap("mf", keys)
    lg_gap = gap("lightgcn", keys)
    ids_equal = bool(np.array_equal(ranks["serve/ids"], one["serve/ids"]))
    launches = int(ranks["serve/launches"])
    return {
        "mf": {"ok": mf_gap == 0.0 if n_data == 1 else mf_gap <= TOL,
               "max_abs_err": mf_gap, "bit_equal": mf_gap == 0.0},
        "lightgcn": {"ok": lg_gap <= TOL, "max_abs_err": lg_gap},
        "serve": {"ok": ids_equal and (launches > 0 or not cuda),
                  "ids_equal": ids_equal, "fused_sweep_launches": launches,
                  "max_abs_err": float(np.abs(ranks["serve/vals"]
                                              - one["serve/vals"]).max())},
    }


def child(out_dir: str, device: str) -> None:
    init_distributed(device=device)
    dev = str(rank_device(device))
    n_data, n_model = layout(process_count())
    res = phases(f"{n_data}x{n_model}", dev)
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
    one = phases("", a.device)
    verdict = {"ranks": a.ranks, "mesh": f"{n_data}x{n_model}",
               "device": a.device, **compare(per_rank[0], one, n_data, cuda)}
    # every rank of a phase holds the same replicated result
    verdict["ranks_agree"] = all(
        np.array_equal(res[k], per_rank[0][k]) for res in per_rank[1:]
        for k in res if not k.endswith("launches"))
    print(json.dumps(verdict))
    ok = verdict["ranks_agree"] and all(
        verdict[p]["ok"] for p in ("mf", "lightgcn", "serve"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
