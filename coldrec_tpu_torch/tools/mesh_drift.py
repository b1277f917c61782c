"""How far a model's training on a mesh parts from one rank's, in float32
and in float64.

    python -m coldrec_tpu_torch.tools.mesh_drift [--model M]
        [--config ml|bus] [--mesh DxM] [--hidden H1,H2] [--content_seed S]
        [--variants float32,float64,frozen] [--out DIR] [--device cuda|cpu]

On the card (every rank on ``cuda:0``) or, with ``--device cpu``, on the
CPU: writes the split of ``--config`` with N(0,1) item content
(``--content_seed`` in place of the config's seed; under ``ml`` the
model's content columns in place of the config's: 206 for CGRC and the
cold models), and for a model that reads MF's bus (``ON_THE_BUS``) trains
MF on it through the port's CLI (one rank) to write the bus. Then trains
``--model`` (DropoutNet: towers ``--hidden`` wide, else the CLI's default;
SimGCL, XSimGCL, NGCF, NCL: 2 layers, NCL with its proto term and e-step
on from epoch 0; CGRC; the cold models of phase mesh (l)-(v), KNN on a
2-layer LightGCN encoder) by its own loop (validation every epoch, the
best epoch's eval tables kept) on one rank and on the mesh of ranks (each
a subprocess; gloo) from the same seed, with deterministic algorithms,
for each variant:

- ``float32``: as the CLI trains it;
- ``float64``: the module, its float32 tensors (content table, graph
  values) and its Adam state in float64 (converted after construction,
  before the first step), its eval tables cast to float32 for the
  retrieval kernel;
- ``frozen``: float32 with the weights whose exact gradient is 0 taking no
  step (DropoutNet's Linear biases ahead of each BatchNorm, CGRC's edge MLP
  output bias; Adam walks them on rounding noise).

Then each run's best eval tables go through the three-way test. Prints,
for each variant, the largest relative gap of the per-step losses (any
rank against one rank) up to steps 1, 10, 20, 50, 100 and the last, the
largest gaps of the BatchNorm running statistics (DropoutNet's and
GoRec's; none elsewhere)
and of the test metrics; then, with both precisions, one rank's float32
losses against its float64 ones (for SimGCL and XSimGCL two different
noise streams: a float64 U(0,1) draw is not a float32 one); then one JSON
line of the same. The configurations:

- ``ml``: ``chip_smoke.py``'s ``ml_synth`` split (MovieLens-1M's shape,
  one content column; CGRC 206) and phase mesh's flags for the model, 1
  epoch: DropoutNet (f) ``2x2``; XSimGCL (g) ``2x2``, SimGCL (h) ``1x2``,
  NGCF (i) ``2x2``, NCL (j) ``2x2``, CGRC (k) ``2x2``; DUIF, KNN, LARA,
  DeepMusic and Heater ``1x2``, GAR, CLCRec, CCFCRec, AGNN, MetaEmbedding
  and GoRec ``2x2`` ((l)-(v)), each cut to 40 batches (the phase trains
  10);
- ``bus``: ``tests/test_torch_multiprocess_bus.py``'s split, content and
  flags, 2 epochs, ``2x1`` (``--mesh`` in place of it).

``--out`` keeps the split, the bus and the per-rank results (a temporary
directory otherwise). :func:`drift` runs the comparison on a split (and
bus) that exist.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import warnings

import numpy as np
import torch

VARIANTS = ("float32", "float64", "frozen")
# model: (its flags, its mesh and epoch steps under the ml config, its
# content columns or None for the config's)
MODELS = {
    "DropoutNet": ([], "2x2", 0, None),
    "XSimGCL": (["--layers", "2"], "2x2", 40, None),
    "SimGCL": (["--layers", "2"], "1x2", 40, None),
    "NGCF": (["--layers", "2"], "2x2", 40, None),
    "NCL": (["--layers", "2"], "2x2", 40, None),
    "CGRC": ([], "2x2", 40, 206),
    # the cold models of phase mesh (l)-(v), on its 206 content columns
    "DUIF": ([], "1x2", 40, 206),
    "KNN": (["--backbone", "LightGCN", "--layers", "2"], "1x2", 40, 206),
    "LARA": ([], "1x2", 40, 206),
    "DeepMusic": ([], "1x2", 40, 206),
    "Heater": ([], "1x2", 40, 206),
    "GAR": ([], "2x2", 40, 206),
    "CLCRec": ([], "2x2", 40, 206),
    "CCFCRec": ([], "2x2", 40, 206),
    "AGNN": ([], "2x2", 40, 206),
    "MetaEmbedding": ([], "2x2", 40, 206),
    "GoRec": ([], "2x2", 40, 206),
}
# the models that read MF's bus (``write_inputs`` trains it first)
ON_THE_BUS = ("DropoutNet", "GAR", "DeepMusic", "Heater", "AGNN",
              "MetaEmbedding", "LARA", "GoRec")
# the weights whose exact gradient is 0, by model (``frozen``)
ZERO_GRADIENT = {
    "DropoutNet": lambda name: ".lins." in name and name.endswith(".bias"),
    "CGRC": lambda name: name == "edge_mlp.1.bias",
}
MARKS = (1, 10, 20, 50, 100)
MODULE = "coldrec_tpu_torch.tools.mesh_drift"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIGS = {
    # shape, data seed, split seed, content (columns, seed), mesh, flags
    "ml": dict(shape=(6_040, 3_706, 1_000_209), seed=0, split_seed=42,
               content=(1, 2), mesh="2x2",
               flags=["--epochs", "1", "--bs", "4096", "--emb_size", "64",
                      "--lr", "0.001", "--reg", "0.0001", "--seed", "0"]),
    "bus": dict(shape=(150, 120, 3_200), seed=41, split_seed=7,
                content=(12, 3), mesh="2x1",
                flags=["--epochs", "2", "--bs", "256", "--emb_size", "16",
                       "--seed", "11"]),
}


def cli_flags(model: str, root: str, flags: list, device: str) -> list:
    return ["--model", model, "--dataset", "drift", "--data_dir", root,
            "--emb_dir", os.path.join(root, "emb"), "--cold_object", "item",
            "--result_file", os.path.join(root, f"{model}.txt"),
            "--device", device, *flags]


def write_inputs(cfg: dict, root: str, device: str, content_seed=None,
                 columns=None, bus=True):
    """The split, its item content (``columns`` wide, else the config's)
    and, with ``bus``, the MF bus under ``root``."""
    from ..config import make_args
    from ..data.split import cold_start_split, write_split_dir
    from ..data.synthetic import synthetic_interactions
    from ..main import run

    res = cold_start_split(synthetic_interactions(
        *cfg["shape"], seed=cfg["seed"]), cold_object="item",
        seed=cfg["split_seed"])
    write_split_dir(res, root, "drift", "item")
    cols, seed = cfg["content"]
    cols = cols if columns is None else columns
    np.save(os.path.join(root, "drift", "drift_item_content.npy"),
            np.random.default_rng(seed if content_seed is None
                                  else content_seed).standard_normal(
                (res.item_num, cols)).astype(np.float32))
    if not bus:
        return
    run(make_args(cli_flags("MF", root, cfg["flags"] + ["--save_emb",
                                                        "true"], device)))


def noise_walked(name: str, model: str = "DropoutNet") -> bool:
    """A weight of ``model`` whose exact gradient is 0 (DropoutNet: a
    Linear bias ahead of a BatchNorm in its towers)."""
    walked = ZERO_GRADIENT.get(model)
    return bool(walked and walked(name))


def as_float64(t) -> None:
    """Trainer ``t`` in float64: its module, its float32 tensors (the
    content table, a dict's: the backbone's tables), the values of its
    graph operators (the ELL layout's; a mesh graph's edges promote) and
    its optimizer's state."""
    from ..ops.spmm import SymSpmm

    state = t.optimizer.state_dict()
    t.model.double()
    for name, v in list(vars(t).items()):
        if torch.is_tensor(v) and v.dtype == torch.float32:
            setattr(t, name, v.double())
        elif isinstance(v, dict) and any(torch.is_tensor(x)
                                         for x in v.values()):
            # a backbone's tables read from the bus
            setattr(t, name, {k: x.double() if torch.is_tensor(x)
                              and x.dtype == torch.float32 else x
                              for k, x in v.items()})
        elif isinstance(v, SymSpmm):
            v.graph = v.graph._replace(ell_vals=v.graph.ell_vals.double(),
                                       tail_vals=v.graph.tail_vals.double())
    t.optimizer.load_state_dict(state)


def float32_tables(t) -> None:
    """From now on trainer ``t`` casts its eval tables to float32 when it
    refreshes them (the kernel takes float32); refreshed and kept as the
    best tables now."""
    refresh = t.refresh_tables

    def refreshed():
        refresh()
        t.user_emb, t.item_emb = t.user_emb.float(), t.item_emb.float()

    t.refresh_tables = refreshed
    refreshed()
    t.save()


def train(argv: list, variant: str, epoch_steps: int = 0) -> dict:
    """The model of ``argv`` trained by its own loop (validation every
    epoch, the best epoch's eval tables kept; no bus written; every epoch
    cut to ``epoch_steps`` batches where > 0; NCL's proto term on from
    epoch 0), then the three-way test of those tables: {"losses", "bn",
    "metrics"}."""
    from ..config import make_args
    from ..models import model_factory
    from ..models import ncl
    from ..models.common import MaskedBatchNorm1d
    from ..parallel.distributed import rank_device
    from ..runtime.trainer import Config, three_way_test
    from ..utils.seeding import set_seed

    args = make_args(argv)
    args.device = str(rank_device(args.device))
    args.save_emb = False
    set_seed(args.seed)
    t = model_factory(Config(args, epoch_steps=epoch_steps))
    if variant == "float64":
        as_float64(t)
        float32_tables(t)
    if variant == "frozen":
        for name, p in t.model.named_parameters():
            if noise_walked(name, args.model):
                p.requires_grad_(False)
    warmup = ncl.WARMUP_EPOCHS
    ncl.WARMUP_EPOCHS = 0
    try:
        t.train()
    finally:
        ncl.WARMUP_EPOCHS = warmup
    res = three_way_test(t.data, t.user_emb, t.item_emb, topN=t.topN,
                         backend=t.eval_backend, device=t.device,
                         verbose=False, sweep=t.sweep)
    bn = torch.cat([x.reshape(-1) for b in t.model.modules()
                    if isinstance(b, MaskedBatchNorm1d)
                    for x in (b.running_mean, b.running_var)]
                   or [torch.zeros(0)])
    return {"losses": np.asarray([x for st in t.epoch_stats
                                  for x in st["losses"]], np.float64),
            "bn": bn.double().cpu().numpy(),
            "metrics": np.asarray([res[s]["performance"]
                                   for s in ("all", "cold", "warm")]),
            "best_epoch": t.best_performance[0]}


def rank_main(spec_path: str) -> None:
    """One rank: each variant of the spec, its results saved as
    ``<root>/<variant>_rank<r>.npz``."""
    from ..parallel.distributed import (
        init_distributed, process_index, shutdown_distributed,
    )

    with open(spec_path) as f:
        spec = json.load(f)
    init_distributed(device=spec["device"])
    for variant in spec["variants"]:
        np.savez(os.path.join(spec["root"],
                              f"{variant}_rank{process_index()}.npz"),
                 **train(spec["argv"], variant, spec["epoch_steps"]))
    shutdown_distributed()


def gaps(ranks: list, one: np.ndarray) -> dict:
    """The largest relative loss gap of any rank up to each mark."""
    rel = np.max([np.abs(r - one) / np.abs(one) for r in ranks], axis=0)
    return {str(k): float(rel[:k].max())
            for k in MARKS + (len(rel),) if k <= len(rel)}


def drift(argv: list, mesh: str, variants, root: str, timeout=3000,
          env=None, log=print, epoch_steps: int = 0) -> dict:
    """The model of ``argv`` (the CLI's flags, ``--device`` among them)
    on ``mesh``'s ranks against one rank, for each variant, every epoch
    cut to ``epoch_steps`` batches where > 0; the ranks' results go to
    ``root``. Returns {variant: {"steps",
    "loss_rel_gap_up_to", "bn_abs_gap", "metrics_abs_gap", "best_epochs"
    (one rank's first), "one_losses"}}."""
    from ..parallel.distributed import launch_ranks
    from ..parallel.mesh import parse_mesh

    n = int(np.prod(parse_mesh(mesh)))
    device = argv[argv.index("--device") + 1]
    spec = os.path.join(root, "drift_spec.json")
    with open(spec, "w") as f:
        json.dump({"argv": argv + ["--mesh", mesh], "root": root,
                   "variants": list(variants), "device": device,
                   "epoch_steps": epoch_steps}, f)
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [x for x in [env.get("PYTHONPATH")] if x])
    outs = launch_ranks([sys.executable, "-m", MODULE, "--rank", spec], n,
                        timeout, {**env, "OMP_NUM_THREADS": "1"})
    for r, (code, out) in enumerate(outs):
        if code != 0:
            raise RuntimeError(f"rank {r} exited {code}:\n{out[-3000:]}")
    result = {}
    for variant in variants:
        one = train(argv, variant, epoch_steps)
        got = [dict(np.load(os.path.join(root, f"{variant}_rank{r}.npz")))
               for r in range(n)]
        res = result[variant] = {
            "steps": len(one["losses"]),
            "loss_rel_gap_up_to": gaps([g["losses"] for g in got],
                                       one["losses"]),
            **{f"{k}_abs_gap": float(max(np.abs(g[k] - one[k]).max(initial=0.0)
                                         for g in got))
               for k in ("bn", "metrics")},
            "best_epochs": [int(one["best_epoch"])]
            + [int(g["best_epoch"]) for g in got],
            "one_losses": one["losses"].tolist(),
        }
        log(f"  {variant}: {mesh} vs one rank, {res['steps']} steps: "
            "losses' relative gap up to step " + ", ".join(
                f"{k}: {v:.2e}" for k, v in res["loss_rel_gap_up_to"].items())
            + f"; running statistics {res['bn_abs_gap']:.2e}; test metrics "
            f"{res['metrics_abs_gap']:.2e}; best epoch (one, ranks) "
            f"{res['best_epochs']}")
    return result


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rank", default="", help=argparse.SUPPRESS)
    p.add_argument("--model", default="DropoutNet", choices=sorted(MODELS))
    p.add_argument("--config", default="ml", choices=sorted(CONFIGS))
    p.add_argument("--mesh", default="", help="DxM in place of the "
                   "config's (ml: the model's phase mesh group's)")
    p.add_argument("--hidden", default="", help="H1,H2: the towers' widths")
    p.add_argument("--content_seed", type=int, default=None)
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    warnings.simplefilter("ignore", UserWarning)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.set_num_threads(1)
    if a.rank:
        rank_main(a.rank)
        return
    variants = [v for v in a.variants.split(",") if v]
    if set(variants) - set(VARIANTS):
        raise ValueError(f"--variants {a.variants}: of {VARIANTS}")
    cfg = CONFIGS[a.config]
    model_flags, ml_mesh, ml_steps, columns = MODELS[a.model]
    flags = list(cfg["flags"]) + model_flags
    ml = a.config == "ml"
    mesh = a.mesh or (ml_mesh if ml else cfg["mesh"])
    steps = ml_steps if ml else 0
    if a.hidden:
        h1, h2 = a.hidden.split(",")
        flags += ["--dropoutnet_hidden1", h1, "--dropoutnet_hidden2", h2]
    with tempfile.TemporaryDirectory() as tmp:
        root = a.out or tmp
        os.makedirs(root, exist_ok=True)
        write_inputs(cfg, root, a.device, a.content_seed, columns,
                     bus=a.model in ON_THE_BUS)
        result = drift(cli_flags(a.model, root, flags, a.device), mesh,
                       variants, root, epoch_steps=steps)
    one = {v: np.asarray(result[v].pop("one_losses")) for v in result}
    if "float32" in one and "float64" in one:
        result["float32_vs_float64"] = gaps([one["float32"]], one["float64"])
        print("float32 vs float64, one rank: losses' relative gap up to step "
              + ", ".join(f"{k}: {v:.2e}" for k, v in
                          result["float32_vs_float64"].items()))
    print(json.dumps({"model": a.model, "config": a.config, "mesh": mesh,
                      "epoch_steps": steps, "device": a.device,
                      "hidden": a.hidden,
                      "content_seed": a.content_seed, **result}))


if __name__ == "__main__":
    main()
