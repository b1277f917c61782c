"""Whole runs of the port's CLI at a published dataset shape, timed.

    python -m coldrec_tpu_torch.tools.scale_run --model MF --epochs 2
    python -m coldrec_tpu_torch.tools.scale_run --model DropoutNet \\
        --shape xing [--backbone MF] [--backbone_epochs 2] [--workdir DIR] \\
        [--device cpu] [flags of coldrec_tpu_torch.main ...]

The port's counterpart of the JAX package's ``tools/scale_run.py``. It
writes a synthetic dataset at a published shape: ``--shape bx``
(book-crossing: 92,107 x 270,170, the widest item axis) or ``--shape xing``
(XING: 106,881 x 20,519, ~3.86M interactions, item content 2,738 wide: the
heaviest interaction count and content width), in the reference file
layout, then times one whole run of ``python -m coldrec_tpu_torch.main``
(training, validation every epoch, the three-way test) of the model in a
subprocess, and prints one JSON line per run: ``scale_run`` (the model),
``epochs``, ``wall_seconds`` and ``sec_per_epoch`` (from the result file's
``--- JSON`` block).

A model outside ``WARM`` reads a backbone's tables from the npz bus: where
that file is missing, the backbone (``--backbone``) runs first for
``--backbone_epochs`` with ``--save_emb 1``. Flags this tool does not know
go to the model's run only; ``--device`` goes to both runs. Without it the
runs take the card, and with no card the tool fails before it builds
anything.

The dataset is the JAX tool's, byte for byte under the same numpy (its
zipf draws differ between numpy versions): ``synthetic_interactions`` at
the shape's counts (seed 7), ``cold_start_split`` (seed 49), the seven CSVs
and ``info_dict.pkl``, and the cold side's content, N(0,1) of the shape's
width from seed 8, in ``<shape>_<cold_object>_content.npy``. It is built
once under ``--workdir`` (default ``coldrec_tpu_torch/_scale/<shape>_workdir``,
which git ignores; its ``info_dict.pkl`` marks it built): delete the
directory to build it again. Result files go to ``<workdir>/results``, the
bus to ``<workdir>/emb``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import List, Optional, Sequence

import numpy as np

from ..data.split import cold_start_split, write_split_dir
from ..data.synthetic import synthetic_interactions
from ..device import resolve_device

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PACKAGE)

# The JAX tool's shapes (reference data/README.md:9-11): n_inter is drawn
# before the split's deduplication and the appearance guarantees.
SHAPES = {
    "bx": dict(
        n_users=92_107, n_items=270_170, n_inter=675_000, content_dim=64
    ),
    "xing": dict(
        n_users=106_881, n_items=20_519, n_inter=4_400_000, content_dim=2_738
    ),
}
SCALE_SHAPE = os.environ.get("SCALE_SHAPE", "bx")

# Warm-backbone models: anything else needs a backbone artifact first.
WARM = {"MF", "NGCF", "LightGCN", "NCL", "SimGCL", "XSimGCL"}


def default_workdir(shape: str) -> str:
    return os.path.join(PACKAGE, "_scale", f"{shape}_workdir")


def build_split(shape: str, cold_object: str = "item", seed: int = 7):
    """(pairs, SplitResult, content) of the shape, in memory."""
    s = SHAPES[shape]
    pairs = synthetic_interactions(s["n_users"], s["n_items"], s["n_inter"],
                                   seed=seed)
    res = cold_start_split(pairs, cold_object=cold_object, seed=seed + 42)
    n_side = res.item_num if cold_object == "item" else res.user_num
    content = np.random.default_rng(seed + 1).standard_normal(
        (n_side, s["content_dim"])).astype(np.float32)
    return pairs, res, content


def build_dataset(workdir: str, shape: str, cold_object: str = "item",
                  seed: int = 7) -> Optional[dict]:
    """Write the shape's split directory and content under
    ``workdir/data`` unless its ``info_dict.pkl`` is there; returns the
    seconds of each stage (None when it was there)."""
    data_dir = os.path.join(workdir, "data")
    marker = os.path.join(data_dir, shape, f"cold_{cold_object}",
                          "info_dict.pkl")
    if os.path.exists(marker):
        return None
    t0 = time.perf_counter()
    pairs, res, content = build_split(shape, cold_object, seed)
    t1 = time.perf_counter()
    write_split_dir(res, data_dir, shape, cold_object)
    t2 = time.perf_counter()
    np.save(os.path.join(data_dir, shape, f"{shape}_{cold_object}_content.npy"),
            content)
    t3 = time.perf_counter()
    stats = {"draw_s": t1 - t0, "csv_s": t2 - t1, "npy_s": t3 - t2,
             "seconds": t3 - t0}
    print(f"[scale_run] dataset built: {res.user_num} x {res.item_num}, "
          f"{len(pairs)} raw pairs, {res.warm_train.shape[0]} warm-train "
          f"pairs, content {content.shape[1]} wide, {stats['seconds']:.1f}s "
          f"(draws, split and content {stats['draw_s']:.2f}s, CSVs "
          f"{stats['csv_s']:.2f}s, content file {stats['npy_s']:.2f}s)",
          flush=True)
    return stats


def result_payload(path: str) -> dict:
    """The ``--- JSON`` block of a result file ({} if absent)."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        text = f.read()
    marker = "--- JSON"
    if marker not in text:
        return {}
    blob = text[text.index(marker):]
    blob = blob[blob.index("{"):]
    try:
        return json.JSONDecoder().raw_decode(blob)[0]
    except ValueError:
        return {}


def run_model(workdir: str, shape: str, model: str, epochs: int,
              extra: Sequence[str], cold_object: str) -> dict:
    """One CLI run of ``model`` on the shape's split, timed; prints and
    returns its JSON line."""
    out_dir = os.path.join(workdir, "results")
    os.makedirs(out_dir, exist_ok=True)
    result_file = os.path.join(out_dir, f"{model}.json")
    cmd = [
        sys.executable, "-m", "coldrec_tpu_torch.main",
        "--dataset", shape,
        "--model", model,
        "--epochs", str(epochs),
        "--runs", "1",
        "--cold_object", cold_object,
        "--data_dir", os.path.join(workdir, "data"),
        "--emb_dir", os.path.join(workdir, "emb"),
        "--result_dir", out_dir,
        "--result_file", result_file,
        "--result_overwrite", "1",
        *extra,
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"{model} run failed rc={proc.returncode}")
    payload = result_payload(result_file)
    line = {
        "scale_run": model,
        "epochs": epochs,
        "wall_seconds": round(wall, 1),
        "sec_per_epoch": payload.get("efficiency", {}).get(
            "seconds_per_completed_epoch_mean"),
    }
    print(json.dumps(line), flush=True)
    return line


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="CGRC")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--backbone", default="MF")
    p.add_argument("--backbone_epochs", type=int, default=2)
    p.add_argument("--cold_object", default="item")
    p.add_argument("--shape", default=SCALE_SHAPE, choices=list(SHAPES))
    p.add_argument("--workdir", default="")
    p.add_argument("--device", default=None,
                   help="given to both runs; without it they take the card")
    args, extra = p.parse_known_args(argv)  # unknown flags go to the model
    resolve_device(args.device or "cuda")
    device = ["--device", args.device] if args.device else []
    workdir = os.path.abspath(args.workdir or default_workdir(args.shape))
    build_dataset(workdir, args.shape, cold_object=args.cold_object)

    lines = []
    if args.model not in WARM:
        bus = os.path.join(
            workdir, "emb",
            f"{args.shape}_cold_{args.cold_object}_{args.backbone}_emb.npz")
        if not os.path.exists(bus):
            print(f"[scale_run] backbone {args.backbone} first...", flush=True)
            lines.append(run_model(workdir, args.shape, args.backbone,
                                   args.backbone_epochs,
                                   ["--save_emb", "1", *device],
                                   args.cold_object))
    lines.append(run_model(workdir, args.shape, args.model, args.epochs,
                           [*extra, *device], args.cold_object))
    return lines


if __name__ == "__main__":
    main()
