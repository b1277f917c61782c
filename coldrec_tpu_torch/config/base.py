"""Common configuration flags (the port's copy of
``coldrec_tpu/config/base.py``; reference main.py:90-143 argparse defaults).

The same flag names and defaults as the JAX package's CLI, plus ``--device``
(default ``cuda``). ``--mesh``, which the port does not carry out yet, is
refused where it takes effect (``models/warm_base.py``), naming the
ROADMAP item that brings it.
"""
from __future__ import annotations

import argparse
from types import SimpleNamespace

COMMON_DEFAULTS = dict(
    dataset="citeulike",
    model="MF",
    epochs=500,
    layers=2,
    topN="10,20",
    bs=4096,
    emb_size=64,
    lr=0.001,
    reg=0.0001,
    runs=1,
    seed=2024,
    save_emb=True,
    # bus artifact format: npz (native) | pt (the reference's torch.save
    # per-tensor layout, for interchange) | both
    save_emb_format="npz",
    cold_object="item",
    backbone="MF",
    early_stop=10,
    eval_every=1,
    data_dir="./data",
    emb_dir="./emb",
    result_dir="./result",
    result_log="history.txt",
    result_file="",
    result_overwrite=False,
    # mid-training checkpoint/resume (empty = off)
    state_ckpt="",
    # device mesh "DxM"; the port runs one device (ROADMAP Queue 1, item 7)
    mesh="",
    # retrieval sweep: auto / pallas = the hand-written retrieval kernel
    # (its plain version on the CPU), pallas_bf16 = its bf16 mode, xla =
    # the plain matmul + top-k
    eval_backend="auto",
    # torch.profiler trace directory (main.py) and NaN trap: anomaly mode
    # and finite checks of each step's loss and of the eval tables
    profile="",
    debug_nans=False,
    # K train steps on one stacked upload, no host sync between them
    # (models/warm_base.py); 0 or 1 = the per-batch loop
    fused_steps=0,
    # the port's device: "cuda" (the card) or "cpu"
    device="cuda",
)


def default_args(**overrides) -> SimpleNamespace:
    d = dict(COMMON_DEFAULTS)
    model = overrides.get("model", d["model"])
    from .model_params import registry_defaults

    d.update(registry_defaults(model))
    d.update(overrides)
    return SimpleNamespace(**d)


def make_args(argv=None) -> argparse.Namespace:
    """Two-stage argparse mirroring the reference CLI (main.py:83-146)."""
    from .model_params import add_model_params

    parser = argparse.ArgumentParser(description="coldrec_tpu_torch")
    for name, val in COMMON_DEFAULTS.items():
        if isinstance(val, bool):
            parser.add_argument(f"--{name}", type=_str2bool, default=val)
        else:
            parser.add_argument(f"--{name}", type=type(val), default=val)
    args, _ = parser.parse_known_args(argv)
    parser = add_model_params(args.model, parser)
    return parser.parse_args(argv)


def _str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")
