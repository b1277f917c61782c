"""coldrec_tpu_torch CLI: train + three-way evaluation, on the card.

    python -m coldrec_tpu_torch.main --model MF --dataset <ds> \\
        --data_dir ./data [--device cpu]

The port's copy of the JAX package's ``main.py`` (reference ColdRec
main.py): the same flags (plus ``--device``, default ``cuda``), the
multi-run seed loop (run r uses seed=r when runs>1, else --seed,
main.py:163), mean±std aggregation per topN x {all,cold,warm} x
{hit,precision,recall,ndcg}, seconds per completed epoch, and the text+JSON
result file block (main.py:207-301), appended or overwritten, and the JAX
CLI's ``--profile DIR`` (a ``torch.profiler`` trace of the whole run, with
the card's kernels, exported as a Chrome trace under DIR) and
``--debug_nans`` (autograd's anomaly mode plus the trainer's finite checks
of every step's loss and of the eval tables, ``FloatingPointError`` as
``jax_debug_nans`` raises). Ported: MF,
the graph backbones LightGCN, NGCF, SimGCL, XSimGCL and NCL, the
cold-start models DropoutNet, GAR, ALDI, DeepMusic, DUIF, Heater, AGNN,
VBPR, MetaEmbedding, LARA and GoRec, which read the backbone's tables from
the embedding bus (``--backbone MF`` or a graph backbone: run it first),
AMR, which reads VBPR's bus (run VBPR first), KNN, MTPR and CLCRec, which
train their own tables, and the reconstruction models CCFCRec (its
``--pretrain`` tables from the bus), M2VAE, CGRC and FSGNN, and USIM, the
RL refinement of the backbone's cold item rows (item cold start only): all
26 models of the JAX package.

Several processes: set ``COLDREC_COORDINATOR`` (host:port of rank 0),
``COLDREC_NUM_PROCESSES`` and ``COLDREC_PROCESS_ID`` in each, as for the JAX
CLI. ``run`` opens the process group before any device use
(``parallel/distributed.py``: gloo on the CPU and where ranks share a card),
each rank computes on ``cuda:(rank % cards)`` (or the CPU with ``--device
cpu``), ``--mesh DxM`` lays the ranks out (for the trainers whose
``mesh_support`` is ``"sharded"``; the ``"one_device"`` ones ignore it; no
``--mesh``: data-parallel over every rank), and rank 0 alone writes the
result file;
the ``__main__`` entry leaves through a barrier and
``destroy_process_group``.
"""
from __future__ import annotations

import contextlib
import json
import os
from datetime import datetime

import numpy as np
import torch

from .config import make_args
from .models import model_factory
from .parallel.distributed import (
    init_distributed, process_index, rank_device, shutdown_distributed,
)
from .runtime.trainer import Config
from .utils.seeding import set_seed


def _args_to_serializable(ns):
    out = {}
    for k, v in sorted(vars(ns).items()):
        if isinstance(v, (int, float, str, bool)) or v is None:
            out[k] = v
        elif isinstance(v, (list, tuple)):
            out[k] = list(v)
        else:
            out[k] = repr(v)
    return out


def run(args, on_model=None, data=None, epoch_steps=0) -> dict:
    """Train and test ``args.runs`` times, print the aggregate and write the
    result file; returns the JSON payload. ``--debug_nans`` turns on
    autograd's anomaly mode for the run, ``--profile DIR`` traces it. A
    process group configured by the ``COLDREC_*`` variables opens first.
    ``on_model``, if given, is called with each round's trainer once it
    has run. ``data``, if given, is the ``ColdStartDataset`` of the split
    the flags name, already read; ``epoch_steps`` > 0 cuts every epoch to
    its first that many batches (``Config``)."""
    device = getattr(args, "device", "cuda")
    init_distributed(device=device)
    args.device = str(rank_device(device))
    profile_dir = str(getattr(args, "profile", "") or "")
    with contextlib.ExitStack() as stack:
        if getattr(args, "debug_nans", False):
            stack.enter_context(torch.autograd.set_detect_anomaly(True))
        if profile_dir:
            stack.enter_context(profiled(
                profile_dir, torch.device(getattr(args, "device", "cuda"))))
        return _run(args, on_model, data, epoch_steps)


@contextlib.contextmanager
def profiled(out_dir: str, device: torch.device):
    """``torch.profiler`` over the block: CPU activity, and CUDA activity on
    the card (every kernel, the ctypes-launched ones too). Stopped in a
    ``finally``; then the Chrome trace goes to
    ``out_dir/trace_<time>_<pid>.json`` (the directory made if missing) and
    the top 15 entries by self device time (CPU time on the CPU) are
    printed."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(out_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        stamp = datetime.now().strftime("%Y%m%d-%H%M%S")
        path = os.path.join(out_dir, f"trace_{stamp}_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        sort = "self_device_time_total" if cuda else "self_cpu_time_total"
        print(prof.key_averages().table(sort_by=sort, row_limit=15))
        print(f"Profiler trace written to: {out_dir}")


def _run(args, on_model=None, data=None, epoch_steps=0) -> dict:
    config = Config(args, data, epoch_steps)
    top_ns = [int(x) for x in str(args.topN).split(",")]
    settings = ["all", "cold", "warm"]
    metrics = ["hit", "precision", "recall", "ndcg"]
    results = {
        s: {m: [[] for _ in top_ns] for m in metrics} for s in settings
    }
    time_results = []

    for round_num in range(args.runs):
        print(f"Start round {round_num} running!")
        # run r uses seed=r when runs>1, else --seed (reference main.py:163)
        seed = args.seed if args.runs == 1 else round_num
        set_seed(seed)
        args.seed = seed  # trainers derive their RNG streams from this
        model = model_factory(config)
        print(f"Registered model: {args.model}.")
        model.run()
        if on_model is not None:
            on_model(model)

        for i in range(len(top_ns)):
            for setting, res in [
                ("all", model.overall_test_results),
                ("cold", model.cold_test_results),
                ("warm", model.warm_test_results),
            ]:
                results[setting]["hit"][i].append(res[i][0])
                results[setting]["precision"][i].append(res[i][1])
                results[setting]["recall"][i].append(res[i][2])
                results[setting]["ndcg"][i].append(res[i][3])

        elapsed = model.train_end_time - model.train_start_time
        epochs_done = max(int(getattr(model, "epochs_ran", 0)) or args.epochs, 1)
        time_results.append(elapsed / epochs_done)

    # ---- aggregate + print ----
    metrics_payload = {}
    for i, top_n in enumerate(top_ns):
        print("*" * 80)
        tn = str(top_n)
        metrics_payload[tn] = {}
        for setting_name, key in [
            ("Overall", "all"),
            ("Cold-Start", "cold"),
            ("Warm-Start", "warm"),
        ]:
            print(f"Top-{top_n} {setting_name} Test Performance:")
            stats = {}
            for metric, label in [
                ("hit", "Hit"),
                ("precision", "Precision"),
                ("recall", "Recall"),
                ("ndcg", "NDCG"),
            ]:
                vals = results[key][metric][i]
                stats[label] = {
                    "mean": float(np.mean(vals)),
                    "std": float(np.std(vals)),
                }
            metrics_payload[tn][key] = stats
            print(
                ", ".join(
                    f"{n}@{top_n}: {v['mean']:.4f}±{v['std']:.4f}"
                    for n, v in stats.items()
                )
            )
    mean_time, std_time = float(np.mean(time_results)), float(np.std(time_results))
    print("Efficiency Performance:")
    print(
        f"Time: {mean_time:.4f}±{std_time:.4f} seconds per completed training epoch."
    )

    payload = {
        "method": args.model,
        "hyperparameters": _args_to_serializable(args),
        "metrics": metrics_payload,
        "efficiency": {
            "seconds_per_completed_epoch_mean": mean_time,
            "seconds_per_completed_epoch_std": std_time,
        },
    }
    if process_index() == 0:  # rank-0 writer under a process group
        _write_result_file(args, payload, top_ns)
    return payload


def _write_result_file(args, payload, top_ns):
    if args.result_file and str(args.result_file).strip():
        result_path = os.path.abspath(args.result_file)
    else:
        result_path = os.path.join(
            os.path.abspath(args.result_dir), args.model, args.result_log
        )
    d = os.path.dirname(result_path)
    if d:
        os.makedirs(d, exist_ok=True)

    lines = [
        "=== ColdRec Run Result ===",
        f'timestamp: {datetime.now().isoformat(timespec="seconds")}',
        f"method: {args.model}",
        f"dataset: {args.dataset}",
        f"cold_object: {args.cold_object}",
        f"backbone: {args.backbone}",
        f"runs: {args.runs}",
        "",
        "--- Hyperparameters ---",
    ]
    for k, v in sorted(payload["hyperparameters"].items()):
        lines.append(f"{k}: {v}")
    lines.extend(["", "--- Test Metrics (mean ± std) ---"])
    for top_n in top_ns:
        for setting_name, key in [
            ("Overall", "all"),
            ("Cold-Start", "cold"),
            ("Warm-Start", "warm"),
        ]:
            m = payload["metrics"][str(top_n)][key]
            lines.append(
                f"Top-{top_n} {setting_name}: "
                + ", ".join(
                    f"{n}={v['mean']:.4f}±{v['std']:.4f}" for n, v in m.items()
                )
            )
    eff = payload["efficiency"]
    lines.extend(
        [
            "",
            "--- Efficiency ---",
            f"seconds_per_completed_epoch_mean: {eff['seconds_per_completed_epoch_mean']:.6f}",
            f"seconds_per_completed_epoch_std: {eff['seconds_per_completed_epoch_std']:.6f}",
            "",
            "--- JSON (machine-readable) ---",
            json.dumps(payload, indent=2, ensure_ascii=False),
        ]
    )
    block = "\n".join(lines) + "\n"
    mode = "w" if args.result_overwrite else "a"
    with open(result_path, mode, encoding="utf-8") as f:
        if (
            mode == "a"
            and os.path.isfile(result_path)
            and os.path.getsize(result_path) > 0
        ):
            f.write("\n" + "=" * 80 + "\n")
        f.write(block)
    print(
        f"Results written ({'overwrite' if args.result_overwrite else 'append'}) "
        f"to: {result_path}"
    )


if __name__ == "__main__":
    args = make_args()
    print(args)
    run(args)
    shutdown_distributed()
