"""Hyperparameter search on the port (the port's copy of the root
``param_search.py``; reference: ColdRec param_search.py).

    python -m coldrec_tpu_torch.param_search [--n_trials N] <main flags>

Objective: overall-test NDCG at the first topN (param_search.py:356). The
per-model suggestion spaces mirror the reference's `_apply_optuna_suggestions`
(param_search.py:60-337). Best params are pickled to
``./param/<model>_<ds>_<obj>_bb_<backbone>_cs.pkl`` after each completed
trial (param_search.py:25-48) and can be inspected with
``python -m coldrec_tpu_torch.param.view_best``.

Backends: optuna (sqlite ``optuna.db``, resumable via load_if_exists,
param_search.py:421-426) when importable; otherwise a built-in resumable
random-search backend (JSONL journal under ./param/). The suggestion
spaces, the samplers, the per-trial seeds, the journal, the pickle and its
sidecar are the JAX driver's, byte for byte: a journal either driver wrote
is resumed by the other.

Every trial trains and tests on the port's device (``--device``, default
the card), so its validation and test go through the retrieval kernel.
Between trials the trainer and its tables are dropped and the allocator's
cache emptied, so a search does not grow the card's memory from trial to
trial; each trial prints its seconds, its ``fused_sweep`` launches and the
card's allocated bytes after it and at its peak (kept in
:data:`TRIAL_STATS`).

Failed trials: the one place the port differs from the JAX driver, which
journals any ``Exception`` as ``-Infinity`` and goes on. Here an ordinary
exception and ``torch.cuda.OutOfMemoryError`` are journaled so, but a CUDA
error is not: the kernel binding's (``ops.cuda.build.CudaLaunchError``)
and torch's own (``torch.AcceleratorError``) propagate and end the search
with a non-zero exit. A sticky CUDA error would fail every later trial
while the search still exited 0, hiding a kernel fault. For the same
reason a search asked to run on a card the machine lacks stops before its
first trial.
"""
from __future__ import annotations

import gc
import hashlib
import json
import math
import os
import pickle
import random
import time

import torch

from .config import make_args
from .device import resolve_device
from .models import model_factory
from .ops.cuda.build import CudaLaunchError
from .ops.cuda.retrieval import fused_sweep
from .runtime.trainer import Config
from .utils.seeding import set_seed

# a CUDA error ends the search; every other exception is a failed trial
FATAL_ERRORS = (CudaLaunchError,) + tuple(
    e for e in (getattr(torch, "AcceleratorError", None),) if e is not None)
# one dict per trial run in this process: trial, seconds, fused_sweep
# launches, the card's allocated bytes after it and at its peak (None on
# the CPU)
TRIAL_STATS = []

HIDDEN_DIM_CHOICES = [100, 150, 200, 300]


def _suggest_float_log(trial, name, lo, hi):
    return trial.suggest_float(name, lo, hi, log=True)


def apply_suggestions(trial, args) -> None:
    """Mirror of the reference suggestion spaces (param_search.py:60-337)."""
    m = args.model
    if m in ("VBPR", "AMR", "MTPR"):
        args.p_emb = [
            trial.suggest_categorical("p_emb_lr", [1e-4, 5e-3, 1e-3, 5e-2, 1e-2, 0.05]),
            trial.suggest_categorical("p_emb_wd", [0.0, 1e-6, 1e-5, 1e-4]),
        ]
        args.p_ctx = [
            trial.suggest_categorical("p_ctx_lr", [1e-4, 5e-3, 1e-3, 1e-2, 0.05]),
            trial.suggest_categorical("p_ctx_wd", [0.0, 1e-4, 1e-3, 1e-2, 0.05]),
        ]
        if m == "AMR":
            args.eps = trial.suggest_categorical("amr_eps", [0.05, 0.1, 0.2, 0.3])
            args.lmd = trial.suggest_categorical("amr_lmd", [0.5, 1.0, 1.5, 2.0])
        if m == "MTPR":
            args.p_proj = [
                trial.suggest_categorical("p_proj_lr", [1e-4, 5e-3, 1e-3, 1e-2, 0.05]),
                trial.suggest_categorical("p_proj_wd", [0.0, 1e-4, 1e-3, 1e-2, 0.05]),
            ]
        args.lr = args.p_emb[0]
    else:
        args.lr = trial.suggest_categorical("lr", [1e-4, 5e-3, 1e-3, 5e-2, 1e-2])
    args.reg = trial.suggest_categorical("reg", [1e-5, 5e-4, 1e-4, 5e-3, 1e-3])
    args.emb_size = 64

    if m == "KNN":
        args.knn_num = trial.suggest_int("knn_num", 3, 12)
    elif m in ("LightGCN", "NGCF"):
        args.layers = trial.suggest_int("layers", 1, 3)
    elif m == "SimGCL":
        args.layers = trial.suggest_int("layers", 1, 3)
        args.cl_rate = trial.suggest_categorical("cl_rate", [0.0, 0.2, 0.4, 0.5, 0.6, 0.8, 1.0])
        args.tau = trial.suggest_categorical("tau", [0.2, 0.4, 0.6, 0.8, 1.0])
        args.eps = trial.suggest_categorical("eps", [0.1, 0.2, 0.3, 0.4, 0.5])
    elif m == "XSimGCL":
        args.layers = trial.suggest_int("layers", 1, 3)
        args.l_cl = trial.suggest_int("l_cl", 1, args.layers)
        args.cl_rate = trial.suggest_categorical("cl_rate", [0.0, 0.2, 0.4, 0.5, 0.6, 0.8, 1.0])
        args.tau = trial.suggest_categorical("tau", [0.2, 0.4, 0.6, 0.8, 1.0])
        args.eps = trial.suggest_categorical("eps", [0.1, 0.2, 0.3, 0.4, 0.5])
    elif m == "NCL":
        args.layers = trial.suggest_int("layers", 1, 3)
        hl_max = args.layers // 2
        args.hyper_layers = (
            0 if hl_max < 1 else trial.suggest_int("hyper_layers", 1, hl_max)
        )
        args.alpha = trial.suggest_categorical("alpha", [0.5, 1.0, 1.5, 2.0])
        args.ssl_reg = _suggest_float_log(trial, "ssl_reg", 1e-8, 1e-4)
        args.proto_reg = _suggest_float_log(trial, "proto_reg", 1e-8, 1e-4)
        args.tau = trial.suggest_categorical("tau", [0.01, 0.05, 0.1, 0.2, 0.5])
        args.num_clusters = trial.suggest_categorical("num_clusters", [20, 50, 80, 100, 200, 500])
    elif m == "ALDI":
        args.alpha = trial.suggest_categorical("alpha", [0.5, 1.0, 1.5, 2.0])
        args.beta = trial.suggest_categorical("beta", [0.05, 0.1, 0.2, 0.5])
        args.gamma = trial.suggest_categorical("gamma", [0.1, 0.2, 0.5, 1.0])
        args.tws = trial.suggest_categorical("tws", [0, 1])
        args.freq_coef_M = trial.suggest_categorical("freq_coef_M", [2.0, 4.0, 6.0, 8.0])
        args.aldi_hidden = trial.suggest_categorical("aldi_hidden", HIDDEN_DIM_CHOICES)
    elif m == "GAR":
        args.alpha = trial.suggest_categorical("alpha", [0.05, 0.1, 0.2, 0.5])
        args.beta = trial.suggest_categorical("beta", [0.05, 0.1, 0.2, 0.5])
    elif m == "CLCRec":
        args.num_neg = trial.suggest_categorical("num_neg", [32, 64, 128, 256])
        args.temp_value = trial.suggest_categorical("temp_value", [0.1, 0.2, 0.5, 1.0, 2.0])
        args.lr_lambda = trial.suggest_categorical("lr_lambda", [0.1, 0.2, 0.5, 1.0])
        args.num_sample = trial.suggest_categorical("num_sample", [0.1, 0.2, 0.5, 1.0])
    elif m == "CCFCRec":
        args.positive_number = trial.suggest_categorical("positive_number", [2, 5, 10])
        args.negative_number = trial.suggest_categorical("negative_number", [10, 20, 40, 80])
        args.self_neg_number = trial.suggest_categorical("self_neg_number", [10, 20, 40, 80])
        args.tau = trial.suggest_categorical("ccfc_tau", [0.1, 0.2, 0.5, 1.0])
        args.lambda1 = trial.suggest_categorical("lambda1", [0.2, 0.4, 0.6, 0.8, 1.0])
        args.pretrain = trial.suggest_categorical("pretrain", [False, True])
        args.pretrain_update = trial.suggest_categorical("pretrain_update", [False, True])
    elif m == "DropoutNet":
        args.n_dropout = trial.suggest_categorical("n_dropout", [0.2, 0.5, 0.8])
        args.dropoutnet_hidden1 = trial.suggest_categorical("dropoutnet_hidden1", HIDDEN_DIM_CHOICES)
        args.dropoutnet_hidden2 = trial.suggest_categorical("dropoutnet_hidden2", HIDDEN_DIM_CHOICES)
    elif m == "Heater":
        args.n_expert = trial.suggest_categorical("n_expert", [3, 5, 7])
        args.n_dropout = trial.suggest_categorical("heater_n_dropout", [0.2, 0.5, 0.8])
        args.alpha = trial.suggest_categorical("heater_alpha", [0.2, 0.5, 0.8])
        args.heater_mlp_hidden = trial.suggest_categorical("heater_mlp_hidden", HIDDEN_DIM_CHOICES)
    elif m == "MetaEmbedding":
        args.alpha = trial.suggest_categorical("meta_alpha", [0.2, 0.5, 0.8])
    elif m == "GoRec":
        args.pre_cluster_num = trial.suggest_categorical("pre_cluster_num", [20, 50, 80, 100, 200, 500])
        args.uni_coeff = trial.suggest_categorical("uni_coeff", [1, 5, 10, 15])
        args.kl_coeff = trial.suggest_categorical("kl_coeff", [10, 50, 100, 500, 1000])
        args.dropout = trial.suggest_categorical("gorec_dropout", [0.0, 0.2, 0.5])
    elif m == "AGNN":
        args.agnn_knn_k = trial.suggest_int("agnn_knn_k", 5, 20)
        args.agnn_dropout = trial.suggest_categorical("agnn_dropout", [0.3, 0.4, 0.5, 0.6])
        args.agnn_rank_weight = trial.suggest_categorical("agnn_rank_weight", [0.5, 1.0, 1.5, 2.0])
        args.agnn_align_weight = trial.suggest_categorical("agnn_align_weight", [0.5, 1.0, 1.5, 2.0])
        args.agnn_vae_lambda = trial.suggest_categorical("agnn_vae_lambda", [0.5, 1.0, 1.5, 2.0])
        args.agnn_finetune = trial.suggest_categorical("agnn_finetune", [False, True])
        args.agnn_no_backbone = trial.suggest_categorical("agnn_no_backbone", [False, True])
    # (M2VAE / CGRC / FSGNN / USIM spaces mirror the reference analogously)
    elif m == "M2VAE":
        args.positive_number = trial.suggest_categorical("positive_number", [5, 10, 20])
        args.negative_number = trial.suggest_categorical("negative_number", [20, 40, 80])
        args.self_neg_number = trial.suggest_categorical("self_neg_number", [20, 40, 80])
        args.tau = trial.suggest_categorical("m2vae_tau", [0.05, 0.1, 0.2, 0.5])
        args.m2vae_weight_decay = trial.suggest_categorical("m2vae_weight_decay", [0.01, 0.05, 0.1, 0.2])
        args.m2vae_kld_weight = trial.suggest_categorical("m2vae_kld_weight", [0.5, 1.0, 2.0])
        args.m2vae_recon_weight = trial.suggest_categorical("m2vae_recon_weight", [0.5, 1.0, 2.0])
        args.m2vae_decouple_weight = trial.suggest_categorical("m2vae_decouple_weight", [50.0, 100.0, 200.0])
    elif m == "CGRC":
        args.cgrc_mask_rho = trial.suggest_categorical("cgrc_mask_rho", [0.1, 0.2, 0.3, 0.4, 0.5])
        args.cgrc_recon_topk = trial.suggest_categorical("cgrc_recon_topk", [10, 20, 30, 40])
        args.cgrc_layers_gprime = trial.suggest_int("cgrc_layers_gprime", 1, 3)
        args.cgrc_lambda_e = trial.suggest_categorical("cgrc_lambda_e", [0.5, 1.0, 1.5, 2.0])
        args.cgrc_tau = trial.suggest_categorical("cgrc_tau", [0.2, 0.5, 1.0])
    elif m == "FSGNN":
        args.fsgnn_lambda_fc = trial.suggest_categorical("fsgnn_lambda_fc", [0.25, 0.5, 0.75, 1.0])
        args.fsgnn_mu_sc = trial.suggest_categorical("fsgnn_mu_sc", [0.25, 0.5, 0.75, 1.0])
        args.fsgnn_p_drop = trial.suggest_categorical("fsgnn_p_drop", [0.1, 0.2, 0.3, 0.4])
        args.fsgnn_knn_k = trial.suggest_categorical("fsgnn_knn_k", [10, 15, 20, 25])
        args.fsgnn_light_layers = trial.suggest_int("fsgnn_light_layers", 1, 3)
    elif m == "USIM":
        args.actor_lr = trial.suggest_categorical("actor_lr", [1e-4, 2.5e-4, 5e-4, 1e-3])
        args.critic_lr = trial.suggest_categorical("critic_lr", [1e-4, 5e-4, 1e-3, 2e-3])
        args.gamma = trial.suggest_categorical("usim_gamma", [0.95, 0.99, 0.995])
        args.usim_max_time = trial.suggest_int("usim_max_time", 5, 10)
        args.usim_k = trial.suggest_categorical("usim_k", [5, 10, 15, 20])


class RandomTrial:
    """Fallback trial with the optuna suggest API over a seeded RNG."""

    def __init__(self, rng: random.Random):
        self.rng = rng
        self.params = {}

    def suggest_categorical(self, name, choices):
        v = self.rng.choice(list(choices))
        self.params[name] = v
        return v

    def suggest_int(self, name, lo, hi):
        v = self.rng.randint(lo, hi)
        self.params[name] = v
        return v

    def suggest_float(self, name, lo, hi, log=False):
        if log:
            v = math.exp(self.rng.uniform(math.log(lo), math.log(hi)))
        else:
            v = self.rng.uniform(lo, hi)
        self.params[name] = v
        return v


TPE_STARTUP_TRIALS = 10  # pure-random warmup before density modelling
TPE_GAMMA = 0.25  # fraction of history treated as "good"
TPE_EXPLORE = 0.2  # probability of a uniform-prior draw per parameter


class TPETrial(RandomTrial):
    """Univariate TPE-style sampler over the journal history (the optuna
    fallback when the image ships no optuna; SURVEY §2.1 Hyperparam search).

    Completed trials are split at the TPE_GAMMA quantile of the objective;
    each parameter is drawn to favour values dense under the good split:
    categoricals/ints by a smoothed good/bad count ratio, floats by a
    Parzen draw around a random good observation (log-space when the space
    is log-uniform). Conditional params use only trials where they appear.
    """

    def __init__(self, rng: random.Random, history):
        super().__init__(rng)
        done = sorted(
            (r for r in history if r["value"] != float("-inf")),
            key=lambda r: r["value"],
            reverse=True,
        )
        n_good = max(1, int(len(done) * TPE_GAMMA))
        self.good = [r["params"] for r in done[:n_good]]
        self.bad = [r["params"] for r in done[n_good:]]

    def _obs(self, split, name):
        return [p[name] for p in split if name in p]

    def suggest_categorical(self, name, choices):
        choices = list(choices)
        if self.rng.random() < TPE_EXPLORE:
            return super().suggest_categorical(name, choices)
        good, bad = self._obs(self.good, name), self._obs(self.bad, name)
        if not good:
            return super().suggest_categorical(name, choices)
        weights = [
            (good.count(c) + 1.0) / (bad.count(c) + 1.0) for c in choices
        ]
        v = self.rng.choices(choices, weights=weights, k=1)[0]
        self.params[name] = v
        return v

    def suggest_int(self, name, lo, hi):
        if hi - lo + 1 <= 64:
            return int(self.suggest_categorical(name, range(lo, hi + 1)))
        v = int(round(self.suggest_float(name, lo, hi)))
        v = min(max(v, lo), hi)
        self.params[name] = v
        return v

    def suggest_float(self, name, lo, hi, log=False):
        if self.rng.random() < TPE_EXPLORE:
            return super().suggest_float(name, lo, hi, log=log)
        good = [v for v in self._obs(self.good, name) if lo <= v <= hi]
        if not good:
            return super().suggest_float(name, lo, hi, log=log)
        xform = math.log if log else (lambda x: x)
        inv = math.exp if log else (lambda x: x)
        center = xform(self.rng.choice(good))
        bw = (xform(hi) - xform(lo)) / math.sqrt(len(good) + 1.0)
        v = inv(min(max(self.rng.gauss(center, bw), xform(lo)), xform(hi)))
        v = min(max(v, lo), hi)  # exp(log(lo)) can round 1 ulp below lo
        self.params[name] = v
        return v


def search_result_slug(args) -> str:
    return (
        f"{args.model}_{args.dataset}_{args.cold_object}_bb_{args.backbone}_cs"
    )


def _save_best(args, best_params, best_value, param_dir="./param"):
    """Refresh ``./param/<slug>.pkl`` with the best completed trial's params.

    Payload is the BARE params dict — byte-compatible with the reference's
    ``pickle.dump(study.best_params)`` contract (param_search.py:29-37), so
    pkl files interchange between the frameworks; the objective value goes
    in a sidecar ``<slug>.value.json`` instead (param/view_best.py shows it
    when present).
    """
    os.makedirs(param_dir, exist_ok=True)
    path = os.path.join(param_dir, f"{search_result_slug(args)}.pkl")
    with open(path, "wb") as f:
        pickle.dump(dict(best_params), f)
    with open(path[:-4] + ".value.json", "w") as f:
        json.dump({"best_value": best_value}, f)
    return path


def run_trial(args) -> float:
    """One full train+eval; returns overall-test NDCG@topN[0]. The trainer
    and its tables are dropped before it returns."""
    set_seed(args.seed)
    config = Config(args)
    model = model_factory(config)
    model.run()
    value = float(model.overall_test_results[0][3])
    del model, config
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return value


def _timed_trial(t: int, args) -> float:
    """``run_trial`` with its seconds, ``fused_sweep`` launches and the
    card's allocated bytes after it and at its peak recorded in
    ``TRIAL_STATS`` and printed."""
    device = torch.device(getattr(args, "device", "cuda"))
    # without a card the trial itself raises (``resolve_device``)
    cuda = device.type == "cuda" and torch.cuda.is_available()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    launches = fused_sweep.launches + fused_sweep.launches_bf16
    start = time.perf_counter()
    try:
        return run_trial(args)
    finally:
        stats = {
            "trial": t,
            "seconds": time.perf_counter() - start,
            "fused_sweep": (fused_sweep.launches + fused_sweep.launches_bf16
                            - launches),
            "allocated": torch.cuda.memory_allocated(device) if cuda else None,
            "peak": torch.cuda.max_memory_allocated(device) if cuda else None,
        }
        TRIAL_STATS.append(stats)
        print(f"trial {t} on {device}: {stats['seconds']:.2f} s, "
              f"fused_sweep {stats['fused_sweep']} launches, allocated "
              f"{stats['allocated']} bytes after it (peak {stats['peak']})")


def random_search(args, n_trials: int, param_dir="./param") -> dict:
    """Resumable fallback search: journal in ./param/search_<slug>.jsonl.

    Pure random for the first TPE_STARTUP_TRIALS completed trials, then the
    univariate TPE-lite sampler over the journal history."""
    os.makedirs(param_dir, exist_ok=True)
    journal = os.path.join(param_dir, f"search_{search_result_slug(args)}.jsonl")
    done = []
    if os.path.exists(journal):
        with open(journal) as f:
            done = [json.loads(line) for line in f if line.strip()]
    best = max(done, key=lambda r: r["value"], default=None)
    start = len(done)
    for t in range(start, n_trials):
        # stable digest, NOT hash(): python string hashing is salted per
        # process, which would make searches irreproducible across runs
        digest = hashlib.sha256(
            f"{search_result_slug(args)}:{t}".encode()
        ).digest()
        rng = random.Random(int.from_bytes(digest[:8], "little"))
        finished = [r for r in done if r["value"] != float("-inf")]
        if len(finished) >= TPE_STARTUP_TRIALS:
            trial = TPETrial(rng, done)
        else:
            trial = RandomTrial(rng)
        apply_suggestions(trial, args)
        try:
            value = _timed_trial(t, args)
        except FATAL_ERRORS:
            raise  # a CUDA error: the card cannot be trusted for the rest
        except Exception as exc:  # failed trial: journal and continue
            print(f"trial {t} failed: {exc}")
            value = float("-inf")
        rec = {"trial": t, "params": trial.params, "value": value}
        done.append(rec)  # in-memory history feeds the TPE sampler
        with open(journal, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if value != float("-inf") and (best is None or value > best["value"]):
            best = rec
            _save_best(args, rec["params"], value, param_dir)
        print(f"trial {t}: value={value:.5f} best={best['value'] if best else None}")
    return best


def optuna_search(args, n_trials: int, param_dir="./param"):
    import optuna

    study = optuna.create_study(
        study_name=search_result_slug(args),
        storage="sqlite:///optuna.db",
        direction="maximize",
        load_if_exists=True,
    )

    def objective(trial):
        apply_suggestions(trial, args)
        return run_trial(args)

    def save_cb(study, trial):
        if trial.state == optuna.trial.TrialState.COMPLETE:
            _save_best(args, study.best_params, study.best_value, param_dir)

    study.optimize(objective, n_trials=n_trials, callbacks=[save_cb])
    return {"params": study.best_params, "value": study.best_value}


def main(argv=None):
    import argparse as _ap

    pre = _ap.ArgumentParser(add_help=False)
    pre.add_argument("--n_trials", type=int, default=30)
    pre_args, rest = pre.parse_known_args(argv)
    args = make_args(rest)
    resolve_device(args.device)  # no card: stop here, not trial by trial
    try:
        import optuna  # noqa: F401

        best = optuna_search(args, pre_args.n_trials)
    except ImportError:
        print("optuna not available; using built-in resumable random search")
        best = random_search(args, pre_args.n_trials)
    print("best:", best)


if __name__ == "__main__":
    main()
