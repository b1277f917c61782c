"""The port's search driver (``coldrec_tpu_torch/param_search.py``,
``coldrec_tpu_torch/param/view_best.py``) against the JAX driver (the root
``param_search.py`` and ``param/view_best.py``), on the CPU.

Held byte for byte: for each of the 26 models, 14 trials (past
``TPE_STARTUP_TRIALS``) with ``run_trial`` replaced in both modules by one
deterministic objective of the suggested fields (a tenth of the trials
fail with ``ValueError``) give the same journal, ``.pkl`` and sidecar, and
the same suggested fields of ``args`` at every trial; a journal the JAX
driver wrote continues, in the port, the JAX driver's own sequence;
``view_best`` prints the JAX script's text. Also: one real MF trial on a
tiny split equals the port's CLI with those params; ordinary failures and
out-of-memory are journaled as ``-Infinity``, CUDA errors end the search
with a non-zero exit and no journal line; a stub ``optuna`` sees the JAX
driver's study name, storage and direction.
"""
import hashlib
import json
import math
import os
import pickle
import random
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import param_search as jps
from coldrec_tpu.config import make_args as jmake_args
from coldrec_tpu_torch import main as tmain
from coldrec_tpu_torch import param_search as tps
from coldrec_tpu_torch.config import make_args
from coldrec_tpu_torch.data.split import cold_start_split, write_split_dir
from coldrec_tpu_torch.data.synthetic import synthetic_interactions
from coldrec_tpu_torch.models import TRAINERS
from coldrec_tpu_torch.ops.cuda.build import CudaLaunchError
from test_torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRIALS = 14
assert TRIALS > jps.TPE_STARTUP_TRIALS == tps.TPE_STARTUP_TRIALS
# every field of ``args`` that ``apply_suggestions`` writes, for some model
SUGGESTED = (
    "p_emb", "p_ctx", "p_proj", "eps", "lmd", "lr", "reg", "emb_size",
    "knn_num", "layers", "cl_rate", "tau", "l_cl", "hyper_layers", "alpha",
    "ssl_reg", "proto_reg", "num_clusters", "beta", "gamma", "tws",
    "freq_coef_M", "aldi_hidden", "num_neg", "temp_value", "lr_lambda",
    "num_sample", "positive_number", "negative_number", "self_neg_number",
    "lambda1", "pretrain", "pretrain_update", "n_dropout",
    "dropoutnet_hidden1", "dropoutnet_hidden2", "n_expert",
    "heater_mlp_hidden", "pre_cluster_num", "uni_coeff", "kl_coeff",
    "dropout", "agnn_knn_k", "agnn_dropout", "agnn_rank_weight",
    "agnn_align_weight", "agnn_vae_lambda", "agnn_finetune",
    "agnn_no_backbone", "m2vae_weight_decay", "m2vae_kld_weight",
    "m2vae_recon_weight", "m2vae_decouple_weight", "cgrc_mask_rho",
    "cgrc_recon_topk", "cgrc_layers_gprime", "cgrc_lambda_e", "cgrc_tau",
    "fsgnn_lambda_fc", "fsgnn_mu_sc", "fsgnn_p_drop", "fsgnn_knn_k",
    "fsgnn_light_layers", "actor_lr", "critic_lr", "usim_max_time", "usim_k",
)


def _fields(args) -> dict:
    return {k: getattr(args, k) for k in SUGGESTED if hasattr(args, k)}


def _objective(seen, fail=True):
    """A deterministic objective of the suggested fields; records them in
    ``seen``. With ``fail``, trials whose digest falls in the lowest tenth
    raise ``ValueError``."""
    def run_trial(args):
        fields = _fields(args)
        seen.append(fields)
        digest = hashlib.sha256(json.dumps(fields, sort_keys=True,
                                           default=str).encode()).digest()
        u = int.from_bytes(digest[:8], "little") / 2.0 ** 64
        if fail and u < 0.1:
            raise ValueError(f"objective refused {u}")
        return -(math.log10(args.lr) + 3) ** 2 - (math.log10(args.reg)
                                                  + 4) ** 2 + u
    return run_trial


def _argv(model, port=False):
    """The search's flags; the port's ask for the CPU (``main`` checks the
    device before the first trial)."""
    return ["--model", model, "--dataset", "search", "--cold_object",
            "item", *(("--device", "cpu") if port else ())]


def _files(param_dir) -> dict:
    return {name: open(os.path.join(param_dir, name), "rb").read()
            for name in sorted(os.listdir(param_dir))}


def _search(module, argv, n, param_dir, monkeypatch, seen=None):
    seen = [] if seen is None else seen
    monkeypatch.setattr(module, "run_trial", _objective(seen))
    maker = jmake_args if module is jps else make_args
    args = maker(argv)
    best = module.random_search(args, n, param_dir=str(param_dir))
    return best, seen


@pytest.mark.parametrize("model", sorted(TRAINERS))
def test_search_matches_jax_driver(model, tmp_path, monkeypatch):
    """14 trials: the journal, the pickle and its sidecar byte-equal to the
    JAX driver's, and the suggested fields of ``args`` equal at every
    trial (one ``args`` mutated from trial to trial in both)."""
    assert len(TRAINERS) == 26
    jbest, jseen = _search(jps, _argv(model), TRIALS, tmp_path / "jax",
                           monkeypatch)
    tbest, tseen = _search(tps, _argv(model), TRIALS, tmp_path / "port",
                           monkeypatch)
    assert tseen == jseen and len(tseen) == TRIALS
    assert tbest == jbest
    jfiles, tfiles = _files(tmp_path / "jax"), _files(tmp_path / "port")
    slug = f"{model}_search_item_bb_MF_cs"
    assert sorted(tfiles) == sorted(jfiles) == sorted(
        [f"search_{slug}.jsonl", f"{slug}.pkl", f"{slug}.value.json"])
    assert tfiles == jfiles
    lines = tfiles[f"search_{slug}.jsonl"].decode().splitlines()
    assert [json.loads(x)["trial"] for x in lines] == list(range(TRIALS))


def test_port_resumes_a_jax_journal(tmp_path, monkeypatch):
    """12 trials by the JAX driver, resumed to 16 by the port: the journal
    the JAX driver writes when it runs all 16 itself."""
    argv = _argv("SimGCL")
    _search(jps, argv, 12, tmp_path / "mixed", monkeypatch)
    first = _files(tmp_path / "mixed")
    seen = []
    _search(tps, argv, 16, tmp_path / "mixed", monkeypatch, seen)
    assert len(seen) == 4  # the 12 journaled trials were not run again
    _search(jps, argv, 16, tmp_path / "jax", monkeypatch)
    mixed = _files(tmp_path / "mixed")
    assert mixed == _files(tmp_path / "jax")
    journal = "search_SimGCL_search_item_bb_MF_cs.jsonl"
    assert mixed[journal].startswith(first[journal])


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("search_data")
    pairs = synthetic_interactions(120, 90, 2400, seed=13)
    res = cold_start_split(pairs, cold_object="item", seed=3)
    write_split_dir(res, str(root), "demo", "item")
    np.save(root / "demo" / "demo_item_content.npy",
            np.random.default_rng(1).standard_normal(
                (res.item_num, 8)).astype(np.float32))
    return str(root)


def test_real_trial_equals_the_cli(split_dir, tmp_path, monkeypatch):
    """One real MF trial (train, validate, test on the CPU) journals the
    value the port's CLI gives with the same params."""
    monkeypatch.chdir(tmp_path)
    flags = ["--model", "MF", "--dataset", "demo", "--data_dir", split_dir,
             "--epochs", "2", "--bs", "256", "--save_emb", "false",
             "--device", "cpu", "--result_file", str(tmp_path / "r.txt")]
    tps.main(["--n_trials", "1", *flags])
    slug = "MF_demo_item_bb_MF_cs"
    rec = json.loads(open(f"param/search_{slug}.jsonl").read())
    with open(f"param/{slug}.pkl", "rb") as f:
        assert pickle.load(f) == rec["params"]
    stats = tps.TRIAL_STATS[-1]
    # on the CPU the sweeps run the kernel's plain version: no launch
    assert stats["trial"] == 0 and stats["allocated"] is None
    assert stats["fused_sweep"] == 0 and stats["seconds"] > 0
    params = rec["params"]
    payload = tmain.run(make_args([
        *flags, "--lr", repr(params["lr"]), "--reg", repr(params["reg"]),
        "--emb_size", "64"]))
    topn = str(make_args(flags).topN).split(",")[0]
    assert payload["metrics"][topn]["all"]["NDCG"]["mean"] == rec["value"]


@pytest.mark.parametrize("exc", [ValueError("bad flag"),
                                 torch.cuda.OutOfMemoryError("oom")])
def test_failed_trial_is_journaled(exc, tmp_path, monkeypatch):
    def fail(args):
        raise exc

    monkeypatch.setattr(tps, "run_trial", fail)
    best = tps.random_search(make_args(_argv("MF")), 2, str(tmp_path))
    assert best is None
    lines = open(tmp_path / "search_MF_search_item_bb_MF_cs.jsonl").read()
    assert [json.loads(x)["value"] for x in lines.splitlines()] == [
        float("-inf")] * 2
    assert "-Infinity" in lines


@pytest.mark.parametrize("exc", [
    CudaLaunchError("coldrec_fused_sweep launch failed: CUDA error 700 "
                    "(an illegal memory access was encountered)"),
    torch.AcceleratorError("CUDA error: an illegal memory access")])
def test_cuda_error_ends_the_search(exc, tmp_path, monkeypatch):
    def fail(args):
        raise exc

    monkeypatch.setattr(tps, "run_trial", fail)
    with pytest.raises(type(exc)):
        tps.random_search(make_args(_argv("MF")), 3, str(tmp_path))
    assert not (tmp_path / "search_MF_search_item_bb_MF_cs.jsonl").exists()


def test_search_without_the_card_stops_before_a_trial(tmp_path,
                                                     monkeypatch):
    """The default device is the card: without one, ``main`` raises before
    the first trial instead of journaling every trial as failed."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tps, "run_trial", _objective([]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tps.main(["--n_trials", "2", *_argv("MF")])
    assert not (tmp_path / "param").exists()


def test_cuda_error_exits_non_zero(tmp_path):
    """The module's entry with the binding's CUDA error in the first trial:
    a non-zero exit, the error named, nothing journaled."""
    code = (
        "import sys\n"
        "from coldrec_tpu_torch import param_search as ps\n"
        "from coldrec_tpu_torch.ops.cuda.build import CudaLaunchError\n"
        "def fail(args):\n"
        "    raise CudaLaunchError('coldrec_fused_sweep launch failed: CUDA "
        "error 700')\n"
        "ps.run_trial = fail\n"
        "ps.main(sys.argv[1:])\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--n_trials", "3", *_argv("MF", True)],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CudaLaunchError" in proc.stderr
    assert not (tmp_path / "param" /
                "search_MF_search_item_bb_MF_cs.jsonl").exists()


def _write_best(param_dir, payload, sidecar):
    os.makedirs(param_dir, exist_ok=True)
    path = os.path.join(param_dir, "DropoutNet_bx_item_bb_LightGCN_cs.pkl")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    if sidecar is not None:
        with open(path[:-4] + ".value.json", "w") as f:
            json.dump({"best_value": sidecar}, f)


@pytest.mark.parametrize("payload,sidecar", [
    ({"lr": 0.001, "reg": 5e-4, "n_dropout": 0.5}, 0.1234567890123),
    ({"lr": 0.01, "dropoutnet_hidden1": 300}, None),
    ({"best_params": {"lr": 1e-4, "reg": 1e-5}, "best_value": 0.25}, 0.5),
], ids=["bare_sidecar", "bare", "wrapped"])
def test_view_best_prints_the_jax_text(payload, sidecar, tmp_path):
    _write_best(str(tmp_path / "param"), payload, sidecar)
    flags = ["--model", "DropoutNet", "--dataset", "bx", "--backbone",
             "LightGCN"]
    env = {**os.environ, "PYTHONPATH": REPO}
    outs = [subprocess.run(cmd + flags, cwd=tmp_path, env=env,
                           capture_output=True, timeout=120)
            for cmd in ([sys.executable, os.path.join(REPO, "param",
                                                      "view_best.py")],
                        [sys.executable, "-m",
                         "coldrec_tpu_torch.param.view_best"])]
    assert [o.returncode for o in outs] == [0, 0]
    assert outs[1].stdout == outs[0].stdout
    assert b"Best params from ./param/DropoutNet_bx_item_bb_LightGCN" \
        in outs[1].stdout


class _StubTrial:
    def __init__(self, number):
        self.number = number
        self.state = "COMPLETE"
        self.params = {}
        self.rng = random.Random(number)

    def suggest_categorical(self, name, choices):
        self.params[name] = self.rng.choice(list(choices))
        return self.params[name]

    def suggest_int(self, name, lo, hi):
        self.params[name] = self.rng.randint(lo, hi)
        return self.params[name]

    def suggest_float(self, name, lo, hi, log=False):
        self.params[name] = self.rng.uniform(lo, hi)
        return self.params[name]


def _stub_optuna(calls):
    """An ``optuna`` module that records ``create_study``'s arguments and
    runs the objective on seeded stub trials."""
    mod = types.ModuleType("optuna")
    mod.trial = types.SimpleNamespace(
        TrialState=types.SimpleNamespace(COMPLETE="COMPLETE"))

    class Study:
        best_params, best_value = None, None

        def optimize(self, objective, n_trials, callbacks=()):
            calls.append(("optimize", n_trials))
            for t in range(n_trials):
                trial = _StubTrial(t)
                value = objective(trial)
                if self.best_value is None or value > self.best_value:
                    self.best_params, self.best_value = trial.params, value
                for cb in callbacks:
                    cb(self, trial)

    def create_study(**kw):
        calls.append(("create_study", kw))
        return Study()

    mod.create_study = create_study
    return mod


def test_optuna_branch_as_jax(tmp_path, monkeypatch):
    """With ``optuna`` importable, ``main`` takes the optuna branch: the
    study's name, storage, direction and resume flag and the saved best
    are the JAX driver's."""
    out = {}
    for name, module in (("jax", jps), ("port", tps)):
        calls = []
        monkeypatch.setitem(sys.modules, "optuna", _stub_optuna(calls))
        # optuna's own failed trials are optuna's: none here
        monkeypatch.setattr(module, "run_trial", _objective([], fail=False))
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        module.main(["--n_trials", "3", *_argv("LightGCN", tps is module)])
        out[name] = (calls, _files("param"))
    assert out["port"] == out["jax"]
    calls = out["port"][0]
    assert calls[0] == ("create_study", {
        "study_name": "LightGCN_search_item_bb_MF_cs",
        "storage": "sqlite:///optuna.db", "direction": "maximize",
        "load_if_exists": True})
    assert calls[1] == ("optimize", 3)
