"""USIM through the port's CLI on the CPU: the JAX CLI's (``main.py``'s)
result schema and bus keys on an item-cold split after MF, JAX's refusal
of user cold start, the Xavier fallback with no backbone on the bus, the
module importing with JAX blocked, and ``chip_smoke.py``'s phase usim
rehearsed at a tiny size in a process where JAX and the JAX package are
blocked.
"""
import numpy as np
import pytest
import torch

from coldrec_tpu.config import default_args as jargs
from coldrec_tpu.data.synthetic import synthetic_dataset as jsynth
from coldrec_tpu.models import model_factory as jfactory
from coldrec_tpu.runtime.trainer import Config as JConfig
from coldrec_tpu_torch.config import default_args
from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from coldrec_tpu_torch.models import model_factory
from coldrec_tpu_torch.runtime.checkpoints import load_embeddings
from coldrec_tpu_torch.runtime.trainer import Config
from test_torch_content_cli import _cli, split_dir  # noqa: F401  (fixture)
from test_torch_imports import _run_blocked
from test_torch_recon_cli import _key_paths
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

SMALL = ("--usim_max_time", "3", "--usim_k", "4", "--usim_content_hidden",
         "16")
KW = dict(n_users=60, n_items=80, n_inter=1200, content_dim=12, seed=31)


def test_cli_writes_the_jax_schema(split_dir, tmp_path):
    """USIM after MF: the port's CLI writes ``main.py``'s result schema (the
    same headers and JSON keys, plus ``device``) and the same bus keys,
    finite, of the same shapes."""
    (jh, jp), (th, tp) = _cli(split_dir, "USIM", tmp_path, SMALL)
    assert th == jh
    assert _key_paths(tp) - _key_paths(jp) == {("hyperparameters",
                                                "device")}
    assert _key_paths(jp) - _key_paths(tp) == set()
    assert tp["method"] == "USIM"
    assert tp["hyperparameters"]["usim_max_time"] == 3
    assert np.isfinite(tp["metrics"]["20"]["cold"]["NDCG"]["mean"])
    bus = load_embeddings(str(split_dir / "emb"), "synthds", "item", "USIM")
    jbus = load_embeddings(str(split_dir / "jemb"), "synthds", "item",
                           "USIM")
    assert set(bus) == set(jbus) == {"user_emb", "item_emb"}
    for k, v in bus.items():
        assert v.shape == jbus[k].shape and np.isfinite(v).all(), k
    # the frozen backbone's user table, and its warm item rows, pass
    # through
    mf = load_embeddings(str(split_dir / "emb"), "synthds", "item", "MF")
    np.testing.assert_array_equal(bus["user_emb"], mf["user_emb"])


def test_user_cold_raises_as_in_jax(tmp_path):
    """Item cold start only, with the JAX package's error."""
    flags = dict(model="USIM", dataset="synth", cold_object="user",
                 emb_dir=str(tmp_path), emb_size=8, bs=16)
    jd = jsynth(cold_object="user", **KW)[0]
    td = synthetic_dataset(cold_object="user", **KW)[0]
    with pytest.raises(ValueError) as jerr:
        jfactory(JConfig(jargs(**flags), jd))
    with pytest.raises(ValueError) as terr:
        model_factory(Config(default_args(**flags, device="cpu"), td))
    assert str(terr.value) == str(jerr.value)
    assert "item cold-start" in str(terr.value)


def test_xavier_fallback_without_a_bus(tmp_path, capsys):
    """No backbone on the bus: Xavier-uniform tables drawn from the seed,
    the same on every build, and the run trains and tests on them."""
    td = synthetic_dataset(cold_object="item", **KW)[0]
    args = default_args(model="USIM", dataset="synth", emb_dir=str(
        tmp_path / "empty"), emb_size=8, bs=16, epochs=1, seed=3,
        save_emb=False, usim_max_time=2, usim_k=3, device="cpu")
    tm = model_factory(Config(args, td))
    assert "Xavier init fallback" in capsys.readouterr().out
    limit = np.sqrt(6.0 / (td.user_num + 8))
    user = tm.model.user_table.numpy()
    assert user.shape == (td.user_num, 8)
    assert np.abs(user).max() <= limit and np.abs(user).max() > limit / 2
    again = model_factory(Config(args, td))
    assert torch.equal(again.model.user_table, tm.model.user_table)
    assert torch.equal(again.model.item_table, tm.model.item_table)
    tm.run()
    assert tm.epochs_ran == 1 and np.isfinite(tm.item_emb.numpy()).all()


def test_usim_imports_without_jax(tmp_path):
    code = (
        "import coldrec_tpu_torch.models.usim as u\n"
        "from coldrec_tpu_torch.models import TRAINERS\n"
        "from coldrec_tpu_torch.config.model_params import require_ported\n"
        "assert TRAINERS['USIM'] is u.USIMTrainer\n"
        "require_ported('USIM')\n"
        "print('USIM IMPORTS OK')\n")
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "USIM IMPORTS OK" in proc.stdout


def test_chip_smoke_usim_phase_rehearses_on_cpu_without_jax(tmp_path):
    """Phase usim at a tiny size on the CPU, with jax and coldrec_tpu
    blocked and the checks' CPU sides on the worker thread: phase train's
    split and MF bus (its MF steps checked on the worker), USIM through the
    CLI on them, checked, its epoch split logged, and the step device
    against CPU, joined; then one batch step split into its phases beside
    their bounds."""
    code = (
        "import tempfile\n"
        "import chip_smoke as cs\n"
        "for m in ('jax', 'coldrec_tpu'):\n"
        "    assert sys.modules[m] is None\n"
        "cs.CHECKS.start(worker_threads=1, main_threads=1)\n"
        "flags = {'usim_max_time': 3, 'usim_k': 4,\n"
        "         'usim_content_hidden': 16}\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    cs.train_run('cpu', 300, 2000, 8000, d=16, bs=256, root=root,\n"
        "                 content_dim=12)\n"
        "    launches, tm = cs.usim_run('cpu', root, d=16, bs=256,\n"
        "                               check_bs=64, n_infer=64,\n"
        "                               usim_flags=flags)\n"
        "cs.CHECKS.join()\n"
        "split = cs.usim_step_split(tm)\n"
        "assert launches['fused_sweep'] == 0, launches\n"
        "assert split['step']['ms'] > 0 and split['step']['bound_ms'] > 0\n"
        "assert set(split) >= {'hoisted top-ks', 'rollouts', 'ppo targets',\n"
        "                      'ppo 5', 'termination', 'inference chunk'}\n"
        "print('USIM OK')\n"
    )
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "USIM OK" in proc.stdout
    for line in ("os.cpu_count()", "USIM (item cold): 1 epoch(s)",
                 "USIM epoch 1: ", "inference of", "USIM step split at bs",
                 "    ppo 3: ", "20 steps cpu vs cpu",
                 "one batch step of 64 items", "rollout actions equal",
                 "actions equal", "id-equal to the plain path all",
                 "checks joined: "):
        assert line in proc.stdout, line
