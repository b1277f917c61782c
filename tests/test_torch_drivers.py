"""The port's CLI flags on the CPU: ``--fused_steps K`` against the
per-batch loop and against the JAX package's fused MF, its eligibility
(the JAX package's ``_fused_ok``), ragged batches, and ``--debug_nans`` on
an injected NaN weight row in both CLIs.

``--fused_steps`` changes only how the steps are enqueued: the same
batches in the same order, the same draws. On the CPU the fused and the
per-batch tables are bit-equal; they are held to ``tests/test_fused_steps.py``'s
tolerances (rtol 1e-5, atol 1e-6). The port's fused MF against JAX's
fused MF from the same initial tables: the fp32 tolerance of
``test_torch_train.py`` (1e-6 on the tables).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main as jmain
from coldrec_tpu.config import default_args as jargs
from coldrec_tpu.config import make_args as jmake_args
from coldrec_tpu.data.synthetic import synthetic_dataset as jsynth
from coldrec_tpu.models import mf as jmf
from coldrec_tpu.models import model_factory as jfactory
from coldrec_tpu.runtime.trainer import Config as JConfig
from coldrec_tpu_torch import main as tmain
from coldrec_tpu_torch.config import default_args, make_args
from coldrec_tpu_torch.data.sampler import pairwise_batches
from coldrec_tpu_torch.data.split import cold_start_split, write_split_dir
from coldrec_tpu_torch.data.synthetic import (
    synthetic_dataset, synthetic_interactions,
)
from coldrec_tpu_torch.models import mf as tmf
from coldrec_tpu_torch.models import model_factory
from coldrec_tpu_torch.models.mf import MFTrainer
from coldrec_tpu_torch.runtime.trainer import Config
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

KW = dict(n_users=80, n_items=100, n_inter=2600, cold_object="item", seed=9)
COMMON = dict(dataset="synth", epochs=3, bs=200, emb_size=16, early_stop=5,
              seed=11, save_emb=False)
RTOL, ATOL = 1e-5, 1e-6  # tests/test_fused_steps.py
TABLE_ATOL = 1e-6  # test_torch_train.py


@pytest.fixture(scope="module")
def datasets():
    return jsynth(**KW)[0], synthetic_dataset(**KW)[0]


def _port(td, model="MF", **kw):
    args = default_args(**{**COMMON, "model": model, "device": "cpu", **kw})
    return model_factory(Config(args, td))


def _assert_same_run(base, fused):
    for a, b in ((base.user_emb, fused.user_emb),
                 (base.item_emb, fused.item_emb)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL,
                                   atol=ATOL)
    assert base.overall_test_results == fused.overall_test_results
    assert base.cold_test_results == fused.cold_test_results
    assert base.warm_test_results == fused.warm_test_results
    assert [s["losses"] for s in base.epoch_stats] == [
        s["losses"] for s in fused.epoch_stats]


@pytest.mark.parametrize("model", ["MF", "XSimGCL"])
@pytest.mark.parametrize("k", [3, 999])
def test_fused_matches_per_batch(datasets, model, k):
    """K=3 leaves a tail (the epoch's batches are no multiple of 3); K=999
    puts the whole epoch in the tail."""
    _, td = datasets
    base = _port(td, model)
    base.run()
    fused = _port(td, model, fused_steps=k)
    assert fused._use_fused() == k
    fused.run()
    n = base.epoch_stats[0]["batches"]
    assert n % 3 and n < 999  # a tail under K=3, all tail under K=999
    _assert_same_run(base, fused)


def test_fused_mf_matches_jax_fused_mf(datasets):
    """Both packages fused (K=3) from the JAX package's initial tables."""
    jd, td = datasets
    jm = jfactory(JConfig(jargs(model="MF", fused_steps=3, **COMMON), jd))
    init = {k: np.asarray(v) for k, v in jm.params.items()}
    assert jm._use_fused() == 3
    jm.run()
    tm = MFTrainer(Config(default_args(model="MF", fused_steps=3,
                                       device="cpu", **COMMON), td),
                   init_params=init)
    assert tm._use_fused() == 3
    tm.run()
    for k in ("user_emb", "item_emb"):
        np.testing.assert_allclose(
            getattr(tm.model, k).detach().numpy(), np.asarray(jm.params[k]),
            atol=TABLE_ATOL)
    for mine, ref in ((tm.overall_test_results, jm.overall_test_results),
                      (tm.cold_test_results, jm.cold_test_results),
                      (tm.warm_test_results, jm.warm_test_results)):
        np.testing.assert_allclose(mine, ref, atol=1e-6)


@pytest.fixture(scope="module")
def mf_bus(datasets, tmp_path_factory):
    _, td = datasets
    emb_dir = str(tmp_path_factory.mktemp("emb"))
    _port(td, epochs=2, emb_dir=emb_dir, save_emb=True, seed=3).run()
    return emb_dir


def test_custom_optimizer_models_ignore_fused_flag(datasets, mf_bus):
    """VBPR (Adagrad on the tables, Adam on W) keeps the per-batch loop
    under --fused_steps, as in the JAX package, and its run completes."""
    _, td = datasets
    m = _port(td, "VBPR", epochs=1, emb_dir=mf_bus, seed=5, fused_steps=8)
    assert m._use_fused() == 0
    m.run()
    assert m.overall_test_results is not None


@pytest.mark.parametrize("model", ["GAR", "DropoutNet", "VBPR", "MTPR"])
def test_fused_eligibility_matches_jax(datasets, mf_bus, model):
    """The default step fuses (GAR); BatchNorm state (DropoutNet) and the
    custom optimizers (VBPR, MTPR) keep the per-batch loop in both
    packages."""
    jd, td = datasets
    kw = dict(model=model, epochs=1, emb_dir=mf_bus, fused_steps=8)
    jm = jfactory(JConfig(jargs(**{**COMMON, **kw}), jd))
    tm = _port(td, **kw)
    assert tm._use_fused() == jm._use_fused() == (8 if model == "GAR"
                                                   else 0)


def _ragged(batches):
    """The batches with the padding of the last one cut off."""
    batches = list(batches)
    n = int(batches[-1]["weight"].sum())
    batches[-1] = {k: v[:n] for k, v in batches[-1].items()}
    return iter(batches)


def test_fused_runs_a_ragged_batch_alone(datasets):
    """A batch whose shapes differ from its group's runs alone, after the
    group's batches, each alone; an epoch ending in a short batch equals
    the per-batch loop."""
    _, td = datasets
    tm = _port(td, fused_steps=3)
    sizes = [4, 4, 4, 4, 3, 4, 4]
    tm.batches = lambda: iter([{"user": np.zeros(s, np.int32)}
                               for s in sizes])
    secs = {"host_s": 0.0}
    groups = list(tm._groups(3, secs))
    assert [[b["user"].shape[0] for b in g] for g in groups] == [
        [4, 4, 4], [4], [3], [4], [4]]
    assert secs["host_s"] >= 0
    runs = []
    for k in (0, 4):  # 7 batches: a group of 4, then 2 cut short by the last
        tm = _port(td, fused_steps=k)
        tm.batches = lambda tm=tm: _ragged(pairwise_batches(
            tm.data, tm.batch_size, tm.host_rng))
        tm.run()
        runs.append(tm)
    assert runs[0].epoch_stats[0]["batches"] == 7
    _assert_same_run(*runs)


@pytest.mark.parametrize("anomaly,fused", [(True, 0), (False, 0), (False, 3)])
def test_debug_nans_names_the_epoch_and_batch(datasets, anomaly, fused):
    """A NaN user table after set-up: anomaly mode's NaN in the backward,
    or else the loss check, raises FloatingPointError at the first
    batch."""
    _, td = datasets
    tm = _port(td, debug_nans=True, fused_steps=fused)
    with torch.no_grad():
        tm.model.user_emb.fill_(float("nan"))
    match = ("NaN in the backward of epoch 1 batch 0" if anomaly
             else "loss nan at epoch 1 batch 0")
    with torch.autograd.set_detect_anomaly(anomaly):
        with pytest.raises(FloatingPointError, match=match):
            tm.train()


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    pairs = synthetic_interactions(90, 110, 2200, seed=41)
    res = cold_start_split(pairs, cold_object="item", seed=42)
    write_split_dir(res, str(root), "synthds", "item")
    np.save(root / "synthds" / "synthds_item_content.npy",
            np.random.default_rng(0).standard_normal(
                (res.item_num, 8)).astype(np.float32))
    return str(root)


def _flags(split_dir, tmp_path):
    return ["--model", "MF", "--dataset", "synthds", "--cold_object", "item",
            "--data_dir", split_dir, "--epochs", "1", "--bs", "256",
            "--emb_size", "8", "--emb_dir", str(tmp_path / "emb"),
            "--result_file", str(tmp_path / "result.txt")]


def _nan_row(monkeypatch):
    """Row 0 of every xavier table MF draws is NaN, in both packages."""
    port, jax_init = tmf.xavier_uniform, jmf.xavier_uniform

    def port_nan(*args, **kw):
        t = port(*args, **kw)
        t[0] = float("nan")
        return t

    def jax_nan(*args, **kw):
        return jax_init(*args, **kw).at[0].set(jnp.nan)

    monkeypatch.setattr(tmf, "xavier_uniform", port_nan)
    monkeypatch.setattr(jmf, "xavier_uniform", jax_nan)


@pytest.mark.parametrize("cli", ["port", "jax"])
def test_debug_nans_raises_on_a_nan_weight_row(split_dir, tmp_path,
                                               monkeypatch, cli):
    """With an injected NaN weight row, ``--debug_nans`` raises
    FloatingPointError in both CLIs; the port's run without the flag
    completes. The JAX CLI sets ``jax_debug_nans`` for the process: it is
    restored here, since other tests share the worker."""
    _nan_row(monkeypatch)
    flags = _flags(split_dir, tmp_path) + ["--debug_nans", "true"]
    if cli == "port":
        with pytest.raises(FloatingPointError, match="non-finite values"):
            tmain.run(make_args(flags + ["--device", "cpu"]))
        assert not torch.is_anomaly_enabled()
        payload = tmain.run(make_args(_flags(split_dir, tmp_path)
                                      + ["--device", "cpu"]))
        assert payload["efficiency"]["seconds_per_completed_epoch_mean"] > 0
        return
    before = jax.config.jax_debug_nans
    try:
        with pytest.raises(FloatingPointError):
            jmain.run(jmake_args(flags))
    finally:
        jax.config.update("jax_debug_nans", before)

