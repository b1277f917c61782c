"""MF training in the port against the JAX package, on the CPU.

Both trainers start from the JAX ``MF.params`` (``init_params=``) on the
same data and seed, so they see the same batch stream (bit for bit, see
test_torch_sampler.py) and differ only in float32 summation order. Over 3
epochs at this size the per-batch losses agree within ``LOSS_RTOL`` and the
tables within ``TABLE_ATOL``: the largest difference seen is 1.5e-7, and no
element needs more than 1e-6. Adam's first steps are ~lr * sign(g), so an
element whose gradient cancels to ~0 could flip sign between the two
scatter-add orders and move by up to 2 * lr; none does here.

Also: early stopping at the same epoch, resume bit for bit, the non-finite
quarantine, the best epoch's tables on the bus, the refused flags (and the
accepted ``--fused_steps``), ``--profile`` and ``--debug_nans``, and the
CLI's result file against ``main.py``'s.
"""
import json
import os

import numpy as np
import pytest
import torch

import main as jmain
from coldrec_tpu.config import default_args as jargs
from coldrec_tpu.config import make_args as jmake_args
from coldrec_tpu.data.synthetic import synthetic_dataset as jsynth
from coldrec_tpu.models import model_factory as jfactory
from coldrec_tpu.runtime.trainer import Config as JConfig
from coldrec_tpu_torch import main as tmain
from coldrec_tpu_torch.config import default_args, make_args
from coldrec_tpu_torch.data.split import cold_start_split, write_split_dir
from coldrec_tpu_torch.data.synthetic import (
    synthetic_dataset, synthetic_interactions,
)
from coldrec_tpu_torch.models import model_factory
from coldrec_tpu_torch.models.mf import MFTrainer
from coldrec_tpu_torch.runtime.checkpoints import load_embeddings
from coldrec_tpu_torch.runtime.trainer import Config
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

KW = dict(n_users=70, n_items=80, n_inter=1400, cold_object="item", seed=71)
COMMON = dict(model="MF", dataset="synth", bs=256, emb_size=16, seed=5,
              save_emb=False)
LOSS_RTOL = 1e-5
TABLE_ATOL = 1e-6
GAP_REL = 1e-5  # rows whose top scores lie this close may swap ids
SETTINGS = ("all", "cold", "warm")


@pytest.fixture(scope="module")
def datasets():
    return jsynth(**KW)[0], synthetic_dataset(**KW)[0]


def _jax_trainer(jd, **kw):
    """The JAX MF trainer, its initial tables, and its per-batch losses
    (recorded around its jitted step)."""
    jm = jfactory(JConfig(jargs(**{**COMMON, **kw}), jd))
    init = {k: np.asarray(v) for k, v in jm.params.items()}
    losses, step = [], jm._step

    def recording(params, opt_state, batch):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
        return params, opt_state, loss

    jm._step = recording
    return jm, init, losses


def _port(td, init=None, **kw):
    args = default_args(**{**COMMON, "device": "cpu", **kw})
    return MFTrainer(Config(args, td), init_params=init)


def _losses(tm):
    return [x for s in tm.epoch_stats for x in s["losses"]]


def _assert_lists_agree(ue, ie, a, b, users):
    """Id-equal rows, except rows whose top scores lie within GAP_REL."""
    bad = np.flatnonzero((a != b).any(axis=1))
    for r in bad:
        u = ue[users[r]]
        sa, sb = ie[a[r]] @ u, ie[b[r]] @ u
        scale = max(np.abs(sa).max(), np.abs(sb).max())
        np.testing.assert_allclose(sa, sb, atol=GAP_REL * scale)


def test_three_epochs_match_jax(datasets):
    jd, td = datasets
    jm, init, jlosses = _jax_trainer(jd, epochs=3)
    jm.run()
    tm = _port(td, init, epochs=3)
    tm.run()
    tl = _losses(tm)
    assert len(tl) == len(jlosses) == 3 * tm.epoch_stats[0]["batches"]
    np.testing.assert_allclose(tl, jlosses, rtol=LOSS_RTOL)
    for k in ("user_emb", "item_emb"):
        np.testing.assert_allclose(
            getattr(tm.model, k).detach().numpy(), np.asarray(jm.params[k]),
            atol=TABLE_ATOL)
        np.testing.assert_allclose(
            getattr(tm, k).numpy(), np.asarray(getattr(jm, k)),
            atol=TABLE_ATOL)
    assert tm.best_performance[0] == jm.best_performance[0]
    assert tm.epochs_ran == jm.epochs_ran == 3
    for k, v in jm.best_performance[1].items():
        assert abs(tm.best_performance[1][k] - v) <= 1e-6, k
    ue, ie = np.asarray(jm.user_emb), np.asarray(jm.item_emb)
    for setting in SETTINGS:
        for phase, split in (("valid", "val"), ("test", "test")):
            name = {"all": "overall", "cold": "cold", "warm": "warm"}[setting]
            users = td.eval_splits[f"{name}_{split}"].users
            a = getattr(tm, phase)(setting)
            b = getattr(jm, phase)(setting)
            _assert_lists_agree(ue, ie, a, b, users)
    for mine, ref in ((tm.overall_test_results, jm.overall_test_results),
                      (tm.cold_test_results, jm.cold_test_results),
                      (tm.warm_test_results, jm.warm_test_results)):
        np.testing.assert_allclose(mine, ref, atol=1e-6)


def test_early_stop_at_the_same_epoch_as_jax(datasets):
    jd, td = datasets
    jm, init, _ = _jax_trainer(jd, epochs=12, early_stop=1)
    jm.run()
    tm = _port(td, init, epochs=12, early_stop=1)
    tm.run()
    assert jm.epochs_ran < 12  # the stop fired
    assert tm.epochs_ran == jm.epochs_ran
    assert tm.best_performance[0] == jm.best_performance[0]
    assert tm.early_stop_patience == jm.early_stop_patience == 0


def _tables(tm):
    return (tm.model.user_emb.detach().clone(),
            tm.model.item_emb.detach().clone())


def test_resume_is_bit_exact(datasets, tmp_path):
    _, td = datasets
    full = _port(td, epochs=4)
    full.run()
    ckpt = str(tmp_path / "state.ckpt")
    first = _port(td, epochs=2, state_ckpt=ckpt)
    first.run()
    second = _port(td, epochs=4, state_ckpt=ckpt)
    second.run()
    assert [s["epoch"] for s in second.epoch_stats] == [3, 4]
    for a, b in zip(_tables(second), _tables(full)):
        assert torch.equal(a, b)
    assert torch.equal(second.user_emb, full.user_emb)
    assert second.best_performance == full.best_performance
    assert _losses(second) == _losses(full)[-len(_losses(second)):]
    assert second.overall_test_results == full.overall_test_results
    assert second.cold_test_results == full.cold_test_results


def test_resume_of_a_finished_run_trains_no_more(datasets, tmp_path):
    _, td = datasets
    ckpt = str(tmp_path / "state.ckpt")
    done = _port(td, epochs=3, state_ckpt=ckpt)
    done.run()
    again = _port(td, epochs=3, state_ckpt=ckpt)
    again.run()
    assert again.epoch_stats == [] and again.epochs_ran == 3
    for a, b in zip(_tables(again), _tables(done)):
        assert torch.equal(a, b)
    assert torch.equal(again.user_emb, done.user_emb)


def _scripted_ndcg(monkeypatch, trainer, ndcgs):
    """Make validation epoch e report NDCG ``ndcgs[e]`` (other metrics as
    computed)."""
    orig = trainer._evaluate_split
    calls = iter(ndcgs)

    def scripted(phase, data_type, rec, topN):
        measure, perf = orig(phase, data_type, rec, topN)
        if phase == "valid":
            perf = [row[:3] + [next(calls)] for row in perf]
        return measure, perf

    monkeypatch.setattr(trainer, "_evaluate_split", scripted)


def test_non_finite_epoch_consumes_patience_and_keeps_best(
        datasets, tmp_path, monkeypatch):
    """NDCG 0.2, NaN, 0.1: the NaN epoch never becomes best and costs one
    patience, as in the JAX package; the best (epoch 1) tables stay."""
    jd, td = datasets
    ndcgs = [0.2, float("nan"), 0.1]
    jm, init, _ = _jax_trainer(jd, epochs=3, early_stop=2)
    _scripted_ndcg(monkeypatch, jm, ndcgs)
    jm.train()
    tm = _port(td, init, epochs=3, early_stop=2)
    _scripted_ndcg(monkeypatch, tm, ndcgs)
    tm.train()
    assert tm.early_stop_patience == jm.early_stop_patience == 0
    assert tm.best_performance[0] == jm.best_performance[0] == 1
    assert tm.epochs_ran == jm.epochs_ran == 3
    one = _port(td, init, epochs=1)
    one.train()
    assert torch.equal(tm.user_emb, one.model.user_emb.detach())
    assert not torch.equal(tm.user_emb, tm.model.user_emb.detach())


def test_bus_holds_the_best_epochs_tables(datasets, tmp_path, monkeypatch):
    """Trained past its best epoch (2 of 4), the run writes epoch 2's tables,
    not the last ones: the best tables are copies, not views of the
    parameters that Adam updates in place."""
    _, td = datasets
    emb_dir = str(tmp_path / "emb")
    tm = _port(td, epochs=4, save_emb=True, emb_dir=emb_dir)
    _scripted_ndcg(monkeypatch, tm, [0.1, 0.3, 0.2, 0.25])
    tm.train()
    assert tm.best_performance[0] == 2 and tm.epochs_ran == 4
    bus = load_embeddings(emb_dir, "synth", "item", "MF")
    two = _port(td, epochs=2)
    two.train()
    np.testing.assert_array_equal(bus["user_emb"],
                                  two.model.user_emb.detach().numpy())
    np.testing.assert_array_equal(bus["item_emb"],
                                  two.model.item_emb.detach().numpy())
    assert not np.array_equal(bus["user_emb"],
                              tm.model.user_emb.detach().numpy())


def test_plain_and_kernel_backends_agree(datasets):
    _, td = datasets
    kernel = _port(td, epochs=1)
    kernel.run()
    plain = _port(td, epochs=1, eval_backend="xla")
    plain.run()
    assert kernel.eval_backend == "kernel" and plain.eval_backend == "plain"
    assert plain.overall_test_results == kernel.overall_test_results
    for setting in SETTINGS:
        np.testing.assert_array_equal(plain.test(setting),
                                      kernel.test(setting))
    raw = td.id2user[:3]
    scores = kernel.batch_predict(raw)
    np.testing.assert_allclose(
        scores, (kernel.user_emb[:3] @ kernel.item_emb.T).numpy(), rtol=1e-6,
        atol=1e-7)
    np.testing.assert_allclose(kernel.predict(raw[1]), scores[1], rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("overrides,error,match", [
    # MF takes a mesh; on one rank a 2x1 mesh has too few processes
    (dict(mesh="2x1"), ValueError, "needs 2 processes, have 1"),
    (dict(fused_steps=4), None, None),  # accepted: K steps a group
    (dict(eval_backend="bf16"), ValueError, "pallas_bf16"),
    (dict(eval_backend="tpu"), ValueError, "eval_backend"),
])
def test_refused_flags(datasets, overrides, error, match):
    _, td = datasets
    if error is None:
        assert _port(td, epochs=1, **overrides)._use_fused() == 4
        return
    with pytest.raises(error, match=match):
        _port(td, epochs=1, **overrides)


@pytest.mark.parametrize("model,mesh,error", [
    ("NGCF", "2x1", NotImplementedError),  # not on the data axis yet
    ("KNN", "1x2", NotImplementedError),
    ("MTPR", "2x1", None),  # JAX's MTPR never sets up a mesh: one device
    ("LightGCN", "1x1", None),  # a 1x1 mesh is the single-device path
])
def test_mesh_by_model(datasets, model, mesh, error):
    """``--mesh`` for the models off the data and model axes: refused with
    the ROADMAP item that brings them, or ignored as the JAX package's
    trainer ignores it."""
    _, td = datasets
    args = default_args(**{**COMMON, "device": "cpu", "epochs": 1,
                           "model": model, "mesh": mesh, "layers": 1})
    if error is not None:
        with pytest.raises(error, match="Queue 1, item 7b"):
            model_factory(Config(args, td))
        return
    trainer = model_factory(Config(args, td))
    assert trainer.mesh is None and not trainer.sharded


@pytest.mark.parametrize("model,cold_object,match", [
    ("USIM", "user", "USIM only supports item cold-start"),
    ("NotAModel", "item", "Invalid model name"),
])
def test_models_other_than_mf_raise(datasets, model, cold_object, match):
    """An unknown model name is refused by the parser and the factory;
    every model of the JAX package is ported, and USIM refuses user cold
    start with the JAX package's error."""
    _, td = datasets
    argv = ["--model", model, "--cold_object", cold_object]
    if model == "NotAModel":
        with pytest.raises(ValueError, match=match):
            make_args(argv)
    else:
        assert make_args(argv).usim_max_time == 7
    args = default_args(device="cpu", cold_object=cold_object)
    args.model = model
    with pytest.raises(ValueError, match=match):
        model_factory(Config(args, td))


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    pairs = synthetic_interactions(90, 110, 2200, seed=41)
    res = cold_start_split(pairs, cold_object="item", seed=42)
    write_split_dir(res, str(root), "synthds", "item")
    np.save(os.path.join(root, "synthds", "synthds_item_content.npy"),
            np.random.default_rng(0).standard_normal(
                (res.item_num, 8)).astype(np.float32))
    return str(root)


def _result(path):
    text = open(path).read()
    headers = [ln for ln in text.splitlines()
               if ln.startswith(("===", "---"))]
    return headers, json.loads(text.split("--- JSON (machine-readable) ---")[1])


def _key_paths(d, prefix=()):
    out = set()
    for k, v in d.items():
        out.add(prefix + (k,))
        if isinstance(v, dict):
            out |= _key_paths(v, prefix + (k,))
    return out


def test_cli_result_file_matches_main_py(split_dir, tmp_path):
    flags = ["--model", "MF", "--dataset", "synthds", "--cold_object",
             "item", "--data_dir", split_dir, "--epochs", "2", "--bs", "256",
             "--emb_size", "8", "--runs", "2"]
    jres = str(tmp_path / "jax.txt")
    jmain.run(jmake_args(flags + ["--emb_dir", str(tmp_path / "jemb"),
                                  "--result_file", jres]))
    tres = str(tmp_path / "port.txt")
    args = make_args(flags + ["--emb_dir", str(tmp_path / "emb"),
                              "--result_file", tres, "--device", "cpu"])
    payload = tmain.run(args)
    jh, jp = _result(jres)
    th, tp = _result(tres)
    assert th == jh
    assert _key_paths(tp) - _key_paths(jp) == {("hyperparameters",
                                                "device")}
    assert _key_paths(jp) - _key_paths(tp) == set()
    assert tp == json.loads(json.dumps(payload))
    assert tp["hyperparameters"]["device"] == "cpu"
    assert tp["efficiency"]["seconds_per_completed_epoch_mean"] > 0
    assert os.path.exists(tmp_path / "emb" / "synthds_cold_item_MF_emb.npz")
    # a second run appends with the separator
    args.runs = 1
    tmain.run(args)
    assert open(tres).read().count("=== ColdRec Run Result ===") == 2


def test_cli_profile_and_debug_nans(split_dir, tmp_path, capsys):
    """``--profile DIR`` writes a Chrome trace of the run (CPU ops on the
    CPU) and prints the JAX CLI's line; ``--debug_nans`` runs to the end on
    finite weights and leaves anomaly mode off afterwards."""
    flags = ["--data_dir", split_dir, "--dataset", "synthds", "--device",
             "cpu", "--epochs", "1", "--emb_size", "8", "--bs", "256",
             "--emb_dir", str(tmp_path / "emb")]
    pdir = tmp_path / "trace"
    tmain.run(make_args(flags + ["--profile", str(pdir), "--result_file",
                                 str(tmp_path / "p.txt")]))
    assert f"Profiler trace written to: {pdir}" in capsys.readouterr().out
    (trace,) = pdir.iterdir()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    payload = tmain.run(make_args(flags + ["--debug_nans", "true",
                                           "--result_file",
                                           str(tmp_path / "d.txt")]))
    assert payload["hyperparameters"]["debug_nans"] is True
    assert not torch.is_anomaly_enabled()


def test_profile_train_tool_runs_on_cpu():
    from coldrec_tpu_torch.tools import profile_train

    out = profile_train.profile("cpu", 200, 600, 5000, d=8, bs=128, steps=4)
    assert all(v > 0 for v in out.values()), out
    assert {"host_batch_ms", "upload_ms", "step_enqueue_ms", "loop_ms",
            "enqueue_adam_ms"} <= set(out)
