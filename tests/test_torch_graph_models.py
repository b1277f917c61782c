"""The five graph backbones of the port against the JAX package, on the CPU.

Each case builds the JAX trainer and the port's on the same numpy data,
carries the JAX ``params`` across with ``init_params=`` and feeds both the
same batch: SimGCL's and XSimGCL's U(0,1) noise is drawn once here and
injected into both, NCL's clusters are the JAX e-step's. The tables, the
loss and every gradient agree within ``TOL`` (1e-5) of their scale: float32
sums in another order. LightGCN and NGCF also train 3 epochs through both
trainers from shared weights (the same batch stream, bit for bit): losses
and tables within ``TOL``, the same best epoch. Then the CLI's result file
against ``main.py``'s, the flag constraints, NCL's warm-up switch,
SimGCL's all-zero cold rows through the exact fallback, and BASELINE
config 5's chain (XSimGCL's bus feeding Heater under user cold start).
"""
import json
import os

import jax
import jax.numpy as jnp
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
from coldrec_tpu_torch.data.sampler import pairwise_batches
from coldrec_tpu_torch.data.split import cold_start_split, write_split_dir
from coldrec_tpu_torch.data.synthetic import (
    synthetic_dataset, synthetic_interactions,
)
from coldrec_tpu_torch.models import TRAINERS, model_factory
from coldrec_tpu_torch.models.common import jax_value
from coldrec_tpu_torch.models.ncl import WARMUP_EPOCHS
from coldrec_tpu_torch.runtime.trainer import Config, three_way_test
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

TOL = 1e-5
MODELS = ("LightGCN", "NGCF", "SimGCL", "XSimGCL", "NCL")
KW = dict(n_users=90, n_items=120, n_inter=2400, seed=23)
COMMON = dict(dataset="synth", bs=256, emb_size=16, seed=5, save_emb=False,
              layers=2)


@pytest.fixture(scope="module")
def envs():
    return {obj: (jsynth(cold_object=obj, **KW)[0],
                  synthetic_dataset(cold_object=obj, **KW)[0])
            for obj in ("item", "user")}


def _pair(envs, model, obj="item", **kw):
    """The JAX trainer and the port's, holding the same weights."""
    jd, td = envs[obj]
    jm = jfactory(JConfig(jargs(model=model, cold_object=obj,
                                **{**COMMON, **kw}), jd))
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    tm = TRAINERS[model](Config(default_args(
        model=model, cold_object=obj, device="cpu", **{**COMMON, **kw}), td),
        init_params=params)
    return jm, tm


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= TOL * scale, f"{what}: {err} vs scale {scale}"


@pytest.mark.parametrize("model,obj", [(m, o) for m in MODELS
                                       for o in ("item", "user")])
def test_tables_loss_and_gradients_match_jax(envs, model, obj):
    jm, tm = _pair(envs, model, obj)
    td = envs[obj][1]
    for got, want, side in zip(tm.forward_tables(),
                               jm.forward_tables(jm.params), "ui"):
        _close(got.detach(), want, f"{side} table")
    batch = next(iter(pairwise_batches(td, 256, np.random.default_rng(0))))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    n = td.user_num + td.item_num
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(0)
    if model == "SimGCL":
        noise = [rng.random((2, n, 16), dtype=np.float32) for _ in range(2)]
        jloss = lambda p: jm.loss_fn(p, jb, key, noise_pair=tuple(
            jnp.asarray(x) for x in noise))
        kw = {"noise_pair": tuple(torch.tensor(x) for x in noise)}
    elif model == "XSimGCL":
        noise = rng.random((2, n, 16), dtype=np.float32)
        jloss = lambda p: jm.loss_fn(p, jb, key, noise=jnp.asarray(noise))
        kw = {"noise": torch.tensor(noise)}
    elif model == "NCL":
        jm.e_step()
        clusters = (jm.user_centroids, jm.user_2cluster, jm.item_centroids,
                    jm.item_2cluster)
        jloss = lambda p: jm._full_loss(p, jb, clusters)
        kw = {"clusters": tuple(torch.tensor(np.asarray(c))
                                for c in clusters)}
    else:
        jloss = lambda p: jm.loss_fn(p, jb, None)
        kw = {}
    want, grads = jax.value_and_grad(jloss)(jm.params)
    got = tm.loss(tb, **kw)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= TOL * abs(float(want))
    grads = jax.tree_util.tree_map(np.asarray, grads)
    for path, tensor, transposed in tm.model.jax_slots():
        want_g = jax_value({"params": grads}, path)
        got_g = tensor.grad.numpy()
        _close(got_g.T if transposed else got_g, want_g, "/".join(
            map(str, path)))


def _recording(jm):
    losses, step = [], jm._step

    def rec(params, opt_state, batch, *key):
        params, opt_state, loss = step(params, opt_state, batch, *key)
        losses.append(float(loss))
        return params, opt_state, loss

    jm._step = rec
    return losses


@pytest.mark.parametrize("model", ["LightGCN", "NGCF"])
def test_three_epochs_match_jax(envs, model):
    jm, tm = _pair(envs, model, epochs=3, early_stop=10)
    jlosses = _recording(jm)
    jm.run()
    tm.run()
    tl = [x for s in tm.epoch_stats for x in s["losses"]]
    assert len(tl) == len(jlosses) > 0
    np.testing.assert_allclose(tl, jlosses, rtol=TOL)
    for got, want in ((tm.user_emb, jm.user_emb), (tm.item_emb, jm.item_emb)):
        _close(got, want, "best table")
    jparams = jax.tree_util.tree_map(np.asarray, jm.params)
    for path, tensor, transposed in tm.model.jax_slots():
        got = tensor.detach().numpy()
        _close(got.T if transposed else got, jax_value(
            {"params": jparams}, path), "/".join(map(str, path)))
    assert tm.best_performance[0] == jm.best_performance[0]
    assert tm.epochs_ran == jm.epochs_ran == 3


@pytest.fixture(scope="module")
def split_dirs(tmp_path_factory):
    """Split directories of one interaction set, item and user cold, with
    the cold side's content."""
    root = tmp_path_factory.mktemp("graph_data")
    pairs = synthetic_interactions(90, 110, 2200, seed=43)
    for obj in ("item", "user"):
        res = cold_start_split(pairs, cold_object=obj, seed=44)
        write_split_dir(res, str(root), f"g{obj}", obj)
        n = res.item_num if obj == "item" else res.user_num
        np.save(os.path.join(root, f"g{obj}", f"g{obj}_{obj}_content.npy"),
                np.random.default_rng(0).standard_normal((n, 8)).astype(
                    np.float32))
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


def _cli_flags(model, split_dirs):
    return ["--model", model, "--dataset", "gitem", "--cold_object", "item",
            "--data_dir", split_dirs, "--epochs", "1", "--bs", "256",
            "--emb_size", "8"]


@pytest.fixture(scope="module")
def jax_result(split_dirs, tmp_path_factory):
    """One result file of ``main.py`` (LightGCN): its headers and JSON."""
    tmp = tmp_path_factory.mktemp("jax_cli")
    jres = str(tmp / "jax.txt")
    jmain.run(jmake_args(_cli_flags("LightGCN", split_dirs) + [
        "--emb_dir", str(tmp / "jemb"), "--result_file", jres]))
    return _result(jres)


@pytest.mark.parametrize("model", MODELS)
def test_cli_writes_the_jax_schema(split_dirs, jax_result, tmp_path, model):
    """The headers and the JSON keys of ``main.py``'s result file; the
    hyperparameters are the JAX CLI's flags of ``model`` plus --device."""
    flags = _cli_flags(model, split_dirs)
    tres = str(tmp_path / "port.txt")
    payload = tmain.run(make_args(flags + ["--emb_dir", str(tmp_path / "emb"),
                                           "--result_file", tres,
                                           "--device", "cpu"]))
    jh, jp = jax_result
    th, tp = _result(tres)
    assert th == jh
    jflags = set(vars(jmake_args(flags + ["--emb_dir", "e",
                                          "--result_file", "r"])))
    assert set(tp["hyperparameters"]) == jflags | {"device"}
    rest = {k: v for k, v in tp.items() if k != "hyperparameters"}
    jrest = {k: v for k, v in jp.items() if k != "hyperparameters"}
    assert _key_paths(rest) == _key_paths(jrest)
    assert tp == json.loads(json.dumps(payload))
    assert tp["method"] == model
    with np.load(tmp_path / "emb" / f"gitem_cold_item_{model}_emb.npz") as z:
        assert z["user_emb"].shape[1] == z["item_emb"].shape[1] == 8
        assert np.isfinite(z["user_emb"]).all()


@pytest.mark.parametrize("model,flags", [
    ("XSimGCL", dict(l_cl=0)), ("XSimGCL", dict(l_cl=3)),
    ("NCL", dict(hyper_layers=2)), ("NCL", dict(hyper_layers=2, layers=3)),
])
def test_flag_constraints_raise_as_in_jax(envs, model, flags):
    jd, td = envs["item"]
    with pytest.raises(ValueError, match=model):
        jfactory(JConfig(jargs(model=model, **{**COMMON, **flags}), jd))
    with pytest.raises(ValueError, match=model):
        TRAINERS[model](Config(default_args(
            model=model, device="cpu", **{**COMMON, **flags}), td))


def test_ncl_proto_term_turns_on_after_the_warm_up(envs):
    _, td = envs["item"]
    tm = TRAINERS["NCL"](Config(default_args(model="NCL", device="cpu",
                                             **COMMON), td))
    batch = {k: torch.from_numpy(v) for k, v in next(iter(pairwise_batches(
        td, 256, np.random.default_rng(0)))).items()}
    base = float(tm.loss(batch).detach())
    tm.epoch_hook(WARMUP_EPOCHS - 1)
    assert not tm._proto_on and tm.clusters is None
    tm.epoch_hook(WARMUP_EPOCHS)
    uc, u2c, ic, i2c = tm.clusters
    assert uc.shape == ic.shape == (tm.k, 16)
    assert u2c.shape == (td.user_num,) and i2c.shape == (td.item_num,)
    with_proto = float(tm.loss(batch).detach())
    assert np.isfinite(with_proto) and with_proto != base
    assert with_proto == float(tm.loss(batch, clusters=tm.clusters).detach())


def test_simgcl_cold_rows_are_zero_and_take_the_exact_fallback(envs):
    """The clean SimGCL / XSimGCL tables give the cold items (degree 0) an
    all-zero row, so every cold-setting row is an all-tie: the kernel
    path's fallback returns the lowest ids first, as the plain path."""
    _, td = envs["item"]
    for model in ("SimGCL", "XSimGCL"):
        tm = TRAINERS[model](Config(default_args(model=model, device="cpu",
                                                 **COMMON), td))
        ue, ie = tm.user_emb, tm.item_emb
        cold = torch.as_tensor(td.mapped_cold_item_idx)
        assert not ie[cold].any() and ue.abs().sum(1).gt(0).all()
        got = three_way_test(td, ue, ie, backend="kernel", device="cpu",
                             verbose=False)
        plain = three_way_test(td, ue, ie, backend="plain", device="cpu",
                               verbose=False)
        rec = got["cold"]["rec"]
        assert np.array_equal(rec, plain["cold"]["rec"])
        assert np.array_equal(rec[0], np.sort(rec[0]))


def test_simgcl_noise_comes_from_the_seeded_generator(envs):
    _, td = envs["item"]
    batch = {k: torch.from_numpy(v) for k, v in next(iter(pairwise_batches(
        td, 256, np.random.default_rng(0)))).items()}
    losses = []
    for _ in range(2):
        tm = TRAINERS["SimGCL"](Config(default_args(
            model="SimGCL", device="cpu", **COMMON), td))
        losses.append([float(tm.loss(batch).detach()) for _ in range(2)])
    assert losses[0] == losses[1] and losses[0][0] != losses[0][1]


def test_config5_chain_xsimgcl_bus_feeds_heater_under_user_cold(
        split_dirs, tmp_path):
    base = ["--dataset", "guser", "--cold_object", "user", "--data_dir",
            split_dirs, "--emb_dir", str(tmp_path / "emb"), "--epochs", "1",
            "--bs", "256", "--emb_size", "8", "--device", "cpu"]
    tmain.run(make_args(["--model", "XSimGCL", "--result_file",
                         str(tmp_path / "x.txt")] + base))
    assert (tmp_path / "emb" / "guser_cold_user_XSimGCL_emb.npz").exists()
    payload = tmain.run(make_args(
        ["--model", "Heater", "--backbone", "XSimGCL", "--save_emb", "false",
         "--result_file", str(tmp_path / "h.txt")] + base))
    assert payload["hyperparameters"]["backbone"] == "XSimGCL"
    assert np.isfinite(payload["metrics"]["20"]["cold"]["NDCG"]["mean"])
    args = default_args(model="Heater", backbone="LightGCN",
                        cold_object="user", emb_dir=str(tmp_path / "emb"),
                        dataset="guser", data_dir=split_dirs, device="cpu")
    with pytest.raises(FileNotFoundError, match="LightGCN"):
        model_factory(Config(args))
