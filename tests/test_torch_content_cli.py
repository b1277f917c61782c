"""The port's CLI runs each content-feature cold model (KNN, AGNN, VBPR,
AMR, MTPR, MetaEmbedding, LARA, CLCRec, GoRec) on an item-cold split and
writes the JAX CLI's (``main.py``'s) result schema and bus keys (VBPR's five
tensors, GoRec's ``cluster_label``), on the CPU; VBPR's bus feeds AMR, and
KNN runs on a LightGCN encoder.
"""
import json
import os

import numpy as np
import pytest

import main as jmain
from coldrec_tpu.config import make_args as jmake_args
from coldrec_tpu_torch import main as tmain
from coldrec_tpu_torch.config import make_args
from coldrec_tpu_torch.data.split import cold_start_split, write_split_dir
from coldrec_tpu_torch.data.synthetic import synthetic_interactions
from coldrec_tpu_torch.runtime.checkpoints import load_embeddings
from test_torch_content_models import MODELS, small_flags
from test_torch_threads import torch_threads  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    """An item-cold split directory with item content, and the MF bus of a
    JAX run and of a port run on it."""
    root = tmp_path_factory.mktemp("content_data")
    pairs = synthetic_interactions(90, 110, 2200, seed=41)
    res = cold_start_split(pairs, cold_object="item", seed=42)
    write_split_dir(res, str(root), "synthds", "item")
    np.save(os.path.join(root, "synthds", "synthds_item_content.npy"),
            np.random.default_rng(0).standard_normal(
                (res.item_num, 12)).astype(np.float32))
    flags = ["--model", "MF", "--dataset", "synthds", "--data_dir",
             str(root), "--epochs", "2", "--bs", "256", "--emb_size", "8",
             "--result_file", str(root / "mf.txt")]
    jmain.run(jmake_args(flags + ["--emb_dir", str(root / "jemb")]))
    tmain.run(make_args(flags + ["--emb_dir", str(root / "emb"),
                                 "--device", "cpu"]))
    return root


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


def _cli(split_dir, model, tmp_path, extra=()):
    """Both CLIs on the split (VBPR first where the model is AMR); returns
    the two result files' (headers, JSON)."""
    flags = ["--model", model, "--dataset", "synthds", "--data_dir",
             str(split_dir), "--epochs", "1", "--bs", "256", "--emb_size",
             "8", *extra]
    for k, v in small_flags(model).items():
        flags += [f"--{k}", str(v)]
    jres = str(tmp_path / f"jax_{model}.txt")
    tres = str(tmp_path / f"port_{model}.txt")
    jmain.run(jmake_args(flags + ["--emb_dir", str(split_dir / "jemb"),
                                  "--result_file", jres]))
    tmain.run(make_args(flags + ["--emb_dir", str(split_dir / "emb"),
                                 "--result_file", tres, "--device", "cpu"]))
    return _result(jres), _result(tres)


@pytest.mark.parametrize("model", MODELS)
def test_cli_writes_the_jax_schema(split_dir, model, tmp_path):
    """The port's CLI writes ``main.py``'s result schema (the same headers
    and JSON keys, plus ``device``) and the same bus keys (VBPR's five
    tensors, GoRec's ``cluster_label``); AMR reads the VBPR bus that the
    VBPR case wrote (both CLIs run VBPR first)."""
    if model == "AMR":
        _cli(split_dir, "VBPR", tmp_path)
    (jh, jp), (th, tp) = _cli(split_dir, model, tmp_path)
    assert th == jh
    assert _key_paths(tp) - _key_paths(jp) == {("hyperparameters",
                                                "device")}
    assert _key_paths(jp) - _key_paths(tp) == set()
    assert tp["method"] == model
    bus = load_embeddings(str(split_dir / "emb"), "synthds", "item", model)
    jbus = load_embeddings(str(split_dir / "jemb"), "synthds", "item", model)
    assert set(bus) == set(jbus)
    for k, v in bus.items():
        assert v.shape == jbus[k].shape and np.isfinite(v).all(), k
    if model == "VBPR":
        assert {"user_emb_main_P", "item_emb_main_Q", "user_emb_aux",
                "item_emb_aux", "W"} <= set(bus)
    if model == "GoRec":
        assert bus["cluster_label"].dtype.kind == "i"


def test_vbpr_bus_feeds_amr(split_dir, tmp_path):
    """AMR starts from the tensors VBPR wrote: its first eval tables are
    VBPR's best tables, and a run without a VBPR bus names the npz."""
    from coldrec_tpu_torch.config import default_args
    from coldrec_tpu_torch.models import model_factory
    from coldrec_tpu_torch.runtime.trainer import Config

    _cli(split_dir, "VBPR", tmp_path)
    bus = load_embeddings(str(split_dir / "emb"), "synthds", "item", "VBPR")
    args = default_args(model="AMR", dataset="synthds", data_dir=str(
        split_dir), emb_dir=str(split_dir / "emb"), emb_size=8, bs=256,
        device="cpu")
    amr = model_factory(Config(args))
    np.testing.assert_allclose(amr.user_emb.numpy(), bus["user_emb"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(amr.item_emb.numpy(), bus["item_emb"],
                               rtol=0, atol=1e-6)
    args.emb_dir = str(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="synthds_cold_item_VBPR"):
        model_factory(Config(args))


def test_knn_runs_on_a_lightgcn_encoder(split_dir, tmp_path):
    (jh, jp), (th, tp) = _cli(split_dir, "KNN", tmp_path,
                              ("--backbone", "LightGCN", "--layers", "2"))
    assert th == jh and tp["hyperparameters"]["backbone"] == "LightGCN"
    assert np.isfinite(tp["metrics"]["20"]["cold"]["NDCG"]["mean"])
    with np.load(split_dir / "emb" / "synthds_cold_item_KNN_emb.npz") as z:
        assert z["item_emb"].shape[1] == 8

