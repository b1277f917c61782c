"""The port's CLI runs each cold-start model on the MF bus and writes the
JAX CLI's (``main.py``'s) result schema and bus files, on the CPU.
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
from test_torch_cold_models import MODELS, small_flags
from test_torch_threads import torch_threads  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    """A split directory with item content, and the MF bus of a JAX run
    and of a port run on it."""
    root = tmp_path_factory.mktemp("data")
    pairs = synthetic_interactions(90, 110, 2200, seed=41)
    res = cold_start_split(pairs, cold_object="item", seed=42)
    write_split_dir(res, str(root), "synthds", "item")
    np.save(os.path.join(root, "synthds", "synthds_item_content.npy"),
            np.random.default_rng(0).standard_normal(
                (res.item_num, 8)).astype(np.float32))
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


@pytest.mark.parametrize("model", MODELS)
def test_cli_result_file_matches_main_py(split_dir, model, tmp_path):
    """The port's CLI trains the model on the MF bus and writes
    ``main.py``'s result schema (the same headers and JSON keys, plus
    ``device``) and the model's own bus file."""
    flags = ["--model", model, "--dataset", "synthds", "--data_dir",
             str(split_dir), "--epochs", "1", "--bs", "256", "--emb_size",
             "8"]
    for k, v in small_flags(model).items():
        flags += [f"--{k}", str(v)]
    jres = str(tmp_path / "jax.txt")
    jmain.run(jmake_args(flags + ["--emb_dir", str(split_dir / "jemb"),
                                  "--result_file", jres]))
    tres = str(tmp_path / "port.txt")
    tmain.run(make_args(flags + ["--emb_dir", str(split_dir / "emb"),
                                 "--result_file", tres, "--device", "cpu"]))
    jh, jp = _result(jres)
    th, tp = _result(tres)
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


def test_cli_without_bus_raises_naming_it(split_dir, tmp_path):
    args = make_args(["--model", "GAR", "--dataset", "synthds",
                      "--data_dir", str(split_dir), "--emb_dir",
                      str(tmp_path), "--device", "cpu"])
    with pytest.raises(FileNotFoundError,
                       match="synthds_cold_item_MF_emb.npz"):
        tmain.run(args)

