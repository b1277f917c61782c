"""``--mesh DxM`` training in the port on real gloo ranks against its
one-rank run, and MF on a 2x2 mesh against the JAX package's 2x2 run (the
cases of ``tests/test_mesh_training.py``).

One module fixture starts ``tests/torch_mesh_child.py`` as 2 ranks (MF
``1x2`` and ``2x1``) and as 4 ranks (MF ``2x2``; MF ``2x2`` for 2 epochs with a train
state checkpoint, then resumed to 4, and 4 uninterrupted; LightGCN ``2x2``
with 2 layers), each rank writing its eval tables, losses, test metrics and
the shapes of its parameters; meanwhile this process runs the one-rank
baselines and the JAX 2x2 run. Every MF run starts from the JAX trainer's
initial tables (``init_params``) and draws the same host batches.

Held: MF ``1x2`` (the model axis alone: the exchange lookup adds zeros)
bit-equal to one rank in its losses, tables and test lists; the data axis
(``2x1``, ``2x2``) and LightGCN's sharded SpMM within the JAX test's
tolerances, with equal test metrics; the item and user tables really
row-sharded; resume under a mesh equal to the uninterrupted run; the port's
``2x2`` run against the JAX package's within ``LOSS_RTOL`` / ``TABLE_ATOL``.
"""
import concurrent.futures
import json
import os
import sys

import numpy as np
import pytest

from coldrec_tpu.config import default_args as jargs
from coldrec_tpu.data.synthetic import synthetic_dataset as jsynth
from coldrec_tpu.models import model_factory as jfactory
from coldrec_tpu.runtime.trainer import Config as JConfig
from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from coldrec_tpu_torch.parallel.distributed import launch_ranks
from test_torch_threads import torch_threads  # noqa: F401
from torch_mesh_child import run, summary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# user_num 96 and item_num 80: both tables shard over a model axis of 2
KW = dict(n_users=96, n_items=80, n_inter=1800, cold_object="item", seed=91)
COMMON = dict(dataset="synth", epochs=3, bs=256, emb_size=16,
              early_stop=10, seed=5, save_emb=False)
LOSS_RTOL = 1e-5
# fp32: over 3 epochs the data axis moved no table element by more than
# 3e-8 from one rank, and the port's 2x2 run none by more than 1.5e-7 from
# the JAX package's (tests/test_mesh_training.py allows 2e-5 against one
# device)
TABLE_ATOL = 1e-6
JOBS = {
    2: [("mf12", dict(model="MF", mesh="1x2")),
        ("mf21", dict(model="MF", mesh="2x1"))],
    4: [("mf22", dict(model="MF", mesh="2x2")),
        ("resume_a", dict(model="MF", mesh="2x2", epochs=2,
                          state_ckpt="{tmp}/mesh.ckpt")),
        ("resume_b", dict(model="MF", mesh="2x2", epochs=4,
                          state_ckpt="{tmp}/mesh.ckpt")),
        ("full4", dict(model="MF", mesh="2x2", epochs=4)),
        ("lg22", dict(model="LightGCN", mesh="2x2", layers=2))],
}



def _jax_2x2(jd):
    """The JAX MF trainer on a 2x2 mesh of CPU devices: its initial tables
    and, after its run, the trainer and its per-batch losses."""
    jm = jfactory(JConfig(jargs(model="MF", mesh="2x2", **COMMON), jd))
    init = {k: np.asarray(v) for k, v in jm.params.items()}
    losses, step = [], jm._step

    def recording(params, opt_state, batch):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
        return params, opt_state, loss

    jm._step = recording
    return jm, init, losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    jm, init, jlosses = _jax_2x2(jsynth(**KW)[0])
    np.savez(tmp / "init.npz", **init)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]), "OMP_NUM_THREADS": "1"}
    futures = {}
    with concurrent.futures.ThreadPoolExecutor(len(JOBS)) as pool:
        for n, jobs in JOBS.items():
            spec = tmp / f"spec{n}.json"
            spec.write_text(json.dumps({
                "init": str(tmp / "init.npz"), "kw": KW, "common": COMMON,
                "out": str(tmp), "jobs": [
                    (name, {k: v.format(tmp=tmp) if isinstance(v, str)
                            else v for k, v in kw.items()})
                    for name, kw in jobs]}))
            futures[n] = pool.submit(
                launch_ranks, [sys.executable, os.path.join(
                    REPO, "tests", "torch_mesh_child.py"), str(spec)], n,
                240, env)
        jm.run()
        data = synthetic_dataset(**KW)[0]
        one = {"mf": summary(run(data, COMMON, {"model": "MF"}, init)),
               "lg": summary(run(data, COMMON, {"model": "LightGCN",
                                                "layers": 2}))}
        for n in JOBS:
            for rank, (code, out) in enumerate(futures[n].result()):
                assert code == 0, f"{n} ranks, rank {rank}:\n{out[-3000:]}"
    ranks = {f"{name}/{r}": dict(np.load(tmp / f"{name}_rank{r}.npz"))
             for n, jobs in JOBS.items() for name, _ in jobs
             for r in range(n)}
    return {"one": one, "ranks": ranks, "jax": (jm, jlosses), "data": data}


def _same_metrics(a, b):
    for key in ("overall", "cold", "warm"):
        np.testing.assert_array_equal(a[key], b[key])


def test_model_axis_alone_is_bit_equal(runs):
    """MF 1x2: the exchange lookup adds only zeros and its backward is the
    one-rank index backward on the owned ids, so nothing differs."""
    one = runs["one"]["mf"]
    for r in range(2):
        got = runs["ranks"][f"mf12/{r}"]
        for key in ("losses", "user_emb", "item_emb", "lists"):
            np.testing.assert_array_equal(got[key], one[key])
        _same_metrics(got, one)


def test_dp_matches_single_device(runs):
    one = runs["one"]["mf"]
    for r in range(2):
        got = runs["ranks"][f"mf21/{r}"]
        np.testing.assert_allclose(got["losses"], one["losses"],
                                   rtol=LOSS_RTOL)
        for key in ("user_emb", "item_emb"):
            np.testing.assert_allclose(got[key], one[key], atol=TABLE_ATOL)
        _same_metrics(got, one)


def test_dp_tp_matches_single_device(runs):
    data, one = runs["data"], runs["one"]["mf"]
    for r in range(4):
        got = runs["ranks"][f"mf22/{r}"]
        # both tables really row-sharded over the model axis of 2
        assert got["shapes"].tolist() == [[data.user_num // 2, 16],
                                          [data.item_num // 2, 16]]
        np.testing.assert_allclose(got["losses"], one["losses"],
                                   rtol=LOSS_RTOL)
        for key in ("user_emb", "item_emb"):
            np.testing.assert_allclose(got[key], one[key], atol=TABLE_ATOL)
        _same_metrics(got, one)


def test_dp_tp_matches_jax_2x2(runs):
    """The port's 2x2 run and the JAX package's 2x2 run, from the same
    tables on the same batches."""
    jm, jlosses = runs["jax"]
    got = runs["ranks"]["mf22/0"]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["user_emb"], np.asarray(jm.user_emb),
                               atol=TABLE_ATOL)
    np.testing.assert_allclose(got["item_emb"], np.asarray(jm.item_emb),
                               atol=TABLE_ATOL)
    for key, ref in (("overall", jm.overall_test_results),
                     ("cold", jm.cold_test_results),
                     ("warm", jm.warm_test_results)):
        np.testing.assert_allclose(got[key], np.asarray(ref), atol=1e-6)


def test_mesh_resume(runs):
    """A 2x2 run checkpointed after 2 epochs and resumed to 4 equals the
    uninterrupted 4-epoch run, its tables sharded again on resume."""
    data = runs["data"]
    for r in range(4):
        resumed = runs["ranks"][f"resume_b/{r}"]
        full = runs["ranks"][f"full4/{r}"]
        assert resumed["shapes"].tolist() == [[data.user_num // 2, 16],
                                              [data.item_num // 2, 16]]
        np.testing.assert_array_equal(resumed["losses"],
                                      full["losses"][-len(resumed["losses"]):])
        for key in ("user_emb", "item_emb", "lists"):
            np.testing.assert_array_equal(resumed[key], full[key])
        _same_metrics(resumed, full)


def test_lightgcn_sharded_spmm_matches_single_device(runs):
    one = runs["one"]["lg"]
    for r in range(4):
        got = runs["ranks"][f"lg22/{r}"]
        np.testing.assert_allclose(got["losses"], one["losses"],
                                   rtol=LOSS_RTOL)
        for key in ("user_emb", "item_emb"):
            np.testing.assert_allclose(got[key], one[key], atol=TABLE_ATOL)
        _same_metrics(got, one)
