"""SimGCL, XSimGCL, NGCF and NCL on ``--mesh DxM`` in the port, on real gloo
ranks, against one rank and against the JAX package (the graph-backbone
cases of ``tests/test_mesh_training.py``).

One module fixture starts ``tests/torch_mesh_child.py`` as 2 ranks (each
model at ``1x2`` and ``2x1``) and as 4 ranks (each at ``2x2``; NGCF and NCL
at ``2x2`` from the JAX trainer's initial weights, NCL with clusters passed
in; one SimGCL and one XSimGCL step from the JAX weights with injected
noise); meanwhile this process runs the one-rank baselines, the JAX
package's NGCF and NCL on a 2x2 mesh of CPU devices, and the JAX
``loss_fn`` of the injected-noise step. NCL runs with its proto term and
e-step on from epoch 0 (``proto_from``), so the ranks' k-means runs on the
gathered tables.

Held, every rank: the per-batch losses within ``LOSS_RTOL`` of one rank's,
the eval tables within ``TABLE_ATOL``, the test metrics and test lists
equal; the user and item tables row-sharded under a model axis of 2 (local
height N / 2); NGCF's Linears the same on every rank and within
``TABLE_ATOL`` of one rank's; NCL's clusters equal to one rank's. The
JAX comparisons: NGCF's and NCL's 2x2 losses within ``LOSS_RTOL`` and
tables within ``TABLE_ATOL`` of the JAX 2x2 run's, the test metrics within
1e-6; the injected-noise step's loss within ``LOSS_RTOL`` and every
gradient within ``GRAD_RTOL`` of its scale of the JAX ``loss_fn``'s. Every
tolerance is no looser than the JAX tests' 5e-5 (``test_mesh_training.py``).
"""
import concurrent.futures
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coldrec_tpu.config import default_args as jargs
from coldrec_tpu.data.synthetic import synthetic_dataset as jsynth
from coldrec_tpu.models import model_factory as jfactory
from coldrec_tpu.runtime.trainer import Config as JConfig
from coldrec_tpu_torch.data.sampler import pairwise_batches
from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from coldrec_tpu_torch.models.common import jax_value
from coldrec_tpu_torch.models.lightgcn import GraphTables
from coldrec_tpu_torch.parallel.distributed import launch_ranks
from test_torch_threads import torch_threads  # noqa: F401
from torch_mesh_child import run, summary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# user_num 96 and item_num 80: both tables shard over a model axis of 2
KW = dict(n_users=96, n_items=80, n_inter=1800, cold_object="item", seed=91)
COMMON = dict(dataset="synth", epochs=2, bs=256, emb_size=16, layers=2,
              early_stop=10, seed=5, save_emb=False)
MODELS = ("SimGCL", "XSimGCL", "NGCF", "NCL")
MESHES = ("1x2", "2x1", "2x2")
# fp32 sums in another order (the sharded SpMM, the data axis): over 2
# epochs the losses read <= 1.8e-7 relative and the tables <= 4e-7 from one
# rank; the port's 2x2 against the JAX package's 2x2 <= 2e-7 / 3e-7
LOSS_RTOL = 1e-5
TABLE_ATOL = 5e-6
GRAD_RTOL = 1e-5


def _jobs(mesh):
    return [(f"{m.lower()}{mesh.replace('x', '')}",
             dict(model=m, mesh=mesh, **({"proto_from": 0}
                                         if m == "NCL" else {})))
            for m in MODELS]


def _jax_run(jd, model, tmp):
    """The JAX trainer of ``model`` on a 2x2 mesh of CPU devices (NCL with
    fixed clusters, its proto term on): its initial weights pickled for
    the port, and the trainer and per-batch losses after its run."""
    jm = jfactory(JConfig(jargs(model=model, mesh="2x2", **COMMON), jd))
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    with open(tmp / f"{model}_init.pkl", "wb") as f:
        pickle.dump((params, None), f)
    losses = []

    def recording(step):
        def rec(*args):
            params, opt_state, loss = step(*args)
            losses.append(float(loss))
            return params, opt_state, loss
        return rec

    jm._step = recording(jm._step)
    if model == "NCL":
        rng = np.random.default_rng(3)
        k, d = jm.k, COMMON["emb_size"]
        clusters = {"uc": rng.standard_normal((k, d)).astype(np.float32),
                    "u2c": rng.integers(0, k, jd.user_num),
                    "ic": rng.standard_normal((k, d)).astype(np.float32),
                    "i2c": rng.integers(0, k, jd.item_num)}
        np.savez(tmp / "clusters.npz", **clusters)
        (jm.user_centroids, jm.user_2cluster, jm.item_centroids,
         jm.item_2cluster) = (jnp.asarray(clusters[k]) for k in
                              ("uc", "u2c", "ic", "i2c"))
        jm._proto_on = True
        jm.epoch_hook = lambda epoch: None
        jm._step_proto = recording(jm._step_proto)
    return jm, losses


def _noise_inputs(td, tmp):
    """One batch, the weights and the U(0,1) noise of a SimGCL and an
    XSimGCL step, written for the ranks; returns (batch, params, noise by
    model)."""
    batch = next(iter(pairwise_batches(td, COMMON["bs"],
                                       np.random.default_rng(0))))
    np.savez(tmp / "batch.npz", **batch)
    init = GraphTables(td.user_num, td.item_num, COMMON["emb_size"], seed=7,
                       device="cpu")
    params = {k: v.detach().numpy() for k, v in init.named_parameters()}
    with open(tmp / "graph_init.pkl", "wb") as f:
        pickle.dump((params, None), f)
    rng = np.random.default_rng(1)
    shape = (COMMON["layers"], td.user_num + td.item_num, COMMON["emb_size"])
    noise = {"SimGCL": ("noise_pair", rng.random((2,) + shape,
                                                 dtype=np.float32)),
             "XSimGCL": ("noise", rng.random(shape, dtype=np.float32))}
    for model, (key, x) in noise.items():
        np.savez(tmp / f"{model}_noise.npz", **{key: x})
    return batch, params, noise


def _jax_step(jd, model, batch, params, noise):
    """The JAX ``loss_fn``'s value and gradients of the injected-noise
    step."""
    key, x = noise
    jm = jfactory(JConfig(jargs(model=model, **COMMON), jd))
    jx = tuple(map(jnp.asarray, x)) if key == "noise_pair" else jnp.asarray(x)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb, jax.random.PRNGKey(0), **{key: jx})))(
        {k: jnp.asarray(v) for k, v in params.items()})
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_graph")
    jd, td = jsynth(**KW)[0], synthetic_dataset(**KW)[0]
    jax_runs = {m: _jax_run(jd, m, tmp) for m in ("NGCF", "NCL")}
    batch, params, noise = _noise_inputs(td, tmp)
    jobs = {2: _jobs("1x2") + _jobs("2x1"),
            4: _jobs("2x2") + [
                ("ngcfjax", dict(model="NGCF", mesh="2x2",
                                 jax_init=str(tmp / "NGCF_init.pkl"))),
                ("ncljax", dict(model="NCL", mesh="2x2",
                                jax_init=str(tmp / "NCL_init.pkl"),
                                clusters=str(tmp / "clusters.npz")))] + [
                (f"step{m}", dict(model=m, mesh="2x2",
                                  jax_init=str(tmp / "graph_init.pkl"),
                                  batch=str(tmp / "batch.npz"),
                                  noise=str(tmp / f"{m}_noise.npz")))
                for m in ("SimGCL", "XSimGCL")]}
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]), "OMP_NUM_THREADS": "1"}
    futures = {}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        for n, group in jobs.items():
            spec = tmp / f"spec{n}.json"
            spec.write_text(json.dumps({"kw": KW, "common": COMMON,
                                        "out": str(tmp), "jobs": group}))
            futures[n] = pool.submit(
                launch_ranks, [sys.executable, os.path.join(
                    REPO, "tests", "torch_mesh_child.py"), str(spec)], n,
                240, env)
        for jm, _ in jax_runs.values():
            jm.run()
        steps = {m: _jax_step(jd, m, batch, params, noise[m])
                 for m in noise}
        one = {m: summary(run(td, COMMON, {"model": m, **(
            {"proto_from": 0} if m == "NCL" else {})})) for m in MODELS}
        for n in jobs:
            for rank, (code, out) in enumerate(futures[n].result()):
                assert code == 0, f"{n} ranks, rank {rank}:\n{out[-3000:]}"
    ranks = {f"{name}/{r}": dict(np.load(tmp / f"{name}_rank{r}.npz"))
             for n, group in jobs.items() for name, _ in group
             for r in range(n)}
    return {"one": one, "ranks": ranks, "jax": jax_runs, "steps": steps,
            "data": td}


def _n_ranks(mesh):
    return int(np.prod([int(x) for x in mesh.split("x")]))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("model", MODELS)
def test_mesh_matches_one_rank(runs, model, mesh):
    data, one = runs["data"], runs["one"][model]
    n_model = int(mesh.split("x")[1])
    for r in range(_n_ranks(mesh)):
        got = runs["ranks"][f"{model.lower()}{mesh.replace('x', '')}/{r}"]
        # the ego tables row-sharded over the model axis
        assert got["shapes"].tolist()[:2] == [
            [data.user_num // n_model, 16], [data.item_num // n_model, 16]]
        np.testing.assert_allclose(got["losses"], one["losses"],
                                   rtol=LOSS_RTOL)
        for key in ("user_emb", "item_emb"):
            np.testing.assert_allclose(got[key], one[key], atol=TABLE_ATOL)
        for key in ("overall", "cold", "warm", "lists"):
            np.testing.assert_array_equal(got[key], one[key])


@pytest.mark.parametrize("mesh", MESHES)
def test_ngcf_linears_stay_replicated(runs, mesh):
    """NGCF's Linears act on each rank's node block; their gradient summed
    over the model group keeps them the same on every rank."""
    name = f"ngcf{mesh.replace('x', '')}"
    first = runs["ranks"][f"{name}/0"]["linears"]
    for r in range(1, _n_ranks(mesh)):
        np.testing.assert_array_equal(runs["ranks"][f"{name}/{r}"]["linears"],
                                      first)
    np.testing.assert_allclose(first, runs["one"]["NGCF"]["linears"],
                               atol=TABLE_ATOL)


@pytest.mark.parametrize("mesh", MESHES)
def test_ncl_clusters_match_one_rank(runs, mesh):
    """The e-step's k-means on the gathered tables, the generator in one
    state on every rank: one rank's clusters on every rank."""
    one = runs["one"]["NCL"]
    for r in range(_n_ranks(mesh)):
        got = runs["ranks"][f"ncl{mesh.replace('x', '')}/{r}"]
        np.testing.assert_array_equal(got["assign"], one["assign"])
        np.testing.assert_allclose(got["centroids"], one["centroids"],
                                   atol=TABLE_ATOL)


@pytest.mark.parametrize("model", ["NGCF", "NCL"])
def test_mesh_2x2_matches_jax_2x2(runs, model):
    """The port's 2x2 ranks and the JAX package's 2x2 run, from the same
    weights on the same batches (NCL on the same fixed clusters)."""
    jm, jlosses = runs["jax"][model]
    for r in range(4):
        got = runs["ranks"][f"{model.lower()}jax/{r}"]
        np.testing.assert_allclose(got["losses"], jlosses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["user_emb"], np.asarray(jm.user_emb),
                                   atol=TABLE_ATOL)
        np.testing.assert_allclose(got["item_emb"], np.asarray(jm.item_emb),
                                   atol=TABLE_ATOL)
        for key, ref in (("overall", jm.overall_test_results),
                         ("cold", jm.cold_test_results),
                         ("warm", jm.warm_test_results)):
            np.testing.assert_allclose(got[key], np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("model", ["SimGCL", "XSimGCL"])
def test_noise_step_matches_jax_loss_fn(runs, model):
    """One 2x2 step with the JAX run's noise injected (each rank its node
    block of every plane): the loss and the gradients of the global batch
    are the JAX ``loss_fn``'s."""
    want, grads = runs["steps"][model]
    for r in range(4):
        got = runs["ranks"][f"step{model}/{r}"]
        assert abs(float(got["loss"]) - want) <= LOSS_RTOL * abs(want)
        for name in ("user_emb", "item_emb"):
            ref = np.asarray(jax_value({"params": grads}, ("params", name)))
            err = np.abs(got[f"grad/{name}"] - ref).max()
            assert err <= GRAD_RTOL * np.abs(ref).max(), (name, err)
