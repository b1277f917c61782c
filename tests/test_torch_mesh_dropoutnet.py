"""DropoutNet on ``--mesh DxM`` in the port: real gloo ranks against one
rank and against the JAX package's 2x2 run (the cases of
``tests/test_mesh_training.py::test_mesh_stateful_model``, held tighter).

One module fixture writes random MF tables on the bus and starts
``tests/torch_mesh_child.py`` as 2 ranks (DropoutNet ``1x2`` and ``2x1``,
and the sync-BN case on a data group of 2) and as 4 ranks (``2x2`` for 2
epochs; ``2x2`` for 1 epoch with a train state checkpoint, then resumed to
2); meanwhile this process runs the JAX DropoutNet on a 2x2 mesh of CPU
devices for 1 epoch, recording its masks, then starts a third group of 4
ranks on the JAX trainer's initial weights with its masks injected, and
runs the one-rank baselines.

Held: ``1x2`` (the tables row-sharded, no data axis) bit-equal to one rank
in its losses, eval tables, bus tables, towers, BatchNorm statistics and
test lists; ``2x1`` and ``2x2`` (BatchNorm statistics all-reduced over the
data group) within ``RTOL`` / ``ATOL``, with the Linear biases ahead of a
BatchNorm left out (their exact gradient is 0: Adam walks them on rounding
noise, ``tests/test_torch_cold_models.py``); every rank's BatchNorm running
statistics identical; the global masks every rank drew equal to one rank's;
the sync-BN backward equal to one rank's autograd of the global batch; the
port's 2x2 run against the JAX package's; resume under 2x2 bit-equal to the
uninterrupted run.
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
from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from coldrec_tpu_torch.parallel.distributed import launch_ranks
from coldrec_tpu_torch.runtime.checkpoints import save_embeddings
from test_torch_threads import torch_threads  # noqa: F401
from torch_mesh_child import run, summary, syncbn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# user_num 96 and item_num 80: both bus tables shard over a model axis of 2
KW = dict(n_users=96, n_items=80, n_inter=1800, cold_object="item", seed=91)
COMMON = dict(model="DropoutNet", dataset="synth", epochs=2, bs=256,
              emb_size=16, early_stop=10, seed=5, save_emb=False,
              dropoutnet_hidden1=16, dropoutnet_hidden2=8)
# fp32 sums over the data group in another order: over 2 epochs (2x1 and
# 2x2 alike) the losses moved by up to 1.3e-7 relative, the eval tables by
# 3.1e-6, the bus tables by 3e-8, the compared tower weights by 1.7e-7 and
# the running statistics by 7.3e-6 (the running means follow the biases
# Adam walks on noise, which moved by 9.1e-5); the port's 2x2 against the
# JAX package's: losses 1.9e-7 relative, eval tables 8.3e-7
RTOL = 1e-5
ATOL = 1e-5
JOBS = {
    2: [("dn12", dict(mesh="1x2")), ("dn21", dict(mesh="2x1")),
        ("syncbn", {})],
    4: [("dn22", dict(mesh="2x2")),
        ("resume_a", dict(mesh="2x2", epochs=1,
                          state_ckpt="{tmp}/dn.ckpt")),
        ("resume_b", dict(mesh="2x2", state_ckpt="{tmp}/dn.ckpt"))],
    "jax": [("jax22", dict(mesh="2x2", epochs=1, jax_init="{tmp}/init.pkl",
                           masks="{tmp}/masks.npz"))],
}
RANKS = {2: 2, 4: 4, "jax": 4}


def _spec(tmp, name, jobs, emb_dir):
    spec = tmp / f"spec_{name}.json"
    spec.write_text(json.dumps({
        "kw": KW, "common": {**COMMON, "emb_dir": emb_dir}, "out": str(tmp),
        "jobs": [(job, {k: v.format(tmp=tmp) if isinstance(v, str) else v
                        for k, v in {"model": "DropoutNet", **kw}.items()})
                 for job, kw in jobs]}))
    return str(spec)


def _jax_masks(key, n, rate):
    """The JAX DropoutNet's pos and neg masks of the step with ``key``."""
    n_zero = int(n * rate)
    return np.stack([np.asarray(jnp.ones((n,)).at[jax.random.permutation(
        k, n)[:n_zero]].set(0.0)) for k in jax.random.split(key)])


def _jax_2x2(jd, emb_dir):
    """The JAX DropoutNet on a 2x2 mesh of CPU devices, 1 epoch: its
    initial (params, net_state), the trainer after its run, its per-batch
    losses and masks."""
    jm = jfactory(JConfig(jargs(**{**COMMON, "emb_dir": emb_dir,
                                   "mesh": "2x2", "epochs": 1}), jd))
    tree = jax.tree_util.tree_map(np.asarray, (jm.params, jm.net_state))
    losses, masks, step = [], [], jm._step

    def recording(*args):
        out = step(*args)
        losses.append(float(out[-1]))
        batch, key = args[-2], args[-1]
        masks.append(_jax_masks(key, batch["user"].shape[0], jm.n_dropout))
        return out

    jm._step = recording
    jm.run()
    return jm, tree, losses, masks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_dropoutnet")
    data = synthetic_dataset(**KW)[0]
    emb_dir = str(tmp / "emb")
    rng = np.random.default_rng(7)
    save_embeddings(emb_dir, "synth", "item", "MF", {
        "user_emb": rng.standard_normal((data.user_num, 16)).astype(
            np.float32) * 0.3,
        "item_emb": rng.standard_normal((data.item_num, 16)).astype(
            np.float32) * 0.3})
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]), "OMP_NUM_THREADS": "1"}
    child = [sys.executable, os.path.join(REPO, "tests",
                                          "torch_mesh_child.py")]
    futures = {}
    with concurrent.futures.ThreadPoolExecutor(len(JOBS)) as pool:
        for group in (2, 4):
            futures[group] = pool.submit(
                launch_ranks, child + [_spec(tmp, str(group), JOBS[group],
                                             emb_dir)],
                RANKS[group], 240, env)
        jm, tree, jlosses, jmasks = _jax_2x2(jsynth(**KW)[0], emb_dir)
        with open(tmp / "init.pkl", "wb") as f:
            pickle.dump(tree, f)
        np.savez(tmp / "masks.npz", masks=np.stack(jmasks))
        futures["jax"] = pool.submit(
            launch_ranks, child + [_spec(tmp, "jax", JOBS["jax"], emb_dir)],
            RANKS["jax"], 240, env)
        common = {**COMMON, "emb_dir": emb_dir}
        one = summary(run(data, common, {"model": "DropoutNet"}))
        one_sync = syncbn()
        for group, fut in futures.items():
            for rank, (code, out) in enumerate(fut.result()):
                assert code == 0, f"{group}, rank {rank}:\n{out[-3000:]}"
    ranks = {f"{name}/{r}": dict(np.load(tmp / f"{name}_rank{r}.npz"))
             for group, jobs in JOBS.items() for name, _ in jobs
             for r in range(RANKS[group])}
    return {"one": one, "sync": one_sync, "ranks": ranks, "data": data,
            "jax": (jm, jlosses, len(jmasks))}


def _same_metrics(a, b):
    for key in ("overall", "cold", "warm"):
        np.testing.assert_array_equal(a[key], b[key])


def test_model_axis_alone_is_bit_equal(runs):
    """1x2: the bus tables row-sharded over the model axis, the batch and
    its statistics whole on each rank: nothing differs from one rank."""
    one = runs["one"]
    data = runs["data"]
    for r in range(2):
        got = runs["ranks"][f"dn12/{r}"]
        assert got["table_shapes"].tolist() == [[data.user_num // 2, 16],
                                              [data.item_num // 2, 16]]
        for key in ("losses", "user_emb", "item_emb", "lists", "tables",
                    "towers", "bn", "masks"):
            np.testing.assert_array_equal(got[key], one[key], err_msg=key)
        _same_metrics(got, one)


def _hold_close(got, one, what):
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=RTOL,
                               err_msg=f"{what} losses")
    for key in ("user_emb", "item_emb", "tables", "towers_core", "bn"):
        np.testing.assert_allclose(got[key], one[key], rtol=0, atol=ATOL,
                                   err_msg=f"{what} {key}")


@pytest.mark.parametrize("name,n", [("dn21", 2), ("dn22", 4)])
def test_data_axis_matches_single_rank(runs, name, n):
    """2x1 and 2x2: the BatchNorm statistics over the global batch, each
    rank its block of the global masks, the loss parts summed over the
    data group."""
    one = runs["one"]
    for r in range(n):
        got = runs["ranks"][f"{name}/{r}"]
        _hold_close(got, one, f"{name} rank {r}")
        np.testing.assert_array_equal(got["masks"], one["masks"])
        # every rank's running statistics and towers are the same
        ref = runs["ranks"][f"{name}/0"]
        for key in ("bn", "towers", "tables", "user_emb", "item_emb"):
            np.testing.assert_array_equal(got[key], ref[key])


def test_syncbn_backward_matches_one_rank_autograd(runs):
    """The sync-BN forward and backward on 2 ranks (each a block of the
    global batch) against one rank's autograd of the whole batch: input
    gradients, scale and bias gradients (summed over the ranks) and the
    running statistics after two passes."""
    one = runs["sync"]
    ranks = [runs["ranks"][f"syncbn/{r}"] for r in range(2)]
    np.testing.assert_allclose(
        np.concatenate([g["x_grad"] for g in ranks]), one["x_grad"],
        rtol=1e-5, atol=1e-6)
    for key in ("scale_grad", "bias_grad"):
        np.testing.assert_allclose(sum(g[key] for g in ranks), one[key],
                                   rtol=1e-5, atol=1e-6)
    for g in ranks:
        np.testing.assert_array_equal(g["running"], ranks[0]["running"])
        np.testing.assert_allclose(g["running"], one["running"], rtol=1e-6,
                                   atol=1e-7)


def test_dp_tp_matches_jax_2x2(runs):
    """The port's 2x2 run and the JAX package's 2x2 run from the same
    weights on the same batches and masks, 1 epoch."""
    jm, jlosses, n_steps = runs["jax"]
    for r in range(4):
        got = runs["ranks"][f"jax22/{r}"]
        assert len(got["losses"]) == n_steps == len(got["masks"])
        np.testing.assert_allclose(got["losses"], jlosses, rtol=RTOL)
        np.testing.assert_allclose(got["user_emb"], np.asarray(jm.user_emb),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(got["item_emb"], np.asarray(jm.item_emb),
                                   rtol=0, atol=ATOL)
        jbn = np.concatenate([np.concatenate([np.asarray(s["mean"]),
                                              np.asarray(s["var"])])
                              for side in ("u", "v")
                              for s in jm.net_state[side]])
        np.testing.assert_allclose(got["bn"], jbn, rtol=0, atol=ATOL)
        jtables = np.concatenate([np.asarray(jm.params[k]).reshape(-1)
                                  for k in ("user_emb", "item_emb")])
        np.testing.assert_allclose(got["tables"], jtables, rtol=0, atol=ATOL)


def test_mesh_resume(runs):
    """A 2x2 run checkpointed after epoch 1 and resumed to epoch 2 equals
    the uninterrupted run, its bus tables sharded again on resume."""
    data = runs["data"]
    for r in range(4):
        resumed = runs["ranks"][f"resume_b/{r}"]
        full = runs["ranks"][f"dn22/{r}"]
        assert resumed["table_shapes"].tolist() == [[data.user_num // 2, 16],
                                                  [data.item_num // 2, 16]]
        np.testing.assert_array_equal(
            resumed["losses"], full["losses"][-len(resumed["losses"]):])
        for key in ("user_emb", "item_emb", "lists", "tables", "towers",
                    "bn"):
            np.testing.assert_array_equal(resumed[key], full[key],
                                          err_msg=key)
        _same_metrics(resumed, full)
