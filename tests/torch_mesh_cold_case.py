"""The shared case of the cold models' mesh tests
(``test_torch_mesh_cold.py``, ``test_torch_mesh_content.py``,
``test_torch_mesh_knn.py``, ``test_torch_mesh_cold_draws.py``): each of
the eleven models that the JAX package trains on its mesh (GAR,
DeepMusic, DUIF, Heater, AGNN, MetaEmbedding, LARA, GoRec, KNN, CLCRec,
CCFCRec) on real gloo ranks of the port, against one rank and against the
JAX package's ``2x2`` run.

:func:`mesh_runs` writes random MF tables on the bus (the size of
``tests/test_mesh_training.py``: 96 users x 80 items, item cold, d = 16)
and starts ``tests/torch_mesh_child.py`` as 2 ranks (each case at ``1x2``,
at ``2x1`` and on the group with no ``--mesh``) and as 4 ranks (``2x2``), every run of a group one after
another in the same processes. Meanwhile this process runs each case's
JAX trainer on a 2x2 mesh of CPU devices for 1 epoch, recording its losses
and, where its loss draws from ``jax.random`` (AGNN, CLCRec, GoRec), the
global draws of every step; a third group of 4 ranks, started beside the
others, runs the port's ``2x2`` from each JAX trainer's initial weights,
with those draws injected, as soon as they are written.
The one-rank baselines run here on one thread, as the ranks do (torch's
CPU scatter-adds on several threads may add in another order from run to
run).
"""
import concurrent.futures
import contextlib
import json
import os
import pickle
import sys

import jax
import numpy as np
import torch

from coldrec_tpu.config import default_args as jargs
from coldrec_tpu.data.synthetic import synthetic_dataset as jsynth
from coldrec_tpu.models import model_factory as jfactory
from coldrec_tpu.runtime.trainer import Config as JConfig
from coldrec_tpu_torch.config import default_args
from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from coldrec_tpu_torch.parallel.distributed import launch_ranks
from coldrec_tpu_torch.runtime.checkpoints import save_embeddings
from torch_mesh_child import run, summary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# user_num 96 and item_num 80: both tables shard over a model axis of 2
KW = dict(n_users=96, n_items=80, n_inter=1800, cold_object="item", seed=91)
D = 16
COMMON = dict(dataset="synth", epochs=2, bs=256, emb_size=D, early_stop=10,
              seed=5, save_emb=False)
# narrow widths for the CPU; GoRec's content dropout on, to hold its mask
SMALL = dict(num_neg=8, pre_cluster_num=8, dropout=0.2, agnn_knn_k=4)
# case: model flags
CASES = {
    "GAR": {"model": "GAR"},
    "DeepMusic": {"model": "DeepMusic"},
    "DUIF": {"model": "DUIF"},
    "Heater": {"model": "Heater"},
    "MetaEmbedding": {"model": "MetaEmbedding"},
    "KNN": {"model": "KNN"},
    "KNN_LightGCN": {"model": "KNN", "backbone": "LightGCN", "layers": 2},
    "LARA": {"model": "LARA"},
    "CCFCRec": {"model": "CCFCRec"},
    "AGNN": {"model": "AGNN"},
    "CLCRec": {"model": "CLCRec"},
    "GoRec": {"model": "GoRec"},
}
# the row-sharded tables of each case on a model axis of 2 (the JAX rule;
# the others keep their backbone outside their parameters)
SHARDED = {case: ["item_emb", "user_emb"] for case in CASES}
SHARDED.update({"DeepMusic": [], "Heater": [], "MetaEmbedding": [],
                "GoRec": [], "CCFCRec": ["item_embedding", "user_embedding"]})
# float32 sums over the data group in another order: over 2 epochs the
# losses read <= 4.1e-7 relative and the eval tables <= 1.2e-7 from one
# rank's; the port's 2x2 against the JAX package's 2x2 (one epoch) <= 1.2e-6
# and 2.4e-7 (the limits of tests/test_torch_mesh_dropoutnet.py)
RTOL = 1e-5
ATOL = 1e-5
DRAWN = ("AGNN", "CLCRec", "GoRec")  # their loss draws from jax.random


def flags(case: str) -> dict:
    """The case's model flags and its own flags of ``SMALL``."""
    kw = CASES[case]
    own = default_args(model=kw["model"]).__dict__
    return {**{k: v for k, v in SMALL.items() if k in own}, **kw}


def _jax_draws(case, key, n, args, content_dim):
    """The global draws of the JAX loss of ``case`` at ``key`` over a batch
    of ``n`` rows (the derivations of ``coldrec_tpu/models``' losses)."""
    if case == "AGNN":
        keys = jax.random.split(key, 5)
        keep = 1.0 - float(args.agnn_dropout)
        return {"masks": np.stack([np.asarray(jax.random.bernoulli(
                    k, keep, (n, 2 * D))) for k in keys[:4]]),
                "normal": np.asarray(jax.random.normal(keys[4], (n, D)))}
    if case == "GoRec":
        k1, k2, k3 = jax.random.split(key, 3)
        return {"z": np.asarray(jax.random.normal(k1, (n, D))),
                "zgc": np.asarray(jax.random.normal(k2, (n, D))),
                "keep": np.asarray(jax.random.bernoulli(
                    k3, 1.0 - float(args.dropout), (n, content_dim)))}
    flat = n * (1 + int(args.num_neg))
    return {"rand_index": np.asarray(jax.random.randint(
        key, (int(flat * float(args.num_sample)),), 0, flat))}


def jax_2x2(case, jd, emb_dir):
    """The JAX trainer of ``case`` on a 2x2 mesh of CPU devices, 1 epoch:
    its initial (params, net_state or None), the trainer after its run, its
    per-batch losses and (``DRAWN``) its global draws stacked by step."""
    args = jargs(**{**COMMON, **flags(case), "emb_dir": emb_dir,
                    "mesh": "2x2", "epochs": 1})
    jm = jfactory(JConfig(args, jd))
    state = jm.net_state if jm.stateful else None
    tree = jax.tree_util.tree_map(np.asarray, (jm.params, state))
    losses, draws, step = [], [], jm._step

    def recording(*a):
        out = step(*a)
        losses.append(float(out[-1]))
        if case in DRAWN:
            draws.append(_jax_draws(case, a[-1], a[-2]["user"].shape[0],
                                    args, jd.item_content.shape[1]))
        return out

    jm._step = recording
    jm.run()
    stacked = ({k: np.stack([d[k] for d in draws]) for k in draws[0]}
               if draws else None)
    return tree, jm, losses, stacked


@contextlib.contextmanager
def one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(was)


def _spec(tmp, name, jobs, emb_dir):
    spec = tmp / f"spec_{name}.json"
    spec.write_text(json.dumps({"kw": KW, "common": {**COMMON,
                                                     "emb_dir": emb_dir},
                                "out": str(tmp), "jobs": jobs}))
    return str(spec)


def mesh_runs(tmp, cases, extra=None):
    """Every run of ``cases`` (and the jobs ``extra[n]`` added to the group
    of ``n`` ranks): {"one": case -> one-rank summary, "ranks": "job/rank"
    -> summary, "jax": case -> (trainer, losses), "data", "emb_dir"}. A
    rank job is named ``<case>@<mesh>`` (``group``: no ``--mesh``), the
    runs from the JAX weights ``<case>@jax``."""
    data = synthetic_dataset(**KW)[0]
    emb_dir = str(tmp / "emb")
    rng = np.random.default_rng(7)
    save_embeddings(emb_dir, "synth", "item", "MF", {
        "user_emb": rng.standard_normal((data.user_num, D)).astype(
            np.float32) * 0.3,
        "item_emb": rng.standard_normal((data.item_num, D)).astype(
            np.float32) * 0.3})
    extra = extra or {}
    jobs = {2: [(f"{c}@{mesh}", {**flags(c), "mesh": "" if mesh == "group"
                                  else mesh})
                for c in cases for mesh in ("1x2", "2x1", "group")]
            + extra.get(2, []),
            4: [(f"{c}@2x2", {**flags(c), "mesh": "2x2"}) for c in cases]
            + extra.get(4, [])}
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]), "OMP_NUM_THREADS": "1"}
    child = [sys.executable, os.path.join(REPO, "tests",
                                          "torch_mesh_child.py")]
    jobs["jax"] = []
    for c in cases:
        kw = {**flags(c), "mesh": "2x2", "epochs": 1,
              "jax_init": str(tmp / f"init_{c}.pkl")}
        if c in DRAWN:
            kw["draws"] = str(tmp / f"draws_{c}.npz")
        jobs["jax"].append((f"{c}@jax", kw))
    futures = {}
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        # the third group starts at once and waits for each JAX run's
        # weights, written below (draws first, the weights last, whole)
        for group, n in ((2, 2), (4, 4), ("jax", 4)):
            futures[group] = pool.submit(launch_ranks, child + [_spec(
                tmp, str(group), jobs[group], emb_dir)], n, 240, env)
        jd = jsynth(**KW)[0]
        jaxed = {}
        for c, (_, kw) in zip(cases, jobs["jax"]):
            tree, jm, losses, draws = jax_2x2(c, jd, emb_dir)
            jaxed[c] = (jm, losses)
            if draws is not None:
                np.savez(kw["draws"], **draws)
            with open(kw["jax_init"] + ".part", "wb") as f:
                pickle.dump(tree, f)
            os.replace(kw["jax_init"] + ".part", kw["jax_init"])
        common = {**COMMON, "emb_dir": emb_dir}
        with one_thread():
            one = {c: summary(run(data, common, flags(c))) for c in cases}
        for group, fut in futures.items():
            for rank, (code, out) in enumerate(fut.result()):
                assert code == 0, f"{group}, rank {rank}:\n{out[-3000:]}"
    ranks = {f"{name}/{r}": dict(np.load(tmp / f"{name}_rank{r}.npz"))
             for group, js in jobs.items() for name, _ in js
             for r in range(2 if group == 2 else 4)}
    return {"one": one, "ranks": ranks, "jax": jaxed, "data": data,
            "emb_dir": emb_dir}


def meshes(cases):
    """(case, mesh, ranks) of every rank run of ``cases``."""
    return [(c, mesh, n) for c in cases
            for mesh, n in (("1x2", 2), ("2x1", 2), ("group", 2), ("2x2", 4))]


def check_sharding(got, case, mesh, one, data):
    """The row-sharded tables of a rank: the JAX rule's, each holding 1/M
    of its rows; every other parameter whole."""
    n_model = 1 if mesh == "group" else int(mesh.split("x")[1])
    want = SHARDED[case] if n_model > 1 else []
    assert got["sharded"].tolist() == want, (case, mesh)
    shapes, full = got["shapes"].tolist(), one["shapes"].tolist()
    assert len(shapes) == len(full)
    cut = [(s, f) for s, f in zip(shapes, full) if s != f]
    assert len(cut) == len(want), (case, mesh, cut)
    for s, f in cut:
        assert f[0] in (data.user_num, data.item_num)
        assert s == [f[0] // n_model, f[1]]


def check_bit_equal(got, one, what):
    """A model axis alone (1x2): nothing differs from one rank."""
    for key in ("losses", "user_emb", "item_emb", "lists", "overall", "cold",
                "warm"):
        np.testing.assert_array_equal(got[key], one[key],
                                      err_msg=f"{what} {key}")


def check_close(got, one, what):
    """A data axis: the one-rank run within ``RTOL`` / ``ATOL``."""
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=RTOL,
                               err_msg=f"{what} losses")
    for key in ("user_emb", "item_emb"):
        np.testing.assert_allclose(got[key], one[key], rtol=0, atol=ATOL,
                                   err_msg=f"{what} {key}")


def check_mesh(runs, case, mesh, n):
    """Every rank of ``case`` on ``mesh``: its sharding, and bit-equal to
    one rank on 1x2, within ``RTOL`` / ``ATOL`` with a data axis; every
    rank of a group alike."""
    one, data = runs["one"][case], runs["data"]
    first = runs["ranks"][f"{case}@{mesh}/0"]
    for r in range(n):
        got = runs["ranks"][f"{case}@{mesh}/{r}"]
        check_sharding(got, case, mesh, one, data)
        if mesh == "1x2":
            check_bit_equal(got, one, f"{case} {mesh} rank {r}")
        else:
            check_close(got, one, f"{case} {mesh} rank {r}")
        for key in ("losses", "user_emb", "item_emb", "lists"):
            np.testing.assert_array_equal(got[key], first[key])


def check_jax(runs, case):
    """The port's 2x2 run from the JAX trainer's weights (and draws)
    against the JAX package's 2x2 run, 1 epoch."""
    jm, jlosses = runs["jax"][case]
    for r in range(4):
        got = runs["ranks"][f"{case}@jax/{r}"]
        assert len(got["losses"]) == len(jlosses) > 0
        np.testing.assert_allclose(got["losses"], jlosses, rtol=RTOL)
        np.testing.assert_allclose(got["user_emb"], np.asarray(jm.user_emb),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(got["item_emb"], np.asarray(jm.item_emb),
                                   rtol=0, atol=ATOL)
