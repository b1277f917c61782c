"""CGRC on ``--mesh DxM`` and on a process group in the port, on real gloo
ranks, against one rank: the port's counterpart of
``tests/test_mesh_training.py::test_cgrc_graph_cold_model_under_mesh``.

One module fixture starts ``tests/torch_mesh_child.py`` as 2 ranks (CGRC at
``1x2``, at ``2x1`` and on the group with no ``--mesh``) and as 4 ranks
(``2x2``) on the item-cold synthetic split with its content; this process
runs the one-rank baseline meanwhile. Every run draws the same simulated
cold items, sampled edges and extra items (the generators share one
state), so the ranks compute one rank's loss: L_E over their block of the
sampled edges, L_R over their block of the batch against B of the global
batch, every propagation on the gathered user table.

Held, every rank: the user table row-sharded over the model axis (local
height user_num / M), the item projection and the edge MLP whole; the
per-batch losses within ``LOSS_RTOL`` of one rank's, the eval tables (Ĝ
built from the top-k users of every rank's gathered table) within
``TABLE_ATOL``, the test metrics and test lists equal; the replicated
weights the same on every rank and within ``TABLE_ATOL`` of one rank's,
but the edge MLP's output bias, whose exact gradient is 0 (Adam walks it
on rounding noise, as ``ZERO_GRADIENT`` in ``test_torch_recon_models.py``
says). Tolerances no looser than the JAX test's 5e-5.
"""
import concurrent.futures
import json
import os
import sys

import numpy as np
import pytest

from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from coldrec_tpu_torch.parallel.distributed import launch_ranks
from test_torch_threads import torch_threads  # noqa: F401
from torch_mesh_child import run, summary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# user_num 96: the user table shards over a model axis of 2
KW = dict(n_users=96, n_items=80, n_inter=1800, cold_object="item", seed=91)
COMMON = dict(dataset="synth", epochs=2, bs=256, emb_size=16, early_stop=10,
              seed=5, save_emb=False)
# fp32 sums in another order: over 2 epochs the losses read <= 2.3e-7
# relative and the eval tables <= 1.2e-7 from one rank's
LOSS_RTOL = 1e-5
TABLE_ATOL = 5e-6
RUNS = {"1x2": 2, "2x1": 2, "group": 2, "2x2": 4}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cgrc")
    jobs = {n: [(f"cgrc{k}", {"model": "CGRC",
                              "mesh": "" if k == "group" else k})
                for k, size in RUNS.items() if size == n] for n in (2, 4)}
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
        data = synthetic_dataset(**KW)[0]
        one = summary(run(data, COMMON, {"model": "CGRC"}))
        for n in jobs:
            for rank, (code, out) in enumerate(futures[n].result()):
                assert code == 0, f"{n} ranks, rank {rank}:\n{out[-3000:]}"
    ranks = {f"{name}/{r}": dict(np.load(tmp / f"{name}_rank{r}.npz"))
             for n, group in jobs.items() for name, _ in group
             for r in range(n)}
    return {"one": one, "ranks": ranks, "data": data}


@pytest.mark.parametrize("mesh", list(RUNS))
def test_cgrc_mesh_matches_one_rank(runs, mesh):
    data, one = runs["data"], runs["one"]
    n_model = 1 if mesh == "group" else int(mesh.split("x")[1])
    for r in range(RUNS[mesh]):
        got = runs["ranks"][f"cgrc{mesh}/{r}"]
        # user_emb row-sharded; item_lin and the edge MLP whole
        shapes = got["shapes"].tolist()
        assert shapes[0] == [data.user_num // n_model, 16]
        assert shapes[1:] == one["shapes"].tolist()[1:]
        np.testing.assert_allclose(got["losses"], one["losses"],
                                   rtol=LOSS_RTOL)
        for key in ("user_emb", "item_emb"):
            np.testing.assert_allclose(got[key], one[key], atol=TABLE_ATOL)
        for key in ("overall", "cold", "warm", "lists"):
            np.testing.assert_array_equal(got[key], one[key])


@pytest.mark.parametrize("mesh", list(RUNS))
def test_cgrc_replicated_weights_agree(runs, mesh):
    """item_lin and the edge MLP (but its output bias): the same on every
    rank, and within ``TABLE_ATOL`` of one rank's."""
    first = runs["ranks"][f"cgrc{mesh}/0"]["weights"]
    for r in range(1, RUNS[mesh]):
        np.testing.assert_array_equal(
            runs["ranks"][f"cgrc{mesh}/{r}"]["weights"], first)
    np.testing.assert_allclose(first, runs["one"]["weights"],
                               atol=TABLE_ATOL)
