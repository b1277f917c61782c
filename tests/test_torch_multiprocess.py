"""The port's CLI and server on 2 real processes (gloo over localhost)
against one process, after ``tests/test_multiprocess.py``.

One module fixture writes a split through the port's splitter and starts,
all at once, three CLI runs as 2 ranks (``python -m coldrec_tpu_torch.main``
with the ``COLDREC_*`` variables, on the CPU) and a serving child as 2
ranks, while this process runs the same CLI flags alone. Held: every rank
exits cleanly; only rank 0 writes its result file (and the bus); the
metrics equal the one-process run's (MF with no ``--mesh``, data-parallel
over both ranks, through the plain eval route whose user chunks the ranks
split round robin; LightGCN ``--mesh 1x2`` through the kernel route); MF
``--mesh 1x2``'s bus bit-equal to one process's; the mesh
``RetrievalServer`` id-exact with the one-device server; and
``partition_chunks`` / ``allgather_host`` reassembling ``EvalSweep.run``'s
one-process lists.
"""
import concurrent.futures
import json
import os
import sys

import numpy as np
import pytest

from coldrec_tpu_torch import main as tmain
from coldrec_tpu_torch.config import make_args
from coldrec_tpu_torch.data.builder import ColdStartDataset
from coldrec_tpu_torch.data.split import cold_start_split, write_split_dir
from coldrec_tpu_torch.data.synthetic import synthetic_interactions
from coldrec_tpu_torch.parallel.distributed import launch_ranks
from coldrec_tpu_torch.runtime.checkpoints import load_embeddings
from coldrec_tpu_torch.runtime.eval import EvalSweep
from coldrec_tpu_torch.runtime.serving import RetrievalServer
from test_torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name: (model, flags, the ranks' mesh flags)
RUNS = {
    "mf_dp": ("MF", ("--eval_backend", "xla"), ()),
    "lightgcn_1x2": ("LightGCN", ("--layers", "2"), ("--mesh", "1x2")),
    "mf_bus": ("MF", ("--save_emb", "true"), ("--mesh", "1x2")),
}
TOL = {"mf_dp": 1e-9, "lightgcn_1x2": 1e-6, "mf_bus": 0.0}

SERVE_CHILD = r'''
import sys
import numpy as np
import torch
from coldrec_tpu_torch.data.builder import ColdStartDataset
from coldrec_tpu_torch.parallel.distributed import (
    init_distributed, partition_chunks, process_index, shutdown_distributed)
from coldrec_tpu_torch.parallel.mesh import make_mesh
from coldrec_tpu_torch.runtime.eval import EvalSweep, exact_scores
from coldrec_tpu_torch.runtime.serving import RetrievalServer

torch.set_num_threads(1)
init_distributed(device="cpu")
t = np.load(sys.argv[1])
srv = RetrievalServer(t["user_emb"], t["item_emb"],
                      exclude_items=np.arange(0, 112, 9), device="cpu",
                      mesh=make_mesh(1, 2))
v, i = srv.topk(np.arange(24), 10, exclude_rated=False)
data = ColdStartDataset.from_split_dir(sys.argv[3], "demo", "item")
ue = torch.as_tensor(t["sweep_user"])
ie = torch.as_tensor(t["sweep_item"])
sweep = EvalSweep(data, "item", 16, 20, device="cpu")
rec = sweep.run("overall_test", "all",
                lambda u: exact_scores(ue[torch.as_tensor(u).long()], ie))
mine = partition_chunks(int(t["n_chunks"]))
if process_index() == 0:
    np.savez(sys.argv[2], vals=v, ids=i, rec=rec,
             mine=np.asarray(mine[0]), pc=mine[1])
shutdown_distributed()
'''


def _cmd(ddir, result_file, model, extra=(), overwrite="true"):
    return [sys.executable, "-m", "coldrec_tpu_torch.main", "--model", model,
            "--dataset", "demo", "--cold_object", "item", "--data_dir", ddir,
            "--epochs", "2", "--bs", "256", "--emb_size", "16", "--seed",
            "11", "--runs", "1", "--save_emb", "false", "--result_file",
            result_file, "--result_overwrite", overwrite, "--device", "cpu",
            *extra]


def _payload(path):
    text = open(path, encoding="utf-8").read()
    return json.loads(text.split("--- JSON (machine-readable) ---", 1)[1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multiprocess")
    pairs = synthetic_interactions(150, 120, 3200, seed=41)
    res = cold_start_split(pairs, cold_object="item", seed=7)
    ddir = str(tmp / "data")
    write_split_dir(res, ddir, "demo", "item")
    rng = np.random.default_rng(23)
    np.save(os.path.join(ddir, "demo", "demo_item_content.npy"),
            rng.standard_normal((res.item_num, 12)).astype(np.float32))
    data = ColdStartDataset.from_split_dir(ddir, "demo", "item")
    tables = {"user_emb": rng.standard_normal((64, 16)).astype(np.float32),
              "item_emb": rng.standard_normal((112, 16)).astype(np.float32),
              "sweep_user": rng.standard_normal(
                  (data.user_num, 8)).astype(np.float32),
              "sweep_item": rng.standard_normal(
                  (data.item_num, 8)).astype(np.float32)}
    n_chunks = -(-data.eval_splits["overall_test"].users.shape[0] // 16)
    np.savez(tmp / "tables.npz", n_chunks=n_chunks, **tables)
    (tmp / "serve_child.py").write_text(SERVE_CHILD)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    futures = {}
    with concurrent.futures.ThreadPoolExecutor(len(RUNS) + 1) as pool:
        for name, (model, extra, mesh) in RUNS.items():
            # both ranks append to one file: a second writer would add a
            # second block
            rf = str(tmp / f"{name}.txt")
            extra = (*extra, *mesh, "--emb_dir", str(tmp / f"emb_{name}"))
            futures[name] = (rf, pool.submit(
                launch_ranks, _cmd(ddir, rf, model, extra, "false"), 2, 240,
                env, str(tmp)))
        futures["serve"] = (None, pool.submit(
            launch_ranks, [sys.executable, str(tmp / "serve_child.py"),
                           str(tmp / "tables.npz"), str(tmp / "served.npz"),
                           ddir], 2, 240, env, str(tmp)))
        one = {}
        for name, (model, extra, _) in RUNS.items():
            rf = str(tmp / f"{name}_one.txt")
            tmain.run(make_args(_cmd(ddir, rf, model, (
                *extra, "--emb_dir", str(tmp / f"emb_{name}_one")))[3:]))
            one[name] = _payload(rf)
        outs = {name: fut.result() for name, (_, fut) in futures.items()}
    for name, ranks in outs.items():
        for r, (code, out) in enumerate(ranks):
            assert code == 0, f"{name} rank {r}:\n{out[-3000:]}"
    return {"tmp": tmp, "data": data, "tables": tables, "one": one,
            "outs": outs, "files": {k: f for k, (f, _) in futures.items()}}


@pytest.mark.parametrize("name", list(RUNS))
def test_two_ranks_match_one_process(runs, name):
    path = runs["files"][name]
    # the rank-0 writer: both ranks appended to one file, which holds one
    # run's block
    text = open(path, encoding="utf-8").read()
    assert text.count("=== ColdRec Run Result ===") == 1
    for out in (o for _, o in runs["outs"][name]):
        assert "backend gloo (ranks on the CPU)" in out
    base, multi = runs["one"][name]["metrics"], _payload(path)["metrics"]
    for tn in base:
        for setting in base[tn]:
            for metric, v in base[tn][setting].items():
                mv = multi[tn][setting][metric]
                assert abs(mv["mean"] - v["mean"]) <= TOL[name], (
                    name, tn, setting, metric, v, mv)


def test_rank0_writes_the_bus_bit_equal(runs):
    tmp = runs["tmp"]
    bus = load_embeddings(str(tmp / "emb_mf_bus"), "demo", "item", "MF")
    ref = load_embeddings(str(tmp / "emb_mf_bus_one"), "demo", "item", "MF")
    for key in ("user_emb", "item_emb"):
        np.testing.assert_array_equal(bus[key], ref[key])
    assert sorted(os.listdir(tmp / "emb_mf_bus")) == [
        "demo_cold_item_MF_emb.npz"]


def test_mesh_server_is_id_exact(runs):
    t = runs["tables"]
    got = np.load(runs["tmp"] / "served.npz")
    srv = RetrievalServer(t["user_emb"], t["item_emb"],
                          exclude_items=np.arange(0, 112, 9), device="cpu")
    vals, ids = srv.topk(np.arange(24), 10, exclude_rated=False)
    np.testing.assert_array_equal(got["ids"], ids)
    np.testing.assert_allclose(got["vals"], vals, rtol=1e-6, atol=1e-6)


def test_partition_and_allgather_reassemble_the_lists(runs):
    import torch

    from coldrec_tpu_torch.runtime.eval import exact_scores

    got = np.load(runs["tmp"] / "served.npz")
    t = runs["tables"]
    n_chunks = -(-runs["data"].eval_splits["overall_test"].users.shape[0]
                 // 16)
    assert got["mine"].tolist() == list(range(0, n_chunks, 2))
    assert int(got["pc"]) == 2
    ue, ie = torch.as_tensor(t["sweep_user"]), torch.as_tensor(t["sweep_item"])
    sweep = EvalSweep(runs["data"], "item", 16, 20, device="cpu")
    rec = sweep.run("overall_test", "all",
                    lambda u: exact_scores(ue[torch.as_tensor(u).long()], ie))
    np.testing.assert_array_equal(got["rec"], rec)


def test_launch_ranks_stops_the_others_and_times_out():
    """A rank that fails stops the others at once (killed: -9); a group
    that passes its deadline is stopped and raises with its output."""
    import time

    code = ("import os, sys, time\n"
            "r = int(os.environ['COLDREC_PROCESS_ID'])\n"
            "print('rank', r, 'of', os.environ['COLDREC_NUM_PROCESSES'],\n"
            "      flush=True)\n"
            "sys.exit(3) if r == 1 else time.sleep(60)\n")
    t = time.monotonic()
    runs = launch_ranks([sys.executable, "-c", code], 2, timeout=50)
    assert time.monotonic() - t < 30
    assert [c for c, _ in runs] == [-9, 3]
    assert "rank 1 of 2" in runs[1][1]
    with pytest.raises(TimeoutError, match="rank 0 of 1"):
        launch_ranks([sys.executable, "-c", code], 1, timeout=2)
