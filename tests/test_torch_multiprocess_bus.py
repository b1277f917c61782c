"""The MF -> DropoutNet bus pipeline with both stages on 2 real processes
(gloo over localhost, the port's CLI with the ``COLDREC_*`` variables, on
the CPU) against the same pipeline in one process: the counterpart of
``tests/test_multiprocess.py::test_bus_handoff_two_processes``, on its
split, content, seed and flags.

Held: every rank exits cleanly; rank 0 alone writes each stage's result
file and the MF bus; the cold stage loads that bus in every rank
(DropoutNet data-parallel over both ranks: its BatchNorm statistics and
masks over the global batch); the final metrics within the JAX test's
``TOL`` of the one-process pipeline's, and the MF stage's within 1e-6.
"""
import concurrent.futures
import json
import os
import sys

import numpy as np
import pytest

from coldrec_tpu_torch import main as tmain
from coldrec_tpu_torch.config import make_args
from coldrec_tpu_torch.data.split import cold_start_split, write_split_dir
from coldrec_tpu_torch.data.synthetic import synthetic_interactions
from coldrec_tpu_torch.parallel.distributed import launch_ranks
from test_torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_multiprocess.py: two compounding stages of data-parallel sums
# in another order (the backbone's gradients, the BatchNorm statistics);
# the port's gap here read 7e-5
TOL = 2e-3
MF_TOL = 1e-6
DN = ("--save_emb", "false")


def _cmd(ddir, emb, result_file, model, extra=()):
    return [sys.executable, "-m", "coldrec_tpu_torch.main", "--model", model,
            "--dataset", "demo", "--cold_object", "item", "--data_dir", ddir,
            "--emb_dir", emb, "--epochs", "2", "--bs", "256", "--emb_size",
            "16", "--seed", "11", "--runs", "1", "--result_file",
            result_file, "--result_overwrite", "false", "--device", "cpu",
            *extra]


def _payload(path):
    text = open(path, encoding="utf-8").read()
    assert text.count("=== ColdRec Run Result ===") == 1
    return json.loads(text.split("--- JSON (machine-readable) ---", 1)[1])


def _gap(a, b):
    return max(abs(a[tn][s][m]["mean"] - b[tn][s][m]["mean"])
               for tn in a for s in a[tn] for m in a[tn][s])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multiprocess_bus")
    pairs = synthetic_interactions(150, 120, 3200, seed=41)
    res = cold_start_split(pairs, cold_object="item", seed=7)
    ddir = str(tmp / "data")
    write_split_dir(res, ddir, "demo", "item")
    np.save(os.path.join(ddir, "demo", "demo_item_content.npy"),
            np.random.default_rng(3).standard_normal(
                (res.item_num, 12)).astype(np.float32))
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    emb_ranks, emb_one = str(tmp / "emb_ranks"), str(tmp / "emb_one")
    files = {k: str(tmp / f"{k}.txt") for k in
             ("mf_ranks", "dn_ranks", "mf_one", "dn_one")}

    def ranks():
        out = [launch_ranks(_cmd(ddir, emb_ranks, files["mf_ranks"], "MF",
                                 ("--save_emb", "true")), 2, 240, env,
                            str(tmp))]
        bus = sorted(os.listdir(emb_ranks))
        out.append(launch_ranks(_cmd(ddir, emb_ranks, files["dn_ranks"],
                                     "DropoutNet", DN), 2, 240, env,
                                str(tmp)))
        return out, bus

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(ranks)
        tmain.run(make_args(_cmd(ddir, emb_one, files["mf_one"], "MF",
                                 ("--save_emb", "true"))[3:]))
        tmain.run(make_args(_cmd(ddir, emb_one, files["dn_one"],
                                 "DropoutNet", DN)[3:]))
        stages, bus = fut.result()
    for stage, outs in zip(("MF", "DropoutNet"), stages):
        for r, (code, out) in enumerate(outs):
            assert code == 0, f"{stage} rank {r}:\n{out[-3000:]}"
            assert "backend gloo (ranks on the CPU)" in out
    return {"files": files, "bus": bus}


def test_rank0_writes_the_bus_and_results(runs):
    assert runs["bus"] == ["demo_cold_item_MF_emb.npz"]
    for key in ("mf_ranks", "dn_ranks"):
        _payload(runs["files"][key])  # one block: rank 0 alone wrote


def test_pipeline_metrics_match_one_process(runs):
    files = runs["files"]
    assert _gap(_payload(files["mf_ranks"])["metrics"],
                _payload(files["mf_one"])["metrics"]) <= MF_TOL
    assert _gap(_payload(files["dn_ranks"])["metrics"],
                _payload(files["dn_one"])["metrics"]) <= TOL
