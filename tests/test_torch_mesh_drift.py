"""``coldrec_tpu_torch/tools/mesh_drift.py`` at the configuration of
``tests/test_torch_multiprocess_bus.py``: DropoutNet on 2 gloo ranks (``2x1``,
its BatchNorm statistics and masks over the global batch) against one rank,
in float64, where summation order moves a loss by float64's rounding only.

Held: every loss within FLOAT64_RTOL relative of one rank's, the running
statistics within FLOAT64_ATOL, the test metrics equal; the same of
XSimGCL on 4 ranks (``2x2``, ``--model``) and of GoRec on MF's bus
(``2x1``); the trainer carries no float32
weight after ``as_float64`` and its eval tables are float32 (the retrieval
kernel's type).
"""
import numpy as np
import pytest
import torch

from coldrec_tpu_torch.config import make_args
from coldrec_tpu_torch.models import model_factory
from coldrec_tpu_torch.runtime.trainer import Config
from coldrec_tpu_torch.tools import mesh_drift
from test_torch_threads import torch_threads  # noqa: F401

# float64 sums in another order over 16 steps read 3.1e-16 (losses) and 6.5e-14
# (running statistics) at this configuration
FLOAT64_RTOL = 1e-12
FLOAT64_ATOL = 1e-12


def test_float64_data_axis_matches_one_rank(tmp_path):
    cfg = mesh_drift.CONFIGS["bus"]
    root = str(tmp_path)
    mesh_drift.write_inputs(cfg, root, "cpu")
    argv = mesh_drift.cli_flags("DropoutNet", root, cfg["flags"], "cpu")
    res = mesh_drift.drift(argv, cfg["mesh"], ["float64"], root,
                           timeout=240)["float64"]
    assert res["steps"] == 16
    assert max(res["loss_rel_gap_up_to"].values()) <= FLOAT64_RTOL, res
    assert res["bn_abs_gap"] <= FLOAT64_ATOL, res
    assert res["metrics_abs_gap"] == 0.0, res


@pytest.mark.parametrize("model", ["XSimGCL"])
def test_float64_graph_model_2x2_matches_one_rank(tmp_path, model):
    """``--model``: the sign-taking noise of XSimGCL on a 2x2 mesh (sharded
    SpMM, global InfoNCE) against one rank in float64 on the same split:
    no element near 0 flips at float64's rounding, so the runs stay
    together."""
    cfg = mesh_drift.CONFIGS["bus"]
    root = str(tmp_path)
    flags, *_ = mesh_drift.MODELS[model]
    mesh_drift.write_inputs(cfg, root, "cpu", bus=False)
    argv = mesh_drift.cli_flags(model, root, cfg["flags"] + flags, "cpu")
    res = mesh_drift.drift(argv, "2x2", ["float64"], root,
                           timeout=240)["float64"]
    assert res["steps"] == 16
    assert max(res["loss_rel_gap_up_to"].values()) <= FLOAT64_RTOL, res
    assert res["metrics_abs_gap"] == 0.0, res


def test_float64_cold_model_matches_one_rank(tmp_path):
    """``--model GoRec`` on MF's bus (``ON_THE_BUS``), ``2x1``: its two
    BatchNorms and its uniformity over the global batch, its draws the
    global batch's, against one rank in float64 (its backbone tables, a
    dict of the trainer, converted too)."""
    cfg = mesh_drift.CONFIGS["bus"]
    root = str(tmp_path)
    assert "GoRec" in mesh_drift.ON_THE_BUS
    mesh_drift.write_inputs(cfg, root, "cpu")
    argv = mesh_drift.cli_flags("GoRec", root, cfg["flags"], "cpu")
    res = mesh_drift.drift(argv, cfg["mesh"], ["float64"], root,
                           timeout=240)["float64"]
    assert res["steps"] == 16
    assert max(res["loss_rel_gap_up_to"].values()) <= FLOAT64_RTOL, res
    assert res["bn_abs_gap"] <= FLOAT64_ATOL, res
    assert res["metrics_abs_gap"] == 0.0, res


def test_as_float64_converts_weights_and_keeps_float32_tables(tmp_path):
    cfg = mesh_drift.CONFIGS["bus"]
    root = str(tmp_path)
    mesh_drift.write_inputs(cfg, root, "cpu")
    t = model_factory(Config(make_args(mesh_drift.cli_flags(
        "DropoutNet", root, cfg["flags"], "cpu"))))
    mesh_drift.as_float64(t)
    mesh_drift.float32_tables(t)
    assert {p.dtype for p in t.model.parameters()} == {torch.float64}
    assert t.content.dtype == torch.float64
    for table in (t.user_emb, t.item_emb, t.best_user_emb, t.best_item_emb):
        assert table.dtype == torch.float32
    assert np.isfinite(t.user_emb.numpy()).all()
