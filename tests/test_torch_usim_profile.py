"""The port's USIM profile tool (``coldrec_tpu_torch/tools/profile_usim.py``,
for the JAX package's ``tools/profile_usim.py``, ``profile_usim_bx.py`` and
``usim_roofline.py``) on the CPU with a tiny trainer (set-up:
``test_torch_usim_models.py``): the phases, their order and their sum
against the step, the step itself unchanged by the split, the ``config``
block equal to the JAX USIM's on the same split, ``floor_fraction`` by the
JAX formulas, ``usim_bounds`` as before its move, the missing bus named,
and the tool's command line writing the JAX tool's keys."""
import json
import math

import numpy as np
import pytest
import torch

from test_torch_usim_models import (  # noqa: F401  (env is a fixture)
    NETS, env, make_pair, port_of,
)
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

from coldrec_tpu_torch.runtime.checkpoints import save_embeddings
from coldrec_tpu_torch.tools import profile_usim as pu
from coldrec_tpu_torch.tools import scale_run as sr

PHASES = ["hoisted top-ks", "rollouts", "ppo targets", "ppo 1", "ppo 2",
          "ppo 3", "ppo 4", "ppo 5", "termination", "inference chunk",
          "step"]
# tools/usim_roofline.py:312-358
JAX_KEYS = {
    "config": {"bs", "max_time", "n_user", "n_cold", "n_ppo", "infer_blk",
               "batches_per_epoch"},
    "stage_walls_ms": {"rollout", "target", "iters", "full"},
    "real_step_ms": None,
    "phases_ms_per_batch": {"rollout_and_overhead", "ppo_target_prep",
                            "ppo_5_iterations", "ppo_per_iteration"},
    "phase_share_of_step": {"rollout_and_overhead", "ppo_target_prep",
                            "ppo_5_iterations"},
    "inference_ms_per_epoch": None,
    "ceilings_ms": {"matmul_lse_rowreduce", "matmul_stream_topk"},
    "floor_fraction": {"rollout_and_overhead", "ppo_target_prep",
                       "ppo_5_iterations", "inference"},
    "epoch_accounting_s": {"train_phase", "inference", "total_excl_eval"},
    "consistency_check": {"sum_of_phases_ms", "full_stage_ms"},
    "methodology": None,
}


@pytest.fixture(scope="module")
def split(env):
    _, tm = make_pair(env)
    return tm, pu.usim_step_split(tm, blk=32)


def test_phase_names_and_order(split):
    _, out = split
    assert list(out) == PHASES
    assert all(out[k]["ms"] > 0 for k in PHASES[:-1])
    assert all(out[k]["bound_ms"] >= 0 for k in PHASES[:-1])


def test_phases_sum_to_the_step(split):
    """On the host clock the phases tile the step: their sum is its span
    from the first mark to the last, within the enqueue timed around it."""
    _, out = split
    total = sum(out[k]["ms"] for k in PHASES[:-2])
    step = out["step"]
    assert total == pytest.approx(step["ms"], rel=1e-12)
    assert total == pytest.approx(step["events_ms"], rel=1e-9)
    assert step["events_ms"] <= step["enqueue_ms"]


def test_report_groups_the_phases(split):
    tm, out = split
    ceil = {"matmul_lse_rowreduce": 0.5, "matmul_stream_topk": 2.0}
    r = pu.roofline(tm, out, ceil, 3.0, 1.0)
    for key, sub in JAX_KEYS.items():
        assert key in r, key
        if sub:
            assert sub <= set(r[key]), key
    ph = r["phases_ms_per_batch"]
    assert ph["rollout_and_overhead"] == (out["hoisted top-ks"]["ms"]
                                          + out["rollouts"]["ms"])
    assert ph["ppo_target_prep"] == out["ppo targets"]["ms"]
    assert ph["ppo_5_iterations"] == pytest.approx(
        sum(out[f"ppo {i}"]["ms"] for i in range(1, 6)), rel=1e-12)
    assert ph["ppo_per_iteration"] == pytest.approx(
        ph["ppo_5_iterations"] / 5, rel=1e-12)
    assert ph["termination"] == out["termination"]["ms"]
    assert r["device"] == {"name": "cpu", "power_limit": None}
    pu.hold_consistency(r)
    bad = {**r, "consistency_check": {"sum_of_phases_ms": 10.0,
                                      "full_stage_ms": 12.0}}
    with pytest.raises(AssertionError, match="phases sum to"):
        pu.hold_consistency(bad)


def test_tool_step_changes_nothing(env):
    """The weights after the tool's split step equal those after two plain
    ``train_step`` calls on the same batches and draws."""
    jm, tool = make_pair(env)
    plain = port_of(env, jm)
    plain.generator.set_state(tool.generator.get_state())
    pu.usim_step_split(tool, seed=0, blk=32)
    plain.host_rng = np.random.default_rng(0)
    batches = [plain.upload(b) for _, b in zip(range(2), plain.batches())]
    for b in batches:
        plain.train_step(b)
    for net in NETS:
        for (name, got), want in zip(
                getattr(tool.model, net).named_parameters(),
                getattr(plain.model, net).parameters()):
            assert torch.equal(got, want), (net, name)
    for opt in ("actor_opt", "critic_opt"):
        got = getattr(tool, opt).state_dict()["state"]
        want = getattr(plain, opt).state_dict()["state"]
        for i, s in want.items():
            for k, v in s.items():
                assert torch.equal(got[i][k], v), (opt, i, k)


def test_config_block_matches_jax(env):
    """The JAX tools' counts (``usim_roofline.py:313-315``) on the JAX
    USIM of the same split."""
    jm, tm = make_pair(env)
    want = {"bs": jm.batch_size, "max_time": jm.max_time,
            "n_user": jm.n_user, "n_cold": int(jm.cold_idx.shape[0]),
            "n_ppo": jm.n_ppo, "infer_blk": int(jm._infer_blk),
            "batches_per_epoch": int(np.ceil(np.unique(
                jm.data.train_pairs[:, 1]).shape[0] / jm.batch_size))}
    assert pu.config_block(tm) == want
    assert want["batches_per_epoch"] == len(list(tm.batches()))


@pytest.mark.parametrize("times", [(900.0, 100.0, 2800.0, 700.0),
                                   (0.0, 100.0, 2800.0, 700.0)])
def test_floor_fraction_follows_the_jax_formulas(times):
    """``usim_roofline.py:296-310`` written out again, against the tool."""
    t_roll, t_target, t_ppo5, best_inf = times
    config = {"bs": 4096, "max_time": 7, "n_user": 92108, "n_cold": 54034,
              "n_ppo": 5, "infer_blk": 4096, "batches_per_epoch": 53}
    t_mm_lse, t_mm_topk = 4.16, 26.03
    mt, B, blk = 7, 4096, 4096
    n_chunks = 3 * mt
    roll_floor = 3 * mt * (2 * t_mm_lse + t_mm_topk) + 2 * t_mm_topk
    target_floor = n_chunks * t_mm_lse
    ppo5_floor = 5 * n_chunks * 3 * t_mm_lse
    inf_floor = (int(np.ceil(54034 / blk)) * mt * t_mm_lse * (blk / B))

    def frac(floor, got):
        return round(floor / got, 3) if got > 0 else None

    got = pu.floor_fraction(
        config, {"rollout_and_overhead": t_roll, "ppo_target_prep": t_target,
                 "ppo_5_iterations": t_ppo5},
        {"matmul_lse_rowreduce": t_mm_lse, "matmul_stream_topk": t_mm_topk},
        best_inf)
    assert got == {"rollout_and_overhead": frac(roll_floor, t_roll),
                   "ppo_target_prep": frac(target_floor, t_target),
                   "ppo_5_iterations": frac(ppo5_floor, t_ppo5),
                   "inference": frac(inf_floor, best_inf)}


def test_usim_bounds_unchanged_by_the_move():
    """The bounds at book-crossing scale (bs 4096, 92,108 actions, d=64,
    max_time 7, 5 PPO iterations, 4096-item chunk) as ``chip_smoke.py``
    printed them before the move."""
    b = pu.usim_bounds(92_108, 64, 4096, 7, 5, 4096)
    assert list(b) == PHASES[:-1]
    ms = {k: round(v["bound_ms"], 3) for k, v in b.items()}
    assert ms == {"hoisted top-ks": 1.802, "rollouts": 37.840,
                  "ppo targets": 18.920, "ppo 1": 37.840, "ppo 2": 37.840,
                  "ppo 3": 37.840, "ppo 4": 37.840, "ppo 5": 37.840,
                  "termination": 0.0, "inference chunk": 6.307}
    step = sum(v["bound_ms"] for k, v in b.items() if k != "inference chunk")
    assert round(step, 3) == 247.762
    assert {v["bound_by"] for v in b.values()} == {"bytes", "operations"}
    assert b["rollouts"]["flops"] == 42 * 2.0 * 4096 * 92_108 * 64
    assert b["ppo 1"]["bytes"] == 4 * 4.0 * 3 * 7 * 4096 * 92_108


def test_missing_bus_names_the_command(tmp_path):
    with pytest.raises(FileNotFoundError,
                       match="coldrec_tpu_torch.tools.scale_run --shape bx "
                             "--model MF"):
        pu.build_trainer(str(tmp_path), "cpu")


def test_command_line_writes_the_jax_keys(tmp_path, monkeypatch, capsys):
    """The whole tool on a tiny split written under the name ``bx``, with a
    random MF bus: the card's name first, the epoch's and the step's
    reports, the JSON at ``--out`` with the JAX tool's keys."""
    monkeypatch.setitem(sr.SHAPES, "bx", dict(n_users=120, n_items=160,
                                              n_inter=2000, content_dim=12))
    work = tmp_path / "bx_workdir"
    sr.build_dataset(str(work), "bx")
    rng = np.random.default_rng(0)
    save_embeddings(str(work / "emb"), "bx", "item", "MF", {
        "user_emb": rng.standard_normal((120, 64), np.float32) * 0.1,
        "item_emb": rng.standard_normal((160, 64), np.float32) * 0.1})
    monkeypatch.setattr(pu, "CEILING_ITERS", 2)
    out = tmp_path / "roofline.json"
    capsys.readouterr()
    report = pu.main(["--workdir", str(work), "--device", "cpu", "--bs",
                      "32", "--batches", "1", "--reps", "2", "--out",
                      str(out)])
    printed = capsys.readouterr().out
    assert printed.splitlines()[0] == "device: cpu"
    for line in ("init (incl first _eval_tables)", "train batch 1:",
                 "steady train batch:", "_eval_tables rep 1:",
                 "validation sweep:", "USIM step split at bs 32",
                 "ceilings: matmul + logsumexp", "consistency: phases sum"):
        assert line in printed, line
    saved = json.loads(out.read_text())
    assert saved == json.loads(json.dumps(report))
    for key, sub in JAX_KEYS.items():
        assert key in saved and (not sub or sub <= set(saved[key])), key
    assert saved["config"]["bs"] == 32
    assert saved["config"]["batches_per_epoch"] == math.ceil(
        len(np.unique(np.loadtxt(work / "data" / "bx" / "cold_item"
                                 / "warm_train.csv", delimiter=",",
                                 skiprows=1, dtype=np.int64)[:, 1])) / 32)
    assert saved["epoch"]["launches"] == {"fused_sweep": 0,
                                          "fused_sweep_bf16": 0,
                                          "merge_parts": 0}
