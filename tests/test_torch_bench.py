"""The port's bench entry (``coldrec_tpu_torch/bench.py``) and its shared
card timing (``coldrec_tpu_torch/utils/timing.py``) on the CPU.

The problem arrays are bit-identical to the JAX ``bench.py``'s for the same
seeds; the entry prints one JSON line whose device figures are ``null``
off the card; its sweep's lists equal the JAX package's ``masked_topk`` on
the same arrays; the functions that only the card times in the line run
here at toy shapes on the host clock.
"""
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from coldrec_tpu.runtime.eval import masked_topk as jmasked_topk
from coldrec_tpu_torch import bench as tbench
from coldrec_tpu_torch.utils import timing
from test_torch_threads import THREADS, torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
# every key of the line; the device figures are null off the card
DEVICE_FIGURES = (
    "value", "vs_baseline", "baseline_std_frac", "sweep_bound_pairs_per_sec",
    "movielens_scale_pairs_per_sec",
    "movielens_scale_plain_path_pairs_per_sec",
    "sweep_flop_share_of_fp32_peak", "bf16_sweep_pairs_per_sec",
    "bf16_sweep_bound_pairs_per_sec", "bf16_sweep_flop_share_of_bf16_peak",
    "mf_fused_train_step_ms", "mf_train_pairs_per_sec", "train_vs_baseline",
    "train_baseline_std_frac", "lightgcn_ell_spmm_ms_bc",
    "spmm_achieved_gbps", "stream_gbps_measured",
    "gather_random_read_gbps_measured", "spmm_vs_stream_ceiling",
    "spmm_vs_gather_ceiling", "spmm_bound_ms", "power_limit",
)
OTHER_KEYS = (
    "metric", "unit", "device", "e2e_pairs_per_sec", "fp32_peak_tflops",
    "bf16_peak_tflops", "hbm_peak_gbps", "device_kind", "device_count",
    "kernel_launches", "baseline_caveat",
)


@pytest.mark.parametrize("n_users,n_items,seed", [
    (64, 1000, 0), (50, 700, 1), (37, 128, 5)])
def test_make_problem_matches_jax_bench(n_users, n_items, seed):
    got = tbench._make_problem(n_users, n_items, seed)
    ref = jbench._make_problem(n_users, n_items, seed)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert (tbench.DIM, tbench.TOP_K, tbench.MAX_RATED) == (
        jbench.DIM, jbench.TOP_K, jbench.MAX_RATED)
    assert (tbench.BC_USERS, tbench.BC_ITEMS, tbench.ML_USERS,
            tbench.ML_ITEMS) == (jbench.BC_USERS, jbench.BC_ITEMS,
                                 jbench.ML_USERS, jbench.ML_ITEMS)


class _Captured(Exception):
    pass


@pytest.mark.parametrize("n,k", [(5000, 24), (70000, 16)])
def test_ell_arrays_match_jax_bench(monkeypatch, n, k):
    """The SpMM bench's ELL arrays: ``bench.bench_spmm_roofline``'s, caught
    where it builds its graph."""
    # the package exports a function of the module's name: take the module
    jspmm = importlib.import_module("coldrec_tpu.ops.spmm")

    def capture(**kw):
        raise _Captured(kw)

    monkeypatch.setattr(jspmm, "EllGraph", capture)
    with pytest.raises(_Captured) as caught:
        jbench.bench_spmm_roofline(n=n, k=k)
    ref = caught.value.args[0]
    cols, vals, _ = tbench.ell_problem(n, k)
    np.testing.assert_array_equal(cols, np.asarray(ref["ell_cols"]))
    np.testing.assert_array_equal(vals, np.asarray(ref["ell_vals"]))
    assert cols.dtype == np.int32 and vals.dtype == np.float32


def test_bench_entry_prints_one_line_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS=str(THREADS))
    proc = subprocess.run(
        [sys.executable, "-m", "coldrec_tpu_torch.bench", "--device", "cpu",
         "--users", "64", "--items", "1000"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    line = json.loads(lines[0])
    assert set(line) == set(DEVICE_FIGURES) | set(OTHER_KEYS)
    assert all(line[k] is None for k in DEVICE_FIGURES), line
    assert line["metric"] == "scored_pairs_per_sec_bookcrossing"
    assert (line["device"], line["device_kind"]) == ("cpu", "cpu")
    assert line["e2e_pairs_per_sec"] > 0
    assert (line["fp32_peak_tflops"], line["bf16_peak_tflops"],
            line["hbm_peak_gbps"]) == (67.0, 989.0, 3350.0)
    assert "[bench]" in proc.stderr


def test_bench_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        tbench.main([])
    with pytest.raises(SystemExit):
        tbench.main(["--device", "cpu", "--users", "64"])


@pytest.mark.parametrize("seed", [0, 1])
def test_bench_sweep_lists_match_jax_masked_topk(seed):
    ue, ie, rated, excluded = tbench._make_problem(96, 1500, seed)
    out = tbench.bench_sweep((ue, ie, rated, excluded), "cpu")
    assert out["device_pps"] is None and out["e2e_pps"] > 0
    _, ref = jmasked_topk(jnp.asarray(ue) @ jnp.asarray(ie).T,
                          jnp.asarray(rated), jnp.asarray(excluded),
                          tbench.TOP_K)
    np.testing.assert_array_equal(out["ids"], np.asarray(ref))


def test_card_figures_run_at_toy_shapes_on_the_cpu():
    """The functions whose figures only the card fills in the line, at toy
    shapes on the host clock (so their code paths run here)."""
    step_ms, pps = tbench.bench_mf_train_step("cpu", n_iter=3, bs=16,
                                              shape=(50, 80))
    assert step_ms > 0 and pps > 0
    roof = tbench.bench_spmm_roofline("cpu", n=3000, k=8, n_iter=1,
                                      stream_floats=1 << 12)
    assert all(np.isfinite(v) and v > 0 for v in roof.values()), roof
    problem = tbench._make_problem(64, 1000)
    best, std = tbench.bench_torch_baseline(problem, "cpu", n_bench_users=64,
                                            batch=32)
    assert best > 0 and std >= 0
    best, std = tbench.bench_torch_train_baseline("cpu", n_steps=2, bs=16,
                                                  shape=(50, 80))
    assert best > 0 and std >= 0
    assert tbench.bench_plain_sweep(problem, "cpu") is None


def test_bounds_use_the_published_h100_peaks():
    """2048 x 270,170 at d=64: the fp32 sweep is bound by operations at
    67 TFLOP/s (1.057 ms, PERF.md), the bf16 one by operations at 989."""
    flops = 2.0 * 2048 * 270_170 * 64
    moved = timing.sweep_bytes(2048, 64, 270_208, 4)
    ms, by = timing.sweep_bound(flops, moved)
    assert by == "operations" and abs(ms - flops / 67e12 * 1e3) < 1e-12
    assert round(ms, 3) == 1.057
    ms, by = timing.bf16_bound(flops, timing.sweep_bytes(2048, 64, 270_208,
                                                         2))
    assert by == "operations" and round(ms, 3) == 0.072
    assert timing.sweep_bound(0.0, 3.35e9) == (1.0, "bytes")


def test_time_sweep_and_run_ms_on_the_cpu():
    out = timing.time_sweep("cpu", n_users=16, n_items=500, d=8, reps=1)
    assert out["bound_by"] == "bytes" and out["ms"] > 0
    assert set(out) == {"ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by", "flops", "bytes"}
    calls = []
    runs = timing.run_ms(lambda: calls.append(1), 4, "cpu", repeats=3)
    assert len(runs) == 3 and len(calls) == 1 + 3 * 4
    assert timing.time_ms(lambda: None, 2, "cpu") >= 0
