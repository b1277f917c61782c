"""The port's ``ubench_serving``, ``ubench_sweep`` and ``ubench_spmm``
tools at tiny shapes on the CPU, held against the JAX package where it
has the same function (its ``RetrievalServer``, ``tools/ubench_spmm.py``'s
``make_ell``), and the split writer against ``np.savetxt``."""
import io
import json

import numpy as np
import pytest
import torch
import ubench_spmm as jax_ubench_spmm  # tools/ is on sys.path (conftest.py)
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

from coldrec_tpu.runtime.serving import RetrievalServer as JaxServer
from coldrec_tpu_torch.data.split import int_csv_bytes
from coldrec_tpu_torch.tools import ubench_serving, ubench_spmm, ubench_sweep
from coldrec_tpu_torch.utils.timing import SPMM_RTOL

# item spaces under 256: the JAX server answers off the TPU by its exact
# masked top-k (its Pallas kernel in interpret mode takes seconds a call)
TINY = ["--users", "300", "--items", "200", "--d", "16", "--iters", "2",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def e2e():
    return ubench_serving.main(TINY)["e2e"]


def _tables(argv):
    return ubench_serving.tables(ubench_serving.parse_args(argv),
                                 np.random.default_rng(0))


@pytest.mark.parametrize("bs", ubench_serving.E2E_SIZES)
def test_served_lists_equal_jax_server(e2e, bs):
    ue, ie, source = _tables(TINY)
    assert source == "random"
    r = e2e[bs]
    assert r["users"].shape == (bs,) and r["ids"].shape == (bs, 20)
    assert 0 < r["p50_ms"] <= r["p95_ms"] and r["gpairs_s"] > 0
    _, want = JaxServer(ue, ie).topk(r["users"], 20)
    np.testing.assert_array_equal(r["ids"], want)


def test_device_only_mode_times_every_size():
    res = ubench_serving.main(TINY + ["--device_only"])
    assert res["clock"].startswith("host clock")
    assert sorted(res["device_only"]) == list(ubench_serving.DEVICE_SIZES)
    for bs, r in res["device_only"].items():
        assert r["ms"] > 0
        assert r["us_per_request"] == pytest.approx(r["ms"] * 1e3 / bs)


@pytest.mark.parametrize("emb", [False, True])
def test_bf16_ab_drift_equals_a_numpy_recount(tmp_path, emb):
    argv = TINY + ["--bf16_ab"]
    if emb:
        rng = np.random.default_rng(4)
        path = tmp_path / "bus_emb.npz"
        np.savez(path, user_emb=rng.standard_normal((50, 8), np.float32),
                 item_emb=rng.standard_normal((240, 8), np.float32))
        argv += ["--emb", str(path)]
    r = ubench_serving.main(argv)["bf16_ab"]
    ids32, ids16 = r["ids32"], r["ids16"]
    assert ids32.shape == ids16.shape == (ubench_serving.AB_SIZE, 20)
    changed = sum(list(a) != list(b) for a, b in zip(ids32, ids16))
    overlap = np.mean([len(set(a) & set(b)) / 20
                       for a, b in zip(ids32, ids16)])
    assert r["changed"] == changed > 0
    assert r["overlap"] == pytest.approx(overlap, abs=1e-12)
    assert r["speedup"] == pytest.approx(r["fp32_ms"] / r["bf16_ms"])
    # the fp32 lists are the JAX server's
    ue, ie, _ = _tables(argv)
    _, want = JaxServer(ue, ie).topk(r["users"], 20, exclude_rated=False)
    np.testing.assert_array_equal(ids32, want)


def test_serve_device_is_retrieval_topk_before_the_host():
    """The device work the tools time gives the lists ``retrieval_topk``
    returns (no row flagged here, so no fallback, and no ties)."""
    from coldrec_tpu_torch.ops.cuda.retrieval import retrieval_topk

    ue, ie, _ = _tables(TINY)
    ue, ie = torch.as_tensor(ue[:64]), torch.as_tensor(ie)
    rated = torch.full((64, 1), ie.shape[0], dtype=torch.int64)
    excl = torch.zeros(ie.shape[0], dtype=torch.bool)
    (vals, ids, sus), = ubench_serving.serve_device(ue, ie, rated, excl, 20)
    assert not bool(sus.any())
    _, want = retrieval_topk(ue, ie, rated, excl, 20, device="cpu")
    np.testing.assert_array_equal(ids.numpy(), want)


def test_ubench_sweep_point_on_the_cpu(tmp_path):
    out = tmp_path / "sweep.json"
    res = ubench_sweep.main(["--users", "40", "--items", "1000", "--d",
                             "8,32", "--iters", "1", "--device", "cpu",
                             "--out", str(out)])
    assert [(r["users"], r["d"]) for r in res] == [(40, 8), (40, 32)]
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    for r in res:
        assert r["max_abs_err"] == {"fp32": 0.0, "bf16": 0.0}
        assert set(r["forms"]) == {
            "mm_rowmax_fp32", "mm_plane_fp32", "plain_topk_fp32",
            "kernel_raw_fp32", "kernel_padded_fp32", "mm_rowmax_bf16",
            "kernel_raw_bf16", "kernel_padded_bf16"}
        for name, f in r["forms"].items():
            assert f["ms"] > 0 and f["bound_ms"] > 0, name
            assert f["bound_by"] in ("operations", "bytes")
        assert r["bf16_speedup_kernel_raw"] > 0
    with pytest.raises(ValueError, match="fp16"):
        ubench_sweep.main(["--dtype", "fp16", "--device", "cpu"])


def test_ubench_sweep_check_refuses_a_wrong_kernel(monkeypatch):
    """The integer check fails where the kernel's candidates differ from
    its plain version's."""
    def off_by_one(users, items_t, excl):
        cv, ci, gh = ubench_sweep.fused_sweep_reference(
            users.float(), items_t.float(), excl)
        return cv + 1, ci, gh

    monkeypatch.setattr(ubench_sweep, "fused_sweep", off_by_one)
    with pytest.raises(AssertionError, match="differs from its plain"):
        ubench_sweep.check_exact("cpu", 16, 300, 8, ("fp32",))


@pytest.mark.parametrize("n,k,seed", [(1000, 8, 1), (9728, 56, 1),
                                      (70_000, 5, 3)])
def test_make_ell_bit_equal_to_jax_tool(n, k, seed):
    cols, vals = ubench_spmm.make_ell(n, k, seed)
    want_cols, want_vals = jax_ubench_spmm.make_ell(n, k, seed)
    assert cols.dtype == want_cols.dtype and vals.dtype == want_vals.dtype
    assert cols.tobytes() == want_cols.tobytes()
    assert vals.tobytes() == want_vals.tobytes()


@pytest.mark.parametrize("form", ["A_einsum", "B_unrolled", "C_loop_k",
                                  "D_mul_sum", "sparse_mm"])
def test_spmm_forms_agree_with_ell_apply(form):
    n, k = 3000, 12
    cols, vals = ubench_spmm.make_ell(n, k, seed=5)
    fns = ubench_spmm.forms(torch.as_tensor(cols).long(),
                            torch.as_tensor(vals), n)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (n, 16)).astype(np.float32))
    want = fns["ell_apply"](x)
    got = fns[form](x)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= SPMM_RTOL * scale
    dense = np.zeros((n, n))
    np.add.at(dense, (np.repeat(np.arange(n), k), cols.ravel()),
              vals.ravel())
    np.testing.assert_allclose(want.numpy(), dense @ x.numpy().astype(
        np.float64), rtol=0, atol=SPMM_RTOL * scale)


def test_ubench_spmm_slab_on_the_cpu():
    res = ubench_spmm.main(["--n", "2000", "--k", "16", "--d", "8",
                            "--iters", "1", "--device", "cpu"])["custom"]
    assert (res["n"], res["k"], res["d"]) == (2000, 16, 8)
    assert set(res["forms"]) == {"ell_apply", "A_einsum", "B_unrolled",
                                 "C_loop_k", "D_mul_sum", "sparse_mm"}
    assert res["bound_ms"] > res["once_bound_ms"] > 0
    for f in res["forms"].values():
        assert f["ms"] > 0 and f["max_abs_err"] <= SPMM_RTOL * res["scale"]


WRITER_CASES = {
    "empty": np.zeros((0, 2), np.int64),
    "one_row": np.array([[3, 7]]),
    "one_column": np.array([5, 6, 70]),
    "zeros": np.zeros((3, 2), np.int32),
    "large_ids": np.array([[2**62, 9], [2**63 - 1, 0]], np.int64),
    "uint64_max": np.array([[2**64 - 1, 10**19]], np.uint64),
    "negative": np.array([[-1, -10], [-2**63, 99], [0, -5]], np.int64),
    "bool": np.array([[True, False]]),
    "int8": np.array([[-128, 127]], np.int8),
    "no_columns": np.zeros((2, 0), np.int64),
    "random": np.random.default_rng(0).integers(-10**9, 10**12, (500, 3)),
    "split_like": np.random.default_rng(1).integers(0, 106_881, (4096, 2)),
}


@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_csv_writer_byte_equal_to_savetxt(case):
    arr = WRITER_CASES[case]
    f = io.StringIO()
    np.savetxt(f, arr, fmt="%d", delimiter=",")
    assert int_csv_bytes(arr) == f.getvalue().encode()


def test_csv_writer_refuses_floats_and_cubes():
    with pytest.raises(TypeError):
        int_csv_bytes(np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError):
        int_csv_bytes(np.zeros((2, 2, 2), np.int64))
