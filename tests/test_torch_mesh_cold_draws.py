"""AGNN, CLCRec and GoRec, whose losses draw, on ``--mesh DxM`` and on a
process group in the port, on real gloo ranks, against one rank and the
JAX package's 2x2 run with its draws injected
(``tests/torch_mesh_cold_case.py`` has the case).

Every rank draws the global batch's masks, normals or hybrid rows from
the shared generator and keeps its block, so the ranks see one rank's
stream draw for draw. Held: AGNN's and CLCRec's tables row-sharded over a
model axis of 2 (AGNN's also while they take no gradient), GoRec's
parameters whole; ``1x2`` bit-equal to one rank; ``2x1``, ``2x2`` and the
group with no ``--mesh`` within ``RTOL`` / ``ATOL``, every rank alike;
GoRec's BatchNorm running statistics the same on every rank and within
``ATOL`` of one rank's; the port's 2x2 from the JAX trainer's weights and
draws against the JAX package's 2x2. Unit cases: GoRec's loss and every
gradient on a data group of 2 (BatchNorm and uniformity over the global
batch) against one rank's; the uniformity parts of blocks against
``uniformity`` of the global batch; CLCRec's per-rank blocks of the hybrid
rows against one rank's.
"""
import numpy as np
import pytest
import torch

from coldrec_tpu_torch.data.sampler import pairwise_batches
from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from coldrec_tpu_torch.models.clcrec import replaced_rows
from coldrec_tpu_torch.models.gorec import uniformity, uniformity_parts
from test_torch_threads import torch_threads  # noqa: F401
from torch_mesh_child import one_step
from torch_mesh_cold_case import (
    ATOL, COMMON, D, KW, check_jax, check_mesh, flags, mesh_runs, meshes,
    one_thread,
)

CASES = ("AGNN", "CLCRec", "GoRec")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_draws")
    data = synthetic_dataset(**KW)[0]
    n, c = COMMON["bs"], data.item_content.shape[1]
    g = torch.Generator().manual_seed(4)
    batch, noise = tmp / "batch.npz", tmp / "noise.npz"
    np.savez(batch, **next(iter(pairwise_batches(
        data, n, np.random.default_rng(3)))))
    np.savez(noise, **{"draws/z": torch.randn(n, D, generator=g).numpy(),
                       "draws/zgc": torch.randn(n, D, generator=g).numpy(),
                       "draws/keep": (torch.rand(n, c, generator=g)
                                      >= 0.2).numpy()})
    step = {**flags("GoRec"), "batch": str(batch), "noise": str(noise)}
    out = mesh_runs(tmp, CASES, {2: [("step_gorec", {**step,
                                                     "mesh": "2x1"})]})
    with one_thread():
        out["step"] = one_step(out["data"], {**COMMON,
                                             "emb_dir": out["emb_dir"]},
                               step)
    return out


@pytest.mark.parametrize("case,mesh,n", meshes(CASES))
def test_mesh_matches_one_rank(runs, case, mesh, n):
    check_mesh(runs, case, mesh, n)


@pytest.mark.parametrize("case", CASES)
def test_dp_tp_matches_jax_2x2(runs, case):
    check_jax(runs, case)


@pytest.mark.parametrize("mesh,n", [("1x2", 2), ("2x1", 2), ("group", 2),
                                    ("2x2", 4)])
def test_gorec_batchnorm_statistics_on_every_rank(runs, mesh, n):
    """GoRec's two BatchNorms take the global batch's statistics: every
    rank holds the same running statistics, one rank's within ``ATOL``
    (1x2, no data axis: bit-equal)."""
    one = runs["one"]["GoRec"]["bn"]
    ranks = [runs["ranks"][f"GoRec@{mesh}/{r}"]["bn"] for r in range(n)]
    for got in ranks:
        np.testing.assert_array_equal(got, ranks[0])
    if mesh == "1x2":
        np.testing.assert_array_equal(ranks[0], one)
    np.testing.assert_allclose(ranks[0], one, rtol=0, atol=ATOL)


def test_gorec_step_over_the_data_group(runs):
    """One GoRec step on a data group of 2 from the same draws: the loss
    (uniformity of every pair of the global batch, BatchNorm over it) and
    every gradient summed over the group equal one rank's."""
    one = runs["step"]
    for r in range(2):
        got = runs["ranks"][f"step_gorec/{r}"]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
        for key in one:
            if key.startswith("grad/"):
                np.testing.assert_allclose(
                    got[key], one[key], rtol=0,
                    atol=1e-5 * np.abs(one[key]).max(), err_msg=key)


@pytest.mark.parametrize("blocks", [2, 4])
def test_uniformity_parts_of_blocks_are_the_global_uniformity(blocks):
    """Each block's pairs against the whole batch, the pair mask offset by
    the block's first row: summed, the parts give ``uniformity`` of the
    global batch, each pair counted once, and its gradient."""
    g = torch.Generator().manual_seed(1)
    mu = torch.randn(16, 6, generator=g, dtype=torch.float64,
                     requires_grad=True)
    w = (torch.rand(16, generator=g) > 0.3).double()
    want = uniformity(mu, w)
    (want_grad,) = torch.autograd.grad(want, mu)
    rows = 16 // blocks
    parts = sum(uniformity_parts(mu[i * rows:(i + 1) * rows], mu,
                                 w[i * rows:(i + 1) * rows], w, i * rows)
                for i in range(blocks))
    got = torch.log(parts[0] / parts[1].clamp_min(1.0))
    (got_grad,) = torch.autograd.grad(got, mu)
    real = int(w.sum())
    assert parts[1].item() == real * (real - 1) / 2
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
    torch.testing.assert_close(got_grad, want_grad, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("blocks", [2, 4])
def test_clcrec_hybrid_blocks_rebuild_one_ranks_rows(blocks):
    """The hybrid set's rows drawn over the global batch's flat rows, with
    repeats: each rank's block of them, re-based, concatenated, is one
    rank's set exactly."""
    n_flat = 64 * 9
    rand_index = torch.randint(0, n_flat, (n_flat // 2,),
                               generator=torch.Generator().manual_seed(2))
    assert torch.unique(rand_index).numel() < rand_index.numel()
    want = replaced_rows(rand_index, 0, n_flat)
    rows = n_flat // blocks
    got = torch.cat([replaced_rows(rand_index, i * rows, rows)
                     for i in range(blocks)])
    assert torch.equal(got, want)
    assert int(want.sum()) == torch.unique(rand_index).numel()
