"""DeepMusic, MetaEmbedding and LARA on ``--mesh DxM`` and on a process
group in the port, on real gloo ranks, against one rank and the JAX
package's 2x2 run (``tests/torch_mesh_cold_case.py`` has the case).

Held: LARA's tables row-sharded over a model axis of 2 (each rank half of
their rows), DeepMusic's and MetaEmbedding's parameters whole (their
backbone tables sit outside them, as in the JAX package); ``1x2``
bit-equal to one rank; ``2x1``, ``2x2`` and the group with no ``--mesh``
within ``RTOL`` / ``ATOL``, every rank alike; the port's 2x2 from the JAX
trainer's weights against the JAX package's 2x2; and MetaEmbedding's
inner gradient on a data group of 2 (each rank's rows of loss_a over the
global batch's weight) equal to one rank's autograd of the global batch,
its loss and every gradient too.
"""
import numpy as np
import pytest

from coldrec_tpu_torch.data.sampler import pairwise_batches
from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from test_torch_threads import torch_threads  # noqa: F401
from torch_mesh_child import one_step
from torch_mesh_cold_case import (
    COMMON, KW, check_jax, check_mesh, flags, mesh_runs, meshes, one_thread,
)

CASES = ("DeepMusic", "MetaEmbedding", "LARA")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_content")
    batch, noise = tmp / "batch.npz", tmp / "noise.npz"
    np.savez(batch, **next(iter(pairwise_batches(
        synthetic_dataset(**KW)[0], COMMON["bs"],
        np.random.default_rng(3)))))
    np.savez(noise)  # MetaEmbedding's loss draws nothing
    step = {**flags("MetaEmbedding"), "batch": str(batch),
            "noise": str(noise)}
    out = mesh_runs(tmp, CASES, {2: [("step_meta", {**step, "mesh": "2x1"})]})
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


def test_metaembedding_inner_gradient_over_the_data_group(runs):
    """Each rank's meta rows are [its positives; its negatives]; their
    inner gradients, put back in the global batch's order, are one rank's
    autograd of the global loss_a; the loss and every gradient (summed over
    the data group) match too."""
    one = runs["step"]
    ranks = [runs["ranks"][f"step_meta/{r}"] for r in range(2)]
    b = ranks[0]["inner"].shape[0] // 2
    inner = np.concatenate([g["inner"][:b] for g in ranks]
                           + [g["inner"][b:] for g in ranks])
    scale = np.abs(one["inner"]).max()
    assert scale > 0
    np.testing.assert_allclose(inner, one["inner"], rtol=0,
                               atol=1e-6 * scale)
    for g in ranks:
        np.testing.assert_allclose(g["loss"], one["loss"], rtol=1e-6)
        for key in one:
            if key.startswith("grad/"):
                np.testing.assert_allclose(
                    g[key], one[key], rtol=0,
                    atol=1e-6 * np.abs(one[key]).max(), err_msg=key)
