"""GAR, DUIF and Heater on ``--mesh DxM`` and on a process group in the
port, on real gloo ranks, against one rank and the JAX package's 2x2 run
(``tests/torch_mesh_cold_case.py`` has the case).

Held: GAR's and DUIF's tables row-sharded over a model axis of 2 (each rank
half of their rows; DUIF's cold side takes no gradient), Heater's
parameters whole (its backbone tables sit outside them, as in the JAX
package); ``1x2`` bit-equal to one rank (losses, eval tables, test metrics
and lists); ``2x1``, ``2x2`` and the group with no ``--mesh`` within
``RTOL`` / ``ATOL``, every rank alike; the port's 2x2 from the JAX
trainer's weights against the JAX package's 2x2; and GAR checkpointed
under 2x2 after epoch 1 and resumed to epoch 2 bit-equal to the
uninterrupted run.
"""
import numpy as np
import pytest

from test_torch_threads import torch_threads  # noqa: F401
from torch_mesh_cold_case import (
    check_bit_equal, check_jax, check_mesh, flags, mesh_runs, meshes,
)

CASES = ("GAR", "DUIF", "Heater")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cold")
    ckpt = str(tmp / "gar.ckpt")
    return mesh_runs(tmp, CASES, {4: [
        ("resume_a", {**flags("GAR"), "mesh": "2x2", "epochs": 1,
                      "state_ckpt": ckpt}),
        ("resume_b", {**flags("GAR"), "mesh": "2x2", "state_ckpt": ckpt})]})


@pytest.mark.parametrize("case,mesh,n", meshes(CASES))
def test_mesh_matches_one_rank(runs, case, mesh, n):
    check_mesh(runs, case, mesh, n)


@pytest.mark.parametrize("case", CASES)
def test_dp_tp_matches_jax_2x2(runs, case):
    check_jax(runs, case)


def test_gar_mesh_resume(runs):
    """GAR on 2x2 checkpointed after epoch 1 (its sharded tables and their
    Adam moments gathered by rank 0) and resumed to epoch 2 (sharded
    again) equals the uninterrupted run."""
    for r in range(4):
        resumed = runs["ranks"][f"resume_b/{r}"]
        full = runs["ranks"][f"GAR@2x2/{r}"]
        assert resumed["shapes"].tolist() == full["shapes"].tolist()
        np.testing.assert_array_equal(
            resumed["losses"], full["losses"][-len(resumed["losses"]):])
        check_bit_equal({**resumed, "losses": full["losses"]}, full,
                        f"resume rank {r}")
