"""KNN (``--backbone MF`` and ``LightGCN``) and CCFCRec on ``--mesh DxM``
and on a process group in the port, on real gloo ranks, against one rank
and the JAX package's 2x2 run (``tests/torch_mesh_cold_case.py`` has the
case).

Held: the two tables row-sharded over a model axis of 2 (each rank half of
their rows; KNN's LightGCN encoder propagates them gathered whole on the
one-device operator, CCFCRec gathers its item table once a step for its id
grids); ``1x2`` bit-equal to one rank; ``2x1``, ``2x2`` and the group with
no ``--mesh`` within ``RTOL`` / ``ATOL``, every rank alike (every rank
finds the same content neighbours); the port's 2x2 from the JAX trainer's
weights against the JAX package's 2x2.
"""
import pytest

from test_torch_threads import torch_threads  # noqa: F401
from torch_mesh_cold_case import check_jax, check_mesh, mesh_runs, meshes

CASES = ("KNN", "KNN_LightGCN", "CCFCRec")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mesh_runs(tmp_path_factory.mktemp("mesh_knn"), CASES)


@pytest.mark.parametrize("case,mesh,n", meshes(CASES))
def test_mesh_matches_one_rank(runs, case, mesh, n):
    check_mesh(runs, case, mesh, n)


@pytest.mark.parametrize("case", CASES)
def test_dp_tp_matches_jax_2x2(runs, case):
    check_jax(runs, case)
