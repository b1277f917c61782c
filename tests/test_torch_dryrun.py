"""``python -m coldrec_tpu_torch.parallel.dryrun`` on 2 and 4 CPU ranks
(meshes 1x2 and 2x2): each phase of the ranks against one rank in the
parent, exit 0 and one JSON verdict: MF bit-equal to one rank where there
is no data axis (1x2) and within ``dryrun.TOL`` with one, LightGCN within
``dryrun.TOL``, the mesh server's ids equal; the MF epoch's bus, the
DropoutNet epoch on it (BatchNorm over the global batch, a train state
checkpoint) and its resume to epoch 2 bit-equal to one rank at 1x2 and
within ``dryrun.TOL`` at 2x2, the resumed bus tables row-sharded again;
one CGRC epoch (the user table row-sharded, the JAX dry run's phase 3) and
one XSimGCL epoch (both tables row-sharded) within ``dryrun.TOL`` of one
rank's, their test metrics finite; one GAR and one GoRec epoch on the bus
(bit-equal at 1x2, within ``dryrun.TOL`` at 2x2); every rank's results the
same."""
import json
import os
import subprocess
import sys

import pytest

from test_torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def verdicts():
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = {n: subprocess.Popen(
        [sys.executable, "-m", "coldrec_tpu_torch.parallel.dryrun",
         "--ranks", str(n), "--device", "cpu", "--timeout", "240"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for n in (2, 4)}
    out = {}
    for n, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stdout[-3000:] + stderr[-3000:]
        out[n] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("n,mesh", [(2, "1x2"), (4, "2x2")])
def test_dryrun_phases_match_one_rank(verdicts, n, mesh):
    v = verdicts[n]
    assert (v["ranks"], v["mesh"], v["device"]) == (n, mesh, "cpu")
    assert v["ranks_agree"]
    assert v["mf"]["ok"] and v["lightgcn"]["ok"] and v["serve"]["ok"]
    assert v["serve"]["ids_equal"]
    if mesh == "1x2":
        assert v["mf"]["bit_equal"]


@pytest.mark.parametrize("n,mesh", [(2, "1x2"), (4, "2x2")])
def test_dryrun_dropoutnet_phases_match_one_rank(verdicts, n, mesh):
    """The JAX dry run's phase 2: the MF bus, DropoutNet on the mesh with a
    checkpoint, and the resume with its tables sharded again."""
    v = verdicts[n]
    assert v["bus"]["ok"] and v["dropoutnet"]["ok"] and v["resume"]["ok"]
    # 96 users and 80 items over a model axis of 2
    assert v["resume"]["sharded_rows"] == [48, 40]
    if mesh == "1x2":
        assert v["dropoutnet"]["bit_equal"]
        assert v["bus"]["max_abs_err"] == v["resume"]["max_abs_err"] == 0.0


@pytest.mark.parametrize("n,mesh", [(2, "1x2"), (4, "2x2")])
def test_dryrun_graph_phases_match_one_rank(verdicts, n, mesh):
    """The JAX dry run's phase 3 (CGRC on the mesh) and an XSimGCL epoch:
    the tables row-sharded over the model axis of 2 (96 users, 80 items),
    the metrics finite, losses and eval tables within ``dryrun.TOL``."""
    v = verdicts[n]
    for phase, rows in (("cgrc", [48]), ("xsimgcl", [48, 40])):
        assert v[phase]["ok"], v[phase]
        assert v[phase]["finite_metrics"]
        assert v[phase]["sharded_rows"] == rows


@pytest.mark.parametrize("n,mesh", [(2, "1x2"), (4, "2x2")])
def test_dryrun_cold_model_phases_match_one_rank(verdicts, n, mesh):
    """GAR on the bus phase's bus, its tables row-sharded (each rank half
    of the 96 users and 80 items), and GoRec on it (BatchNorm and
    uniformity over the global batch, every rank's running statistics the
    same): losses and eval tables within ``dryrun.TOL`` of one rank's,
    bit-equal without a data axis."""
    v = verdicts[n]
    assert v["gar"]["ok"] and v["gorec"]["ok"], (v["gar"], v["gorec"])
    assert v["gar"]["sharded_rows"] == [48, 40]
    if mesh == "1x2":
        assert v["gar"]["bit_equal"] and v["gorec"]["bit_equal"]
