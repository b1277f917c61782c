"""``python -m coldrec_tpu_torch.parallel.dryrun`` on 2 and 4 CPU ranks
(meshes 1x2 and 2x2): each phase of the ranks against one rank in the
parent, exit 0 and one JSON verdict: MF bit-equal to one rank where there
is no data axis (1x2) and within ``dryrun.TOL`` with one, LightGCN within
``dryrun.TOL``, the mesh server's ids equal, every rank's results the
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
