"""``chip_smoke.py``'s phases search and parse rehearsed on the CPU at a
tiny size, in a process where importing jax or coldrec_tpu fails
(``test_torch_imports._run_blocked``): 3 MF trials of the port's search
driver and the resume that runs one more, every check of the phase (the
``RandomTrial`` draws, finite values, the pickle and its sidecar,
``view_best``'s text, the CLI giving the best value again); then the
split's CSVs through the C++ parser against ``np.loadtxt``."""
from test_torch_imports import _run_blocked
from test_torch_threads import torch_threads  # noqa: F401  (autouse)


def test_chip_smoke_search_phases_rehearse_on_cpu_without_jax(tmp_path):
    code = (
        "import os, tempfile\n"
        "import chip_smoke as cs\n"
        "for m in ('jax', 'coldrec_tpu'):\n"
        "    assert sys.modules[m] is None\n"
        "here = os.getcwd()\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    cs.ml_split(root, n_users=200, n_items=300, n_inter=6000)\n"
        "    n = cs.search_run('cpu', root, bs=256)\n"
        "    assert n['fused_sweep'] == 0, n\n"
        "    secs = cs.parse_run(root, ds='ml_synth')\n"
        "    assert secs['native'] > 0 and secs['loadtxt'] > 0, secs\n"
        "assert os.getcwd() == here and not os.path.exists('param')\n"
        "print('SEARCH OK')\n"
    )
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SEARCH OK" in proc.stdout
    for line in ("trial 0: ",
                 "trial 3: ", "3 trials, resumed to 4 (one more ran)",
                 "Best params from ./param/MF_ml_synth_item_bb_MF_cs.pkl:",
                 "(objective value: ", "7 CSVs, ", "arrays equal"):
        assert line in proc.stdout, line
