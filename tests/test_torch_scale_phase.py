"""``chip_smoke.py``'s phase scale rehearsed on the CPU at a tiny shape, in
a process where importing jax or coldrec_tpu fails
(``test_torch_imports._run_blocked``): the port's ``scale_run`` through its
command line runs MF, then DropoutNet on MF's bus (the backbone run made
by the tool), each CLI run in its own process, and every check of the
phase holds. A file of its own: the rehearsal takes ~20 s."""
from test_torch_imports import _run_blocked
from test_torch_threads import torch_threads  # noqa: F401  (autouse)


def test_chip_smoke_scale_phase_rehearses_on_cpu_without_jax(tmp_path):
    code = (
        "import tempfile\n"
        "import chip_smoke as cs\n"
        "for m in ('jax', 'coldrec_tpu'):\n"
        "    assert sys.modules[m] is None\n"
        "cs.sr.SHAPES['bx'] = dict(n_users=500, n_items=400,\n"
        "                          n_inter=60000, content_dim=16)\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    n = cs.scale_phase('cpu', root, shape='bx', epochs=2)\n"
        "assert n == {'fused_sweep': 0, 'fused_sweep_bf16': 0,\n"
        "             'merge_parts': 0}, n\n"
        "print('SCALE OK')\n"
    )
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SCALE OK" in proc.stdout
    for line in ("dataset bx (", "27796 warm-train pairs",
                 "MF: {'scale_run': 'MF', 'epochs': 2",
                 "DropoutNet: {'scale_run': 'DropoutNet', 'epochs': 2",
                 "untrained tables' validation NDCG@20",
                 "'overall_val': ['kernel']",
                 "lists of 512 test users id-equal to the plain path all",
                 "7 batches an epoch"):
        assert line in proc.stdout, line
    assert proc.stdout.count("    epoch 2: 7 steps") == 2
