"""``chip_smoke.py``'s phases bench, ml-split, profile and fused rehearsed
on the CPU at a tiny size, in a process where importing jax or
coldrec_tpu fails (``test_torch_imports._run_blocked``). A file of its own:
the rehearsal's subprocess takes ~20 s, and ``test_torch_bench.py`` and
``test_torch_drivers.py`` stay well inside 30 s without it."""
from test_torch_imports import _run_blocked
from test_torch_threads import torch_threads  # noqa: F401  (autouse)


def test_chip_smoke_entry_phases_rehearse_on_cpu_without_jax(tmp_path):
    """Phases bench, ml-split, profile and fused of ``chip_smoke.py`` on the
    CPU at a tiny size, in a process where importing jax or coldrec_tpu
    fails."""
    code = (
        "import tempfile\n"
        "import chip_smoke as cs\n"
        "line, n = cs.bench_run('cpu', shape=(64, 1000))\n"
        "assert line['device'] == 'cpu' and line['value'] is None, line\n"
        "assert n == {'fused_sweep': 0, 'fused_sweep_bf16': 0,\n"
        "             'merge_parts': 0}, n\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    data = cs.ml_split(root, n_users=200, n_items=300, n_inter=6000)\n"
        "    n = cs.profile_run('cpu', root, d=16, bs=256)\n"
        "    assert n['fused_sweep'] == 0, n\n"
        "    cs.fused_run('cpu', root, data, k=3, d=16, bs=256)\n"
        "print('REHEARSAL OK')\n"
    )
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "REHEARSAL OK" in proc.stdout
    assert "kernel lists id-equal to the plain route on 64/64" in proc.stdout
    assert "seconds per epoch: plain" in proc.stdout
    for model in ("MF", "XSimGCL"):
        assert (f"{model}: fused vs per-batch tables max abs diff [0.0, 0.0]"
                in proc.stdout)
