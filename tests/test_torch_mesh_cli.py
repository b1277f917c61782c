"""Phase mesh of ``chip_smoke.py`` rehearsed on the CPU at a tiny size, in a
process where jax and coldrec_tpu are blocked (``_run_blocked``): the
script's own rank entry (``chip_smoke.py --rank``) started as gloo ranks on
localhost, (a) a 1x2 mesh server id-equal to one rank's, (b) MF ``--mesh
1x2`` bit-equal to one rank, (c) MF data-parallel on 2 ranks and (d)
LightGCN ``--mesh 2x2`` on 4 ranks within their tolerances, every rank's
backend and device logged, rank 0 the only writer."""
from test_torch_imports import _run_blocked
from test_torch_threads import torch_threads  # noqa: F401


def test_chip_smoke_mesh_phase_rehearses_on_cpu_without_jax(tmp_path):
    code = (
        "import tempfile\n"
        "import chip_smoke as cs\n"
        "for m in ('jax', 'coldrec_tpu'):\n"
        "    assert sys.modules[m] is None\n"
        "pairs = cs.synthetic_interactions(300, 2000, 8000, seed=0)\n"
        "with tempfile.TemporaryDirectory() as bx, \\\n"
        "        tempfile.TemporaryDirectory() as ml:\n"
        "    cs.write_split(bx, 'bx_synth', pairs, 0, 4)\n"
        "    cs.ml_split(ml, n_users=200, n_items=300, n_inter=6000)\n"
        "    n = cs.mesh_run('cpu', bx, ml, d=16, bs=512,\n"
        "                    serve=(32, 32, 64))\n"
        "assert n == {'fused_sweep': 0}, n\n"
        "print('MESH OK')\n"
    )
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MESH OK" in proc.stdout
    for line in ("(a) serve 1x2: 2 ranks", "backend gloo (ranks on the CPU)",
                 "lists id-equal to one rank's on ['32/32', '32/32', "
                 "'64/64']", "(b) 2 ranks vs one: losses 0.000e+00",
                 "tables 0.000e+00, metrics 0.000e+00",
                 "(c) 2 ranks vs one", "(d) 4 ranks vs one",
                 "rank 3 on cpu"):
        assert line in proc.stdout, line
