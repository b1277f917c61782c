"""Phase mesh of ``chip_smoke.py`` rehearsed on the CPU at a tiny size, in a
process where jax and coldrec_tpu are blocked (``_run_blocked``): the
script's own rank entry (``chip_smoke.py --rank``) started as gloo ranks on
localhost, (a) a 1x2 mesh server id-equal to one rank's, (b) MF ``--mesh
1x2`` bit-equal to one rank, (c) MF data-parallel on 2 ranks and (d)
LightGCN ``--mesh 2x2`` on 4 ranks within their tolerances, then on (c)'s
bus (e) DropoutNet ``--mesh 1x2`` bit-equal to one rank and (f) DropoutNet
``--mesh 2x2`` within its tolerances, its BatchNorm running statistics
equal on every rank; (g) XSimGCL ``--mesh 2x2``, (h) SimGCL ``--mesh 1x2``,
(i) NGCF ``2x2``, (j) NCL ``2x2`` with its proto term and e-step on, and (k)
CGRC ``2x2`` on the split with 206 item columns, each trained for
``MESH_STEPS`` batches (all of the tiny split's) and held to its one-rank
run, (h) in (b)'s ranks and (g), (i)-(k) in (d)'s; the one-rank runs of
(g), (h) and (k) replay their ranks' records (the perturbed elements' signs,
Ĝ's top-k users) and account for every difference as a tie; the eleven cold
models on the split with 206 item columns, (l) DUIF, (m) KNN, (n) LARA,
(o) DeepMusic and (p) Heater ``--mesh 1x2`` bit-equal to one rank, (q) GAR,
(r) CLCRec, (s) CCFCRec, (t) AGNN, (u) MetaEmbedding and (v) GoRec ``--mesh
2x2`` within their tolerances (GoRec's BatchNorm statistics equal on every
rank), (l), (m) in (b)'s ranks, (r), (s) in (d)'s, (n)-(p) in (e)'s and
(q), (t)-(v) in (f)'s, on (c)'s bus where they read one; every rank's
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
                 "(e) 2 ranks vs one: losses 0.000e+00",
                 "(f) 4 ranks vs one", "(f) --model DropoutNet --mesh 2x2",
                 "BatchNorm running statistics equal on every rank",
                 "(g) --model XSimGCL --layers 2 --mesh 2x2 --deterministic "
                 "--epoch_steps 10",
                 "(h) --model SimGCL --layers 2 --mesh 1x2 --deterministic",
                 "(i) --model NGCF --layers 2 --mesh 2x2",
                 "(j) --model NCL --layers 2 --mesh 2x2 --deterministic "
                 "--epoch_steps 10 --ncl_proto",
                 "(k) --model CGRC --mesh 2x2",
                 "(g) 4 ranks vs one", "(h) 2 ranks vs one",
                 "(i) 4 ranks vs one", "(j) 4 ranks vs one",
                 "(k) 4 ranks vs one", "perturbed elements of another sign "
                 "than the ranks' (ties, the ranks' side taken): ",
                 "Ĝ: the ranks' top-k users (every rank's the same) equal "
                 "one rank's in ",
                 "(h) --model SimGCL --layers 2 --mesh 1x2 --deterministic "
                 "--epoch_steps 10: 2 ranks (run 2 of 4 in the group)",
                 "rank 3 on cpu",
                 *(f"({t}) 2 ranks vs one: losses 0.000e+00 relative"
                   for t in "lmnop"),
                 *(f"({t}) 4 ranks vs one" for t in "qrstuv"),
                 "(m) --model KNN --backbone LightGCN --layers 2 --mesh 1x2 "
                 "--deterministic --epoch_steps 10: 2 ranks (run 4 of 4 in "
                 "the group)",
                 "(s) --model CCFCRec --mesh 2x2 --deterministic "
                 "--epoch_steps 10: 4 ranks (run 7 of 7 in the group)",
                 "(v) --model GoRec --mesh 2x2 --deterministic "
                 "--epoch_steps 10: 4 ranks (run 5 of 5 in the group)"):
        assert line in proc.stdout, line
