"""``chip_smoke.py``'s phases mfstep and usim-split rehearsed on the CPU at
a tiny size, in a process where importing jax or coldrec_tpu fails
(``test_torch_imports._run_blocked``): the MF step tools' three modes and
``exp_fused_steps`` on ``scale_run``'s tiny shape, then
``profile_usim``'s functions on a tiny USIM trainer built on a random MF
bus, with every check of both phases."""
from test_torch_imports import _run_blocked
from test_torch_threads import torch_threads  # noqa: F401  (autouse)


def test_chip_smoke_mfstep_and_usim_split_phases_rehearse_on_cpu(tmp_path):
    code = (
        "import numpy as np\n"
        "import chip_smoke as cs\n"
        "from coldrec_tpu_torch.runtime.checkpoints import save_embeddings\n"
        "from coldrec_tpu_torch.tools import profile_usim\n"
        "for m in ('jax', 'coldrec_tpu'):\n"
        "    assert sys.modules[m] is None\n"
        "cs.sr.SHAPES['tiny'] = dict(n_users=300, n_items=200, n_inter=3000,\n"
        "                            content_dim=16)\n"
        "n = cs.mfstep_phase('cpu', '.', shape='tiny',\n"
        "                    mf=dict(n_users=40, n_items=60, d=8, bs=32),\n"
        "                    scatter=dict(n_items=300, d=8, b=256), k=4,\n"
        "                    flags=('--bs', '128'))\n"
        "assert n == {'fused_sweep': 0, 'fused_sweep_bf16': 0,\n"
        "             'merge_parts': 0}, n\n"
        "rng = np.random.default_rng(0)\n"
        "save_embeddings('tiny_workdir/emb', 'tiny', 'item', 'MF', {\n"
        "    'user_emb': rng.standard_normal((300, 64), np.float32) * .1,\n"
        "    'item_emb': rng.standard_normal((200, 64), np.float32) * .1})\n"
        "tm, _ = profile_usim.build_trainer('tiny_workdir', 'cpu', bs=64,\n"
        "    dataset='tiny', flags=('--usim_max_time', '3', '--usim_k', '4',\n"
        "                           '--usim_content_hidden', '16'))\n"
        "report, n = cs.usim_split_phase(tm, ceiling_iters=2)\n"
        "assert n['fused_sweep'] == 0, n\n"
        "c = report['consistency_check']\n"
        "assert c['sum_of_phases_ms'] > 0, c\n"
        "assert cs.usim_step_split is profile_usim.usim_step_split\n"
        "print('PHASES OK')\n"
    )
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PHASES OK" in proc.stdout
    for line in ("full step :", "grad sorted2:",
                 "chain 64: reps = ", "v2 unique max|err| = ",
                 "equivalence OK over 4 steps", "fused scan:",
                 "  mfstep [cpu]: split (ms a step) full ",
                 "_eval_tables rep 1:", "validation sweep:",
                 "USIM step split at bs 64", "    ppo 5: ",
                 "ceilings: matmul + logsumexp", "consistency: phases sum",
                 "  USIM roofline: {"):
        assert line in proc.stdout, line
