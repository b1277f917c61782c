"""``chip_smoke.py``'s phases serving and ubench rehearsed on the CPU at a
tiny size, in a process where importing jax or coldrec_tpu fails
(``test_torch_imports._run_blocked``): ``ubench_serving`` in its three
modes (the bf16 A/B on a bus file), ``ubench_sweep``'s point after the
integer check, ``ubench_spmm`` on a small slab, and every check of the
phases."""
from test_torch_imports import _run_blocked
from test_torch_threads import torch_threads  # noqa: F401  (autouse)


def test_chip_smoke_serving_and_ubench_phases_rehearse_on_cpu(tmp_path):
    code = (
        "import numpy as np\n"
        "import chip_smoke as cs\n"
        "from coldrec_tpu_torch.runtime.checkpoints import save_embeddings\n"
        "for m in ('jax', 'coldrec_tpu'):\n"
        "    assert sys.modules[m] is None\n"
        "rng = np.random.default_rng(5)\n"
        "bus = save_embeddings('.', 'x', 'item', 'MF', {\n"
        "    'user_emb': rng.standard_normal((200, 16), np.float32),\n"
        "    'item_emb': rng.standard_normal((230, 16), np.float32)})\n"
        "n = cs.serving_phase('cpu', bus, iters=2, flags=(\n"
        "    '--users', '300', '--items', '240', '--d', '16'))\n"
        "assert n['fused_sweep'] == 0, n\n"
        "point, spmm, n = cs.ubench_phase('cpu', users=64, items=3000,\n"
        "                                 d=32, slabs={'ml': (2000, 16)},\n"
        "                                 iters=1)\n"
        "line = cs.ubench_line(point, 'bf16')\n"
        "assert line['max_abs_err'] == 0.0 and line['d'] == 32, line\n"
        "assert set(spmm) == {'ml'}, spmm\n"
        "print('UBENCH OK')\n"
    )
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "UBENCH OK" in proc.stdout
    for line in ("e2e bs 4096: lists id-equal to the plain path on "
                 "4096/4096", "bs= 1024  cpu=", "bf16 speedup:",
                 "bf16 lists on the bus tables id-equal to the plain bf16 "
                 "path on 4096/4096; drift recounted",
                 "fused_sweep bf16 bit-equal to its plain version",
                 "kernel_padded        bf16", "slab ml: n=2000 k=16",
                 "sparse_mm"):
        assert line in proc.stdout, line
