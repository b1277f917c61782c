"""The port stands alone: no file of ``coldrec_tpu_torch/`` and not
``chip_smoke.py`` imports JAX or the JAX package, the chip script's phases
run in a process where both are blocked from import, every entry point
defaults to the card and raises without one, and ``chip_smoke.py`` itself
exits non-zero with no result line when there is no card or no package."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "coldrec_tpu", "optax", "flax")


def _port_files():
    files = sorted((REPO / "coldrec_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant):
                    yield str(arg.value).split(".")[0]


def test_no_jax_imports_in_port():
    files = _port_files()
    assert len(files) > 10
    offenders = [
        f"{p.relative_to(REPO)}: {root}"
        for p in files for root in _imported_roots(p) if root in BANNED
    ]
    assert not offenders, offenders


def _run_blocked(code, tmp_path, timeout=240):
    """Run ``code`` with jax and coldrec_tpu blocked from import."""
    prelude = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'coldrec_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-c", prelude + code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=timeout,
    )


def test_chip_smoke_phases_rehearse_on_cpu_without_jax(tmp_path):
    """The same phase functions the card run calls, on the CPU at a tiny
    size, in a process where importing jax or coldrec_tpu fails."""
    code = (
        "import chip_smoke as cs\n"
        "for m in ('jax', 'coldrec_tpu'):\n"
        "    assert sys.modules[m] is None\n"
        "r = cs.kernel_vs_plain('cpu', 48, 2000, d=16)\n"
        "assert r['max_abs_err'] == 0.0 and r['rows'] == 48, r\n"
        "r = cs.kernel_vs_plain('cpu', 16, 300, d=8, k=10, r=4)\n"
        "r = cs.kernel_ml('cpu', 40, 1000)\n"
        "assert r == {'max_abs_err': 0.0, 'merge_err': 0.0}, r\n"
        "r = cs.kernel_int('cpu', n_items=3000, sizes=(40, 16))\n"
        "assert r == {'fused_sweep': 0.0, 'merge_parts': 0.0}, r\n"
        "n = cs.slice_run('cpu', 300, 2000, 8000, d=16, n_requests=2,\n"
        "                 request_size=32)\n"
        "assert n == {'fused_sweep': 0, 'merge_parts': 0}, n\n"
        "t = cs.time_merge('cpu', 16, 2000, d=8, reps=1)\n"
        "assert t['bound_by'] == 'bytes' and t['parts'] == 4, t\n"
        "v = cs.variants_run('cpu', 32, 6144, d=8, blocks=(128, 256),\n"
        "                    tiles=(8, 16), check_users=16,\n"
        "                    check_items=2048)\n"
        "assert set(v) == set(cs.VARIANTS), v\n"
        "assert all(r == {'launches': 0, 'max_abs_err': 0.0}\n"
        "           for r in v.values()), v\n"
        "t = cs.time_variants('cpu', 32, 1024, d=8, blocks=(128, 256),\n"
        "                     tiles=(8, 16), reps=1)\n"
        "assert all(r['bound_ms'] > 0 and r['ms'] > 0 for r in t.values())\n"
        "print('REHEARSAL OK')\n"
    )
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "REHEARSAL OK" in proc.stdout
    assert "[all setting]" in proc.stdout
    assert "host split (all setting" in proc.stdout
    assert "merge_parts bit-equal at 4 parts" in proc.stdout
    assert "falling table tile_u=16 floor=rv[0]" in proc.stdout
    assert "NaN table P=8 block_i=384" in proc.stdout
    assert "NaN table tile_u=16 floor=rv[0]" in proc.stdout
    blocked = _run_blocked("import jax\n", tmp_path)
    assert blocked.returncode != 0  # the block really holds


def _no_result(proc):
    return proc.returncode != 0 and '"ok": true' not in proc.stdout


def test_chip_smoke_without_card_or_package_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the CPU-only exit")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=240)
    assert _no_result(proc), proc.stdout + proc.stderr
    assert "torch.cuda.is_available() is False" in proc.stderr
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert _no_result(proc), proc.stdout + proc.stderr
    assert "coldrec_tpu_torch" in proc.stderr


def test_entry_points_default_to_the_card():
    """Called without ``device=``, every entry point asks for the card and,
    with none, raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would run on it")
    from coldrec_tpu_torch.data.synthetic import synthetic_dataset
    from coldrec_tpu_torch.device import resolve_device
    from coldrec_tpu_torch.models.mf import MF
    from coldrec_tpu_torch.ops.cuda.retrieval import retrieval_topk
    from coldrec_tpu_torch.runtime.eval import EvalSweep
    from coldrec_tpu_torch.runtime.serving import RetrievalServer
    from coldrec_tpu_torch.runtime.trainer import three_way_test

    from coldrec_tpu_torch.tools import exp_blockskip as ebs
    from coldrec_tpu_torch.tools import exp_multiacc as ema
    from coldrec_tpu_torch.tools import exp_retrieval_kernels as erk
    from coldrec_tpu_torch.tools import tile_shapes

    data, _ = synthetic_dataset(n_users=30, n_items=40, n_inter=300)
    ue = np.zeros((data.user_num, 4), np.float32)
    ie = np.zeros((data.item_num, 4), np.float32)
    tiny = ["--users", "8", "--items", "256"]
    calls = [
        lambda: erk.main(tiny),
        lambda: ema.main(tiny),
        lambda: ema.main(["--check"]),
        lambda: ebs.main(tiny),
        lambda: ema.make_inputs(8, 256, 8, 128),
        lambda: ema.check(8, 256, 8, 128),
        lambda: ema.bench(8, 256, 8, 128),
        lambda: ebs._pad_inputs(ue, ie, 8, 128),
        lambda: ebs.check_exact(ue, ie, np.zeros((data.user_num, 1)), 8, 128,
                                0),
        lambda: ebs.bench(ebs.skip_sweep, ue, ie, 8, 128),
        lambda: tile_shapes.main(["--users", "8"]),
        lambda: resolve_device(),
        lambda: MF(10, 10, 4),
        lambda: MF.from_jax_params({"user_emb": ue, "item_emb": ie}),
        lambda: EvalSweep(data, "item", 16, 10),
        lambda: RetrievalServer(ue, ie),
        lambda: three_way_test(data, ue, ie, verbose=False),
        lambda: retrieval_topk(ue[:2], ie, np.full((2, 1), 40), np.zeros(
            40, bool), 5),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_cuda_tensor_never_falls_back_to_plain():
    """A tensor on the card goes to the kernel or raises; with no card
    there is no CUDA tensor, so the wrapper refuses other devices."""
    from coldrec_tpu_torch.ops.cuda import retrieval as tret

    users = torch.zeros((2, 4), device="meta")
    items_t = torch.zeros((4, 128), device="meta")
    excl = torch.zeros(128, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no retrieval kernel"):
        tret.fused_sweep(users, items_t, excl)
