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
from test_torch_threads import THREADS, torch_threads  # noqa: F401

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
    """Run ``code`` with jax and coldrec_tpu blocked from import, on
    ``THREADS`` intra-op threads: torch starts one per core by default, and
    several rehearsals beside the other test workers then thrash the cores
    (four at once on 8 cores passed their 240 s limit)."""
    prelude = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'coldrec_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import torch\n"
        f"torch.set_num_threads({THREADS})\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        env[var] = str(THREADS)
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
        "assert r == {'max_abs_err': 0.0, 'merge_err': 0.0,\n"
        "             'bf16_err': 0.0}, r\n"
        "r = cs.kernel_int('cpu', n_items=3000, sizes=(40, 16))\n"
        "assert r == {'fused_sweep': 0.0, 'merge_parts': 0.0,\n"
        "             'fused_sweep_bf16': 0.0}, r\n"
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
        "t = cs.time_sweep_bf16('cpu', 32, 2000, d=8, reps=1)\n"
        "assert t['bound_by'] == 'bytes' and t['fp32_fma_bound_ms'] > 0, t\n"
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
    assert "kernel bf16 40x1000 d=64" in proc.stdout
    assert "fused_sweep_bf16 bit-equal to its plain version" in proc.stdout
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


def test_training_modules_are_guarded():
    """The training slice's modules are among the files the import guard
    reads."""
    files = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for name in ("main.py", "native.py", "ops/losses.py", "data/sampler.py",
                 "models/warm_base.py", "runtime/trainer.py",
                 "config/base.py", "utils/seeding.py", "utils/logging.py",
                 "tools/profile_train.py", "models/common.py",
                 "models/cold_base.py", "models/dropoutnet.py",
                 "models/gar.py", "models/aldi.py", "models/deepmusic.py",
                 "models/duif.py", "models/heater.py", "data/synthetic.py",
                 "config/model_params.py"):
        assert f"coldrec_tpu_torch/{name}" in files, name


def test_chip_smoke_train_phase_rehearses_on_cpu_without_jax(tmp_path):
    """Phase train at a tiny size on the CPU, with jax and coldrec_tpu
    blocked: the CLI entry trains, validates every epoch, writes the
    result and bus files, and the checks of the phase pass."""
    code = (
        "import chip_smoke as cs\n"
        "for m in ('jax', 'coldrec_tpu'):\n"
        "    assert sys.modules[m] is None\n"
        "n = cs.train_run('cpu', 300, 2000, 8000, d=16, bs=256)\n"
        "assert n == {'fused_sweep': 0, 'merge_parts': 0}, n\n"
        "print('TRAIN OK')\n"
    )
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "TRAIN OK" in proc.stdout
    for line in ("epoch 2: ", "device step", "validation NDCG@20",
                 "trained all:", "20 steps cpu vs cpu"):
        assert line in proc.stdout, line


def _tiny_split_dir(root):
    from coldrec_tpu_torch.data.split import cold_start_split, write_split_dir
    from coldrec_tpu_torch.data.synthetic import synthetic_interactions

    res = cold_start_split(synthetic_interactions(60, 80, 1200, seed=3),
                           cold_object="item", seed=4)
    write_split_dir(res, str(root), "tiny", "item")
    np.save(root / "tiny" / "tiny_item_content.npy",
            np.zeros((res.item_num, 2), np.float32))
    return ["--model", "MF", "--dataset", "tiny", "--data_dir", str(root),
            "--emb_dir", str(root / "emb"), "--epochs", "2", "--bs", "128",
            "--emb_size", "8", "--result_file", str(root / "result.txt")]


def test_cli_runs_as_a_module_without_jax(tmp_path):
    flags = _tiny_split_dir(tmp_path) + ["--device", "cpu"]
    code = (
        "import runpy\n"
        f"sys.argv = ['coldrec_tpu_torch.main'] + {flags!r}\n"
        "runpy.run_module('coldrec_tpu_torch.main', run_name='__main__')\n"
    )
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    text = (tmp_path / "result.txt").read_text()
    assert "--- JSON (machine-readable) ---" in text
    assert (tmp_path / "emb" / "tiny_cold_item_MF_emb.npz").exists()


def test_cli_and_trainer_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would run on it")
    from coldrec_tpu_torch import main as tmain
    from coldrec_tpu_torch.config import default_args, make_args
    from coldrec_tpu_torch.data.synthetic import synthetic_dataset
    from coldrec_tpu_torch.models.mf import MFTrainer
    from coldrec_tpu_torch.runtime.trainer import Config
    from coldrec_tpu_torch.tools import profile_train

    args = make_args(_tiny_split_dir(tmp_path))
    assert args.device == "cuda" and default_args().device == "cuda"
    data, _ = synthetic_dataset(n_users=30, n_items=40, n_inter=300)
    from coldrec_tpu_torch.models import model_factory

    for call in (lambda: tmain.run(args),
                 lambda: MFTrainer(Config(default_args(), data)),
                 lambda: model_factory(Config(default_args(model="GAR"),
                                              data)),
                 lambda: profile_train.main(["--users", "30"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert not (tmp_path / "result.txt").exists()


def test_chip_smoke_cold_phases_rehearse_on_cpu_without_jax(tmp_path):
    """Phases cold and cold-signal at a tiny size on the CPU, with jax and
    coldrec_tpu blocked: phase train leaves its split (item content) and
    MF bus; each cold model runs through the CLI on them, its lists held
    to the plain path, DropoutNet once more under pallas_bf16, then the
    two BatchNorm models' steps device against CPU; cold-signal writes a
    latent split and runs MF and DropoutNet through the CLI, each split on
    the JAX package's route."""
    code = (
        "import tempfile\n"
        "import chip_smoke as cs\n"
        "for m in ('jax', 'coldrec_tpu'):\n"
        "    assert sys.modules[m] is None\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    cs.train_run('cpu', 300, 2000, 8000, d=16, bs=256, root=root,\n"
        "                 content_dim=12)\n"
        "    bf16, per_model = cs.cold_run('cpu', root, d=16, bs=256,\n"
        "                                  steps=3)\n"
        "assert set(per_model) == {m for m, _, _ in cs.COLD_RUNS}\n"
        "assert bf16['fused_sweep_bf16'] == 0, bf16\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    cold = cs.signal_run('cpu', root, 500, 300, 20000,\n"
        "                         content_dim=24, d=16, epochs=2, bs=256)\n"
        "assert set(cold) == {'MF', 'DropoutNet', 'chance'}, cold\n"
        "print('COLD OK')\n"
    )
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "COLD OK" in proc.stdout
    for line in ("item content 12 columns", "ALDI: 1 epoch(s)",
                 "at d=32", "Heater: 1 epoch(s)",
                 "--eval_backend pallas_bf16: 1 epoch",
                 "'overall_val': ['kernel_bf16']",
                 "id-equal to the plain bf16 path all",
                 "DropoutNet: 3 steps cpu vs cpu",
                 "ALDI: 3 steps cpu vs cpu", "latent split written",
                 "users above 1004", "MF: 2 epochs", "DropoutNet: 2 epochs",
                 "chance (N(0,1) tables)", "'cold_test': ['kernel']",
                 "cold NDCG@20, highest first"):
        assert line in proc.stdout, line


GRAPH_MODULES = ("coldrec_tpu_torch.ops.spmm", "coldrec_tpu_torch.ops.kmeans",
                 "coldrec_tpu_torch.models.lightgcn",
                 "coldrec_tpu_torch.models.ngcf",
                 "coldrec_tpu_torch.models.simgcl",
                 "coldrec_tpu_torch.models.xsimgcl",
                 "coldrec_tpu_torch.models.ncl")


def test_graph_modules_import_without_jax(tmp_path):
    """The graph slice's modules are among the files checked above and
    import in a process where jax and coldrec_tpu are blocked."""
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for mod in GRAPH_MODULES:
        assert mod.replace(".", "/") + ".py" in files, mod
    code = "import importlib\n" + "".join(
        f"importlib.import_module({m!r})\n" for m in GRAPH_MODULES) + (
        "from coldrec_tpu_torch.models import TRAINERS\n"
        "assert {'LightGCN', 'NGCF', 'SimGCL', 'XSimGCL', 'NCL'} <= "
        "set(TRAINERS)\n"
        "print('GRAPH IMPORTS OK')\n")
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "GRAPH IMPORTS OK" in proc.stdout


@pytest.mark.parametrize("model", ["LightGCN", "NGCF", "SimGCL", "XSimGCL",
                                   "NCL"])
def test_graph_trainers_default_to_the_card(model):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would run on it")
    from coldrec_tpu_torch.config import default_args
    from coldrec_tpu_torch.data.synthetic import synthetic_dataset
    from coldrec_tpu_torch.models import model_factory
    from coldrec_tpu_torch.ops.spmm import build_ell
    from coldrec_tpu_torch.runtime.trainer import Config

    data, _ = synthetic_dataset(n_users=30, n_items=40, n_inter=300)
    with pytest.raises(RuntimeError, match="cuda"):
        model_factory(Config(default_args(model=model), data))
    with pytest.raises(RuntimeError, match="cuda"):
        build_ell(data.norm_adj)


def test_chip_smoke_graph_phases_rehearse_on_cpu_without_jax(tmp_path):
    """Phases graph, graph-user and graph-ml at a tiny size on the CPU,
    with jax and coldrec_tpu blocked: the five graph models through the CLI
    on an item-cold split (lists held to the plain path, SimGCL's and
    XSimGCL's all-tie cold rows through the exact fallback), NCL's e-step
    and proto steps, the SpMM timed alone; XSimGCL then Heater on its bus
    under user cold start; LightGCN on a latent split and the LightGCN and
    SimGCL steps device against CPU."""
    code = (
        "import tempfile\n"
        "import chip_smoke as cs\n"
        "for m in ('jax', 'coldrec_tpu'):\n"
        "    assert sys.modules[m] is None\n"
        "pairs = cs.synthetic_interactions(300, 2000, 8000, seed=0)\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    cs.write_split(root, 'bx_synth', pairs, 0, 12)\n"
        "    graph, sp = cs.graph_run('cpu', root, d=16, bs=256, steps=3)\n"
        "    user = cs.graph_user_run('cpu', root, 300, 2000, 8000,\n"
        "                             content_dim=24, d=16, bs=256)\n"
        "assert set(graph) == {m for m, _, _ in cs.GRAPH_RUNS}, graph\n"
        "assert set(user) == {'XSimGCL', 'Heater'}, user\n"
        "assert sp['bound_ms'] > 0 and sp['fwd_bwd_ms'] > 0, sp\n"
        "assert 0 < sp['share_of_lightgcn_step'], sp\n"
        "pairs, _, vf = cs.latent_interactions(500, 300, 20000, seed=0)\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    cs.write_split(root, 'ml_latent', pairs, 0, 8,\n"
        "                   cs.latent_content(vf, 8, seed=0))\n"
        "    ml = cs.graph_ml_run('cpu', root, epochs=2, d=16, bs=256,\n"
        "                         steps=3)\n"
        "assert set(ml) == {'LightGCN'}, ml\n"
        "print('GRAPH OK')\n"
    )
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "GRAPH OK" in proc.stdout
    for line in ("fp32 products, TF32 off", "LightGCN (item cold): 1 epoch",
                 "NGCF (item cold): 1 epoch", "NCL e-step on the card",
                 "3 proto steps", "segment_reduce",
                 "torch.sparse.mm (CSR)", "XSimGCL (user cold): 1 epoch",
                 "Heater (user cold): 1 epoch", "user content 24 columns",
                 "LightGCN: 3 steps cpu vs cpu", "SimGCL: 3 steps cpu vs cpu",
                 "id-equal to the plain path all"):
        assert line in proc.stdout, line
    fallback = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("  SimGCL (item cold)")]
    assert fallback and "exact fallback 0 rows" not in fallback[0]


CONTENT_MODULES = ("coldrec_tpu_torch.ops.knn",
                   "coldrec_tpu_torch.models.knn",
                   "coldrec_tpu_torch.models.agnn",
                   "coldrec_tpu_torch.models.vbpr",
                   "coldrec_tpu_torch.models.amr",
                   "coldrec_tpu_torch.models.mtpr",
                   "coldrec_tpu_torch.models.metaembedding",
                   "coldrec_tpu_torch.models.lara",
                   "coldrec_tpu_torch.models.clcrec",
                   "coldrec_tpu_torch.models.gorec",
                   "coldrec_tpu_torch.models.usim")
CONTENT_MODELS = ("KNN", "AGNN", "VBPR", "AMR", "MTPR", "MetaEmbedding",
                  "LARA", "CLCRec", "GoRec", "USIM")


def test_content_modules_import_without_jax(tmp_path):
    """The content slice's modules are among the files checked above and
    import in a process where jax and coldrec_tpu are blocked."""
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for mod in CONTENT_MODULES:
        assert mod.replace(".", "/") + ".py" in files, mod
    code = "import importlib\n" + "".join(
        f"importlib.import_module({m!r})\n" for m in CONTENT_MODULES) + (
        "from coldrec_tpu_torch.models import TRAINERS\n"
        f"assert set({CONTENT_MODELS!r}) <= set(TRAINERS)\n"
        "print('CONTENT IMPORTS OK')\n")
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "CONTENT IMPORTS OK" in proc.stdout


@pytest.mark.parametrize("model", CONTENT_MODELS)
def test_content_trainers_default_to_the_card(model, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would run on it")
    from coldrec_tpu_torch.config import default_args
    from coldrec_tpu_torch.data.synthetic import synthetic_dataset
    from coldrec_tpu_torch.models import model_factory
    from coldrec_tpu_torch.runtime.trainer import Config

    data, _ = synthetic_dataset(n_users=30, n_items=40, n_inter=300)
    with pytest.raises(RuntimeError, match="cuda"):
        model_factory(Config(default_args(model=model, emb_dir=str(tmp_path)),
                             data))


def test_chip_smoke_content_phases_rehearse_on_cpu_without_jax(tmp_path):
    """Phases knn and content at a tiny size on the CPU, with jax and
    coldrec_tpu blocked: knn through both routes on integer and N(0,1)
    tables at three shapes (the kernel route's sweep is the kernel's plain
    version here), then phase train's split and MF bus, and the nine
    content models through the CLI on them (AMR on VBPR's bus), each
    checked, and VBPR's and MetaEmbedding's steps device against CPU."""
    code = (
        "import tempfile\n"
        "import chip_smoke as cs\n"
        "for m in ('jax', 'coldrec_tpu'):\n"
        "    assert sys.modules[m] is None\n"
        "knn = cs.knn_run('cpu', shapes=(('a', 300, 900, 24, 5),\n"
        "                                ('b', 100, 700, 40, 5),\n"
        "                                ('c', 400, 900, 24, 11)))\n"
        "assert set(knn['shapes']) == {'a', 'b', 'c'}, knn\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    cs.train_run('cpu', 300, 2000, 8000, d=16, bs=256, root=root,\n"
        "                 content_dim=12)\n"
        "    per_model = cs.content_run('cpu', root, d=16, bs=256, steps=3)\n"
        "assert set(per_model) == {m for m, _, _ in cs.CONTENT_RUNS}\n"
        "print('CONTENT OK')\n"
    )
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "CONTENT OK" in proc.stdout
    for line in ("knn a 300 x 900 d=24 k=5", "integer tables: ids and "
                 "values bit-equal", "knn c 400 x 900 d=24 k=11",
                 "KNN (item cold): 1 epoch(s)", "AGNN (item cold): 1 epoch(s)",
                 "AMR (item cold): 1 epoch(s)",
                 "GoRec (item cold): 1 epoch(s)", "knn routes",
                 "VBPR: 3 steps cpu vs cpu",
                 "MetaEmbedding: 3 steps cpu vs cpu",
                 "id-equal to the plain path all"):
        assert line in proc.stdout, line


PARALLEL_MODULES = ("coldrec_tpu_torch.parallel.distributed",
                    "coldrec_tpu_torch.parallel.mesh",
                    "coldrec_tpu_torch.parallel.ops",
                    "coldrec_tpu_torch.parallel.dryrun")


def test_parallel_modules_import_without_jax(tmp_path):
    """The process group, mesh, sharded ops and dry run are among the files
    checked above and import in a process where jax and coldrec_tpu are
    blocked; there, with no ``COLDREC_*`` variable, no group opens and the
    dry run's phases run on one rank."""
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for mod in PARALLEL_MODULES:
        assert mod.replace(".", "/") + ".py" in files, mod
    code = "import importlib, os\n" + "".join(
        f"importlib.import_module({m!r})\n" for m in PARALLEL_MODULES) + (
        "from coldrec_tpu_torch.parallel import distributed, dryrun\n"
        "for v in ('COLDREC_COORDINATOR', 'COLDREC_NUM_PROCESSES',\n"
        "          'COLDREC_PROCESS_ID'):\n"
        "    os.environ.pop(v, None)\n"
        "assert distributed.init_distributed(device='cpu') is False\n"
        "res = dryrun.phases('', 'cpu')\n"
        "assert res['serve/ids'].shape == (24, 10), res.keys()\n"
        "print('PARALLEL IMPORTS OK')\n")
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PARALLEL IMPORTS OK" in proc.stdout


SCALE_TOOLS = ("coldrec_tpu_torch.tools.scale_run",
               "coldrec_tpu_torch.tools.ubench_serving",
               "coldrec_tpu_torch.tools.ubench_sweep",
               "coldrec_tpu_torch.tools.ubench_spmm")


def test_scale_and_ubench_tools_import_without_jax(tmp_path):
    """The ports of the JAX tools ``scale_run``, ``ubench_serving``, the
    sweep and SpMM microbenchmarks are among the files checked above and
    import in a process where jax and coldrec_tpu are blocked."""
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for mod in SCALE_TOOLS:
        assert mod.replace(".", "/") + ".py" in files, mod
    code = "import importlib\n" + "".join(
        f"importlib.import_module({m!r})\n" for m in SCALE_TOOLS) + (
        "print('TOOL IMPORTS OK')\n")
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "TOOL IMPORTS OK" in proc.stdout


def test_scale_and_ubench_tools_default_to_the_card(tmp_path):
    """Without ``--device`` each tool asks for the card and, with none,
    raises before it builds, writes or times anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would run on it")
    from coldrec_tpu_torch.tools import (
        scale_run, ubench_serving, ubench_spmm, ubench_sweep,
    )

    tiny = ["--users", "8", "--items", "256", "--d", "8"]
    calls = [
        lambda: scale_run.main(["--model", "MF", "--shape", "xing",
                                "--workdir", str(tmp_path / "w")]),
        lambda: ubench_serving.main(tiny),
        lambda: ubench_serving.main(tiny + ["--device_only"]),
        lambda: ubench_serving.main(tiny + ["--bf16_ab"]),
        lambda: ubench_sweep.main(tiny),
        lambda: ubench_sweep.run("cuda", [8], 256, [8], ["fp32"]),
        lambda: ubench_spmm.main(["--n", "100", "--k", "4"]),
        lambda: ubench_spmm.run_slab("cuda", "ml", 100, 4),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert not (tmp_path / "w").exists()


STEP_TOOLS = ("coldrec_tpu_torch.tools.profile_train",
              "coldrec_tpu_torch.tools.exp_fused_steps",
              "coldrec_tpu_torch.tools.profile_usim")


def test_step_tools_import_without_jax(tmp_path):
    """The ports of the JAX package's MF step tools and USIM tools are among
    the files checked above and import in a process where jax and
    coldrec_tpu are blocked."""
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for mod in STEP_TOOLS:
        assert mod.replace(".", "/") + ".py" in files, mod
    code = "import importlib\n" + "".join(
        f"importlib.import_module({m!r})\n" for m in STEP_TOOLS) + (
        "print('STEP TOOL IMPORTS OK')\n")
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "STEP TOOL IMPORTS OK" in proc.stdout


def test_step_tools_default_to_the_card(tmp_path):
    """Without ``--device`` each mode of each tool asks for the card and,
    with none, raises before it builds, writes or times anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would run on it")
    from coldrec_tpu_torch.tools import (
        exp_fused_steps, profile_train, profile_usim,
    )

    calls = [
        lambda: profile_train.main(["--split"]),
        lambda: profile_train.main(["--chain"]),
        lambda: profile_train.main(["--scatter"]),
        lambda: profile_train.split("cuda", 8, 8, 4, 4, iters=2),
        lambda: profile_train.MFStep("cuda", 8, 8, 4),
        lambda: exp_fused_steps.main(["--workdir", str(tmp_path / "f")]),
        lambda: exp_fused_steps.build_trainer("MF", "xing",
                                              str(tmp_path / "f"), "cuda"),
        lambda: profile_usim.main(["--workdir", str(tmp_path / "u"),
                                   "--out", str(tmp_path / "u.json")]),
        lambda: profile_usim.build_trainer(str(tmp_path / "u"), "cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert not any(tmp_path.iterdir())
