"""The port's CLI runs each reconstruction-family model (CCFCRec, M2VAE,
CGRC, FSGNN) on an item-cold split and writes the JAX CLI's (``main.py``'s)
result schema and bus keys (CGRC's full-graph tables beside its eval
tables), on the CPU; the slice's modules import with JAX blocked, and
``chip_smoke.py``'s phase recon rehearses at a tiny size in a process where
JAX and the JAX package are blocked. The CLI cases stand in for the four
refusal cases of ``test_torch_train.py::test_models_other_than_mf_raise``
that went with the refusal.
"""
import numpy as np
import pytest
import torch

from coldrec_tpu_torch.runtime.checkpoints import load_embeddings
from test_torch_content_cli import _cli, split_dir  # noqa: F401  (fixture)
from test_torch_imports import REPO, _port_files, _run_blocked
from test_torch_recon_models import MODELS, small_flags
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

RECON_MODULES = ("coldrec_tpu_torch.models.ccfcrec",
                 "coldrec_tpu_torch.models.m2vae",
                 "coldrec_tpu_torch.models.cgrc",
                 "coldrec_tpu_torch.models.fsgnn",
                 "coldrec_tpu_torch.native",
                 "coldrec_tpu_torch.data.sampler",
                 "coldrec_tpu_torch.ops.spmm")


def _recon_cli(split_dir, model, tmp_path):
    flags = []
    for k, v in small_flags(model).items():
        flags += [f"--{k}", str(v)]
    return _cli(split_dir, model, tmp_path, flags)


@pytest.mark.parametrize("model", MODELS)
def test_cli_writes_the_jax_schema(split_dir, model, tmp_path):
    """The port's CLI writes ``main.py``'s result schema (the same headers
    and JSON keys, plus ``device``) and the same bus keys, finite, of the
    same shapes."""
    (jh, jp), (th, tp) = _recon_cli(split_dir, model, tmp_path)
    assert th == jh
    assert _key_paths(tp) - _key_paths(jp) == {("hyperparameters",
                                                "device")}
    assert _key_paths(jp) - _key_paths(tp) == set()
    assert tp["method"] == model
    assert np.isfinite(tp["metrics"]["20"]["cold"]["NDCG"]["mean"])
    bus = load_embeddings(str(split_dir / "emb"), "synthds", "item", model)
    jbus = load_embeddings(str(split_dir / "jemb"), "synthds", "item", model)
    assert set(bus) == set(jbus)
    for k, v in bus.items():
        assert v.shape == jbus[k].shape and np.isfinite(v).all(), k


def _key_paths(d, prefix=()):
    out = set()
    for k, v in d.items():
        out.add(prefix + (k,))
        if isinstance(v, dict):
            out |= _key_paths(v, prefix + (k,))
    return out


def test_cgrc_bus_holds_the_full_graph_tables(split_dir, tmp_path):
    """CGRC writes LightGCN over the full training graph of its final
    weights beside its Ĝ eval tables (``extra_saved_tensors``)."""
    from coldrec_tpu_torch.config import default_args
    from coldrec_tpu_torch.models import model_factory
    from coldrec_tpu_torch.models.lightgcn import lightgcn_propagate
    from coldrec_tpu_torch.runtime.trainer import Config

    args = default_args(model="CGRC", dataset="synthds",
                        data_dir=str(split_dir), emb_dir=str(tmp_path),
                        emb_size=8, bs=256, epochs=1, device="cpu",
                        **small_flags("CGRC"))
    tm = model_factory(Config(args))
    tm.run()
    bus = load_embeddings(str(tmp_path), "synthds", "item", "CGRC")
    assert {"user_emb", "item_emb", "user_emb_full",
            "item_emb_full"} == set(bus)
    with torch.no_grad():
        z_u, z_i = lightgcn_propagate(tm.full_graph, tm.model.user_emb,
                                      tm.item_x(), tm.Lf)
    np.testing.assert_array_equal(bus["user_emb_full"], z_u.numpy())
    np.testing.assert_array_equal(bus["item_emb_full"], z_i.numpy())
    assert not np.array_equal(bus["item_emb"], bus["item_emb_full"])


def test_recon_modules_import_without_jax(tmp_path):
    """The slice's modules are among the files the import guard reads and
    import in a process where jax and coldrec_tpu are blocked."""
    files = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for mod in RECON_MODULES:
        assert mod.replace(".", "/") + ".py" in files, mod
    code = "import importlib\n" + "".join(
        f"importlib.import_module({m!r})\n" for m in RECON_MODULES) + (
        "from coldrec_tpu_torch.models import TRAINERS\n"
        f"assert set({MODELS!r}) <= set(TRAINERS)\n"
        "print('RECON IMPORTS OK')\n")
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RECON IMPORTS OK" in proc.stdout


@pytest.mark.parametrize("model", MODELS)
def test_recon_trainers_default_to_the_card(model, tmp_path):
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


def test_chip_smoke_recon_phase_rehearses_on_cpu_without_jax(tmp_path):
    """Phases knn (d) and recon at a tiny size on the CPU, with jax and
    coldrec_tpu blocked: the self-search's first chunk on integer tables
    and the whole search on N(0,1) tables (the kernel route's sweep is the
    kernel's plain version here), then
    phase train's split and MF bus, the four models through the CLI on
    them (narrow CGRC and FSGNN flags for the CPU), each checked, FSGNN's
    graph build and CGRC's evaluations logged, CCFCRec's and M2VAE's steps
    device against CPU, CGRC's top-k users against the CPU's and FSGNN's
    step split."""
    code = (
        "import tempfile\n"
        "import chip_smoke as cs\n"
        "for m in ('jax', 'coldrec_tpu'):\n"
        "    assert sys.modules[m] is None\n"
        "knn = cs.knn_run('cpu', shapes=(('d', 700, 700, 24, 6),))\n"
        "assert set(knn['shapes']) == {'d'}, knn\n"
        "runs = (('CCFCRec', 1, ('--negative_number', '8')),\n"
        "        ('M2VAE', 1, ('--negative_number', '8')),\n"
        "        ('CGRC', 1, ('--cgrc_le_max_edges', '256',\n"
        "                     '--cgrc_mlp_hidden', '16')),\n"
        "        ('FSGNN', 1, ('--fsgnn_knn_k', '5')))\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    cs.train_run('cpu', 300, 2000, 8000, d=16, bs=256, root=root,\n"
        "                 content_dim=12)\n"
        "    per_model = cs.recon_run('cpu', root, runs=runs, d=16, bs=256,\n"
        "                             steps=3, n_check=64)\n"
        "assert set(per_model) == {m for m, _, _ in cs.RECON_RUNS}\n"
        "print('RECON OK')\n"
    )
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RECON OK" in proc.stdout
    for line in ("knn d 700 x 700 d=24 k=6, integer tables: the first 700 "
                 "queries' sweep bit-equal",
                 "knn d 700 x 700 d=24 k=6, N(0,1) tables: rows id-equal",
                 "CCFCRec (item cold): 1 epoch(s)",
                 "M2VAE (item cold): 1 epoch(s)",
                 "CGRC (item cold): 1 epoch(s)",
                 "FSGNN (item cold): 1 epoch(s)",
                 "graph build", "PPR (dense)", "Ĝ rebuild",
                 "CCFCRec: 3 steps cpu vs cpu", "M2VAE: 3 steps cpu vs cpu",
                 "CGRC: peak card memory", "64 rows id-equal",
                 "FSGNN step split", "GAT segment softmax",
                 "id-equal to the plain path all"):
        assert line in proc.stdout, line
