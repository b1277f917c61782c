"""The port's MF step tools held against the JAX package's, on the CPU at a
tiny size: ``profile_train``'s sorted lookup and split bodies against the
JAX ``lookup`` (``tools/exp_mf_step_decomp.py``) and bodies built from
``coldrec_tpu``'s ``adam``, ``bpr_loss`` and ``l2_reg_loss``; its scatter
variants against ``tools/exp_scatter_variants.py``'s and ``np.add.at``;
``exp_fused_steps``' equivalence on ``scale_run``'s tiny shape, its batches
the JAX trainer's, and its refusals the JAX tool's assertion.
(``tools/check_mfstep.py`` and ``tools/exp_grad_sorted.py`` time when
imported, so their bodies are rebuilt here from the same functions.)"""
import itertools

import exp_mf_step_decomp as jax_decomp  # tools/ is on sys.path (conftest)
import exp_scatter_variants as jax_scatter
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

from coldrec_tpu.config import default_args as jargs
from coldrec_tpu.data.builder import ColdStartDataset as JDataset
from coldrec_tpu.models import AVAILABLE_MODELS, model_factory as jfactory
from coldrec_tpu.models.common import adam
from coldrec_tpu.ops.losses import bpr_loss, l2_reg_loss
from coldrec_tpu.runtime.trainer import Config as JConfig
from coldrec_tpu_torch.data.builder import ColdStartDataset
from coldrec_tpu_torch.runtime.checkpoints import save_embeddings
from coldrec_tpu_torch.tools import exp_fused_steps as efs
from coldrec_tpu_torch.tools import profile_train as pt
from coldrec_tpu_torch.tools import scale_run as sr

U, I, D, BS = 40, 60, 8, 32
RTOL = 1e-6
STEP_RTOL = 1e-5
TINY = dict(n_users=300, n_items=200, n_inter=3000, content_dim=16)


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    return {"user_emb": rng.standard_normal((U, D)).astype(np.float32) * 0.1,
            "item_emb": rng.standard_normal((I, D)).astype(np.float32) * 0.1}


def _jax_batch(xs, i):
    return {k: jnp.asarray(v[i].numpy()) for k, v in xs.items()}


def _jax_loss(lookup):
    def loss_fn(p, b):
        u = lookup(p["user_emb"], b["user"])
        pos = lookup(p["item_emb"], b["pos_item"])
        neg = lookup(p["item_emb"], b["neg_item"])
        w = b["weight"]
        return bpr_loss(u, pos, neg, w) + l2_reg_loss(pt.REG, u, pos, neg,
                                                      weight=w)
    return loss_fn


def _assert_tables(step, params, rtol):
    for name in ("user_emb", "item_emb"):
        np.testing.assert_allclose(
            getattr(step.model, name).detach().numpy(),
            np.asarray(params[name]), rtol=rtol, atol=rtol * 1e-2,
            err_msg=name)


@pytest.mark.parametrize("shape", [(200,), (8, 25)])
def test_sorted_lookup_matches_plain_and_jax(shape):
    """Forward = plain indexing; the table's gradient = plain indexing's
    and = the JAX ``lookup``'s, on ids with repeats."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((30, D)).astype(np.float32)
    ids = rng.integers(0, 30, shape).astype(np.int32)
    ct = rng.standard_normal(shape + (D,)).astype(np.float32)
    assert len(np.unique(ids)) < ids.size  # repeats
    grads = []
    for lookup in (pt.sorted_lookup, lambda t, i: t[i]):
        t = torch.tensor(table, requires_grad=True)
        out = lookup(t, torch.as_tensor(ids))
        np.testing.assert_array_equal(out.detach().numpy(), table[ids])
        out.backward(torch.as_tensor(ct))
        grads.append(t.grad.numpy())
    _, vjp = jax.vjp(lambda t: jax_decomp.lookup(t, jnp.asarray(ids)),
                     jnp.asarray(table))
    (jgrad,) = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(grads[0], grads[1], rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(grads[0], np.asarray(jgrad), rtol=RTOL,
                               atol=1e-7)


def test_split_bodies_match_jax():
    """Each body against the JAX decomposition's, from the same tables and
    batches: the full step (plain and sorted lookup) after 3 steps, Adam
    only after 3 updates, grad only's gradients, forward only's loss."""
    xs = pt.mf_batches(3, "cpu", U, I, BS)
    tables = _tables()
    params = {k: jnp.asarray(v) for k, v in tables.items()}
    optimizer = adam(pt.LR)
    loss_fn = _jax_loss(lambda t, i: t[i])

    # forward only and grad only, on batch 0
    step = pt.MFStep("cpu", U, I, D, tables=tables)
    jloss, jgrads = jax.value_and_grad(loss_fn)(params, _jax_batch(xs, 0))
    assert float(step.forward_only(pt.batch_at(xs, 0))) == pytest.approx(
        float(jloss), rel=RTOL)
    step.grad_only(pt.batch_at(xs, 0))
    for p, name in zip(step.params, ("user_emb", "item_emb")):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[name]),
                                   rtol=STEP_RTOL, atol=1e-9, err_msg=name)

    # the full step, both lookups, against JAX's with its own lookup each
    for body, lookup in (("full", lambda t, i: t[i]),
                         ("full_sorted", jax_decomp.lookup)):
        step = pt.MFStep("cpu", U, I, D, tables=tables)
        p, o = params, optimizer.init(params)
        for i in range(3):
            getattr(step, body)(pt.batch_at(xs, i))
            _, g = jax.value_and_grad(_jax_loss(lookup))(p, _jax_batch(xs, i))
            upd, o = optimizer.update(g, o, p)
            p = optax.apply_updates(p, upd)
        _assert_tables(step, p, STEP_RTOL)

    # Adam only on fixed dense gradients of 1e-3
    step = pt.MFStep("cpu", U, I, D, tables=tables)
    fixed = jax.tree.map(lambda x: 1e-3 * jnp.ones_like(x), params)
    p, o = params, optimizer.init(params)
    for _ in range(3):
        step.adam_only()
        upd, o = optimizer.update(fixed, o, p)
        p = optax.apply_updates(p, upd)
    _assert_tables(step, p, STEP_RTOL)


def test_mf_batches_are_the_jax_tools_draws():
    """``default_rng(3)``: users, then positives, then negatives."""
    rng = np.random.default_rng(3)
    want = [rng.integers(0, hi, (4, BS), dtype=np.int32)
            for hi in (U, I, I)]
    got = pt.mf_batches(4, "cpu", U, I, BS)
    for key, w in zip(("user", "pos_item", "neg_item"), want):
        np.testing.assert_array_equal(got[key].numpy(), w)
    assert got["weight"].dtype == torch.float32
    assert bool((got["weight"] == 1).all())


def test_split_and_chain_run_on_cpu():
    out = pt.split("cpu", U, I, D, BS, iters=4, repeats=1)
    assert set(out) == {"full", "full_sorted", "grad_only", "adam_only",
                        "forward_only", "grad_plain", "grad_sorted",
                        "grad_plain2", "grad_sorted2"}
    assert all(np.isfinite(v) for v in out.values())
    chain = pt.chain("cpu", U, I, D, BS, sizes=(4, 2), reps=2)
    assert list(chain) == [4, 2]
    assert all(ts == sorted(ts) and len(ts) == 2 for ts in chain.values())


def test_scatter_variants_match_jax_and_add_at(monkeypatch):
    """v0, v1 and v2 against the JAX tool's (its globals at 300 items,
    256 rows and width 8) and ``np.add.at``, with duplicates forced; the
    gather's backward is autograd's of ``table[idx]``."""
    n_items, b = 300, 256
    monkeypatch.setattr(jax_scatter, "N_ITEMS", n_items)
    monkeypatch.setattr(jax_scatter, "B", b)
    monkeypatch.setattr(jax_scatter, "DIM", D)
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 40, b, dtype=np.int32)
    idx[:8] = 7  # one long run
    g = rng.standard_normal((b, D)).astype(np.float32)
    ref = np.zeros((n_items, D), np.float32)
    np.add.at(ref, idx, g)
    x = {"idx": jnp.asarray(idx), "g": jnp.asarray(g)}
    ti, tg = torch.as_tensor(idx).long(), torch.as_tensor(g)
    for port, jfn in ((pt.scatter_v0, jax_scatter.v0),
                      (pt.scatter_v1, jax_scatter.v1),
                      (pt.scatter_v2, jax_scatter.v2)):
        got = port(ti, tg, n_items).numpy()
        want = np.asarray(jax.jit(jfn)(x))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=port.__name__)
        assert np.abs(got - ref).max() < pt.SCATTER_TOL, port.__name__
    table = torch.zeros((n_items, D), requires_grad=True)
    table[ti].backward(tg)
    np.testing.assert_array_equal(
        pt.scatter_gather_backward(ti, tg, n_items).numpy(),
        table.grad.numpy())


def test_scatter_tool_holds_add_at(monkeypatch):
    """The tool checks every variant before it times them; a miss fails
    it."""
    out = pt.scatter("cpu", n_items=300, d=D, b=256, iters=4, repeats=1)
    assert set(out) == {name for name, _ in pt.SCATTERS}
    assert all(v["max_abs_err"] < pt.SCATTER_TOL for v in out.values())
    wrong = (("v1 sorted", lambda i, g, n: pt.scatter_v1(i, g, n) + 1e-2),)
    monkeypatch.setattr(pt, "SCATTERS", pt.SCATTERS[:1] + wrong)
    with pytest.raises(AssertionError, match="v1 sorted"):
        pt.scatter("cpu", n_items=300, d=D, b=256, iters=4, repeats=1)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """``scale_run``'s dataset at the tiny shape (as
    ``tests/test_torch_scale_run.py`` builds it) and a random MF bus."""
    monkeypatch.setitem(sr.SHAPES, "tiny", TINY)
    work = str(tmp_path / "work")
    sr.build_dataset(work, "tiny")
    data = ColdStartDataset.from_split_dir(f"{work}/data", "tiny", "item")
    rng = np.random.default_rng(0)
    save_embeddings(f"{work}/emb", "tiny", "item", "MF", {
        "user_emb": rng.standard_normal((data.user_num, 64), np.float32),
        "item_emb": rng.standard_normal((data.item_num, 64), np.float32)})
    return work


@pytest.mark.parametrize("model", ["MF", "LightGCN"])
def test_fused_steps_equivalence_on_tiny_shape(tiny, model, capsys):
    tm = efs.build_trainer(model, "tiny", tiny, "cpu",
                           flags=("--bs", "128"))
    out = efs.run(tm, k=4, iters=1)
    assert out["k"] == 4 and out["bs"] == 128
    assert out["loss_max_rel"] <= efs.LOSS_RTOL
    assert out["sequential_ms"] > 0 and out["fused_ms"] > 0
    printed = capsys.readouterr().out
    assert "equivalence OK over 4 steps (losses + final params)" in printed
    assert f"model={model} shape=tiny K=4 B=128" in printed
    for line in ("sequential:", "fused scan:", "speedup:"):
        assert line in printed


def test_fused_steps_batches_are_the_jax_trainers(tiny):
    """The K batches come from the trainer's own sampler: the JAX MF
    trainer's first K on the same split, bit for bit."""
    tm = efs.build_trainer("MF", "tiny", tiny, "cpu", flags=("--bs", "128"))
    jd = JDataset.from_split_dir(f"{tiny}/data", "tiny", "item")
    jm = jfactory(JConfig(jargs(model="MF", dataset="tiny", bs=128,
                                emb_dir=f"{tiny}/emb"), jd))
    for got, want in zip(itertools.islice(tm.batches(), 4),
                         itertools.islice(jm.batches(), 4)):
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("model", ["MF", "LightGCN", "SimGCL", "XSimGCL",
                                   "DropoutNet"])
def test_refusal_follows_the_jax_tools_assertion(tiny, model):
    """Refused where the JAX model is ``stateful`` or ``uses_rng_in_loss``
    (DropoutNet: stateful; SimGCL, XSimGCL: noise in the loss)."""
    jcls = AVAILABLE_MODELS[model]
    jax_refuses = bool(jcls.stateful or jcls.uses_rng_in_loss)
    tm = efs.build_trainer(model, "tiny", tiny, "cpu", flags=("--bs", "128"))
    batch = next(iter(tm.batches()))
    state = tm.generator.get_state()
    assert (efs.refusal(tm, batch) is not None) == jax_refuses
    assert torch.equal(state, tm.generator.get_state())  # put back
    if jax_refuses:
        with pytest.raises(ValueError, match="plain warm-backbone step"):
            efs.run(tm, k=2, iters=1)
