"""The port's BPR and L2 losses and MF's batch loss against the JAX
package's: values and gradients (``jax.value_and_grad`` against torch
autograd) within 1e-6, with and without padded rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coldrec_tpu.ops import losses as jl
from coldrec_tpu_torch.models.mf import MF
from coldrec_tpu_torch.ops import losses as tl
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

TOL = 1e-6


def _inputs(n=64, d=16, n_pad=0, seed=0):
    rng = np.random.default_rng(seed)
    embs = [rng.standard_normal((n, d)).astype(np.float32) * 0.3
            for _ in range(3)]
    w = np.ones(n, np.float32)
    if n_pad:
        w[-n_pad:] = 0.0
    return embs, w


@pytest.mark.parametrize("n_pad", [0, 13])
@pytest.mark.parametrize("weighted", [False, True])
def test_bpr_loss_value_and_grad_match_jax(n_pad, weighted):
    embs, w = _inputs(n_pad=n_pad)
    wj = jnp.asarray(w) if weighted else None
    val, grads = jax.value_and_grad(
        lambda u, p, n: jl.bpr_loss(u, p, n, wj), argnums=(0, 1, 2))(*embs)
    ts = [torch.tensor(e, requires_grad=True) for e in embs]
    out = tl.bpr_loss(*ts, torch.tensor(w) if weighted else None)
    out.backward()
    np.testing.assert_allclose(out.item(), float(val), rtol=TOL, atol=TOL)
    for t, g in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=TOL)
    if weighted and n_pad:
        assert (ts[0].grad[-n_pad:] == 0).all()


@pytest.mark.parametrize("n_pad", [0, 13])
@pytest.mark.parametrize("weighted", [False, True])
def test_l2_reg_loss_value_and_grad_match_jax(n_pad, weighted):
    embs, w = _inputs(n_pad=n_pad, seed=1)
    wj = jnp.asarray(w) if weighted else None
    val, grads = jax.value_and_grad(
        lambda u, p, n: jl.l2_reg_loss(1e-2, u, p, n, weight=wj),
        argnums=(0, 1, 2))(*embs)
    ts = [torch.tensor(e, requires_grad=True) for e in embs]
    out = tl.l2_reg_loss(1e-2, *ts,
                         weight=torch.tensor(w) if weighted else None)
    out.backward()
    np.testing.assert_allclose(out.item(), float(val), rtol=TOL, atol=TOL)
    for t, g in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=TOL)


def test_padded_batch_loss_equals_unpadded_mean():
    embs, w = _inputs(n_pad=13, seed=2)
    ts = [torch.tensor(e) for e in embs]
    real = [t[:-13] for t in ts]
    wt = torch.tensor(w)
    assert torch.allclose(tl.bpr_loss(*ts, wt), tl.bpr_loss(*real),
                          atol=TOL)
    assert torch.allclose(tl.l2_reg_loss(0.5, *ts, weight=wt),
                          tl.l2_reg_loss(0.5, *real), atol=TOL)


def test_mf_batch_loss_and_table_grads_match_jax():
    """MF's loss of a padded batch with repeated ids: the table gradients
    (gather backward, summed per row) equal JAX's."""
    rng = np.random.default_rng(3)
    ue = rng.standard_normal((30, 8)).astype(np.float32) * 0.2
    ie = rng.standard_normal((40, 8)).astype(np.float32) * 0.2
    batch = {"user": rng.integers(0, 30, 96).astype(np.int32),
             "pos_item": rng.integers(0, 40, 96).astype(np.int32),
             "neg_item": rng.integers(0, 40, 96).astype(np.int32),
             "weight": (np.arange(96) < 80).astype(np.float32)}
    reg = 1e-2

    def jloss(params):
        u = params["user_emb"][batch["user"]]
        pos = params["item_emb"][batch["pos_item"]]
        neg = params["item_emb"][batch["neg_item"]]
        w = batch["weight"]
        return jl.bpr_loss(u, pos, neg, w) + jl.l2_reg_loss(
            reg, u, pos, neg, weight=w)

    val, grads = jax.value_and_grad(jloss)({"user_emb": ue, "item_emb": ie})
    mf = MF.from_jax_params({"user_emb": ue, "item_emb": ie}, device="cpu")
    out = mf.loss({k: torch.from_numpy(v) for k, v in batch.items()}, reg)
    out.backward()
    np.testing.assert_allclose(out.item(), float(val), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(mf.user_emb.grad.numpy(),
                               np.asarray(grads["user_emb"]), atol=TOL)
    np.testing.assert_allclose(mf.item_emb.grad.numpy(),
                               np.asarray(grads["item_emb"]), atol=TOL)
