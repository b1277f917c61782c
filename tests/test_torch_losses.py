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


# ------------------------------------------------- parts over data blocks
def _nce_case(n=64, d=16, n_pad=11, seed=4, dtype=np.float32):
    """Two views of a padded unique set and its 0/1 mask."""
    rng = np.random.default_rng(seed)
    v1, v2 = (rng.standard_normal((n, d)).astype(dtype) for _ in range(2))
    valid = (np.arange(n) < n - n_pad).astype(dtype)
    return v1, v2, valid


def _block_parts(fn, n_blocks, *rows, shared=()):
    """``fn`` of each of ``n_blocks`` row blocks of ``rows`` (with the
    block's offset), the blocks' parts summed."""
    n = rows[0].shape[0]
    step = n // n_blocks
    return sum(fn(*(r[i:i + step] for r in rows), *shared, offset=i)
               for i in range(0, n, step))


def test_info_nce_parts_of_the_whole_are_info_nce_masked_bit_for_bit():
    """One block (offset 0, row mask = column mask): the value and the
    gradients of both views are ``info_nce_masked``'s, bit for bit."""
    v1, v2, valid = _nce_case()
    ts = [[torch.tensor(v, requires_grad=True) for v in (v1, v2)]
          for _ in range(2)]
    vt = torch.tensor(valid)
    want = tl.info_nce_masked(*ts[0], vt, 0.2)
    got = tl.info_nce_from_parts(tl.info_nce_parts(*ts[1], 0, vt, vt, 0.2))
    want.backward()
    got.backward()
    assert got.item() == want.item()
    for a, b in zip(ts[0], ts[1]):
        np.testing.assert_array_equal(b.grad.numpy(), a.grad.numpy())


@pytest.mark.parametrize("n_blocks", [2, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_info_nce_parts_add_up_over_anchor_blocks(n_blocks, dtype):
    """Blocks of anchor rows, each against every column with its offset:
    their summed parts give ``info_nce_masked`` of the whole and the JAX
    package's value (float32: sums in another order; float64: to 1e-12)."""
    v1, v2, valid = _nce_case(dtype=dtype)
    a1, a2, vt = torch.tensor(v1), torch.tensor(v2), torch.tensor(valid)

    def part(anchor, row_valid, columns, col_valid, offset):
        return tl.info_nce_parts(anchor, columns, offset, row_valid,
                                 col_valid, 0.2)

    parts = _block_parts(part, n_blocks, a1, vt, shared=(a2, vt))
    got = tl.info_nce_from_parts(parts).item()
    rtol = 1e-6 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, tl.info_nce_masked(a1, a2, vt,
                                                       0.2).item(), rtol=rtol)
    np.testing.assert_allclose(parts[1].item(), valid.sum())
    want = float(jl.info_nce_masked(jnp.asarray(v1, jnp.float32),
                                    jnp.asarray(v2, jnp.float32),
                                    jnp.asarray(valid, jnp.float32), 0.2))
    np.testing.assert_allclose(got, want, rtol=TOL)


def test_info_nce_parts_with_row_masks_is_cgrc_ranking_loss():
    """An (R, C) mask of each row's own columns and no normalisation: the
    form of CGRC's L_R (positives at the first columns, each row's
    denominator over its unrated columns; a row with none drops), blocks
    summed to the whole."""
    rng = np.random.default_rng(5)
    z_u = torch.tensor(rng.standard_normal((32, 8)).astype(np.float32))
    z_b = torch.tensor(rng.standard_normal((48, 8)).astype(np.float32))
    not_rated = torch.tensor(rng.random((32, 48)) > 0.3)
    not_rated[:, :32].fill_diagonal_(False)  # the positive is rated
    not_rated[3] = False  # no candidate: the row drops
    weight = torch.tensor((np.arange(32) < 29).astype(np.float32))
    sim = (z_u @ z_b.T) / 0.25
    le = torch.logsumexp(torch.where(not_rated, sim, torch.full_like(
        sim, torch.finfo(torch.float32).min)), dim=1)
    w = weight * not_rated.any(dim=1)
    want = ((-(torch.diagonal(sim[:, :32]) - le) * w).sum()
            / w.sum().clamp_min(1.0))

    def part(anchor, mask, row_w, offset):
        return tl.info_nce_parts(anchor, z_b, offset, row_w, mask, 0.25,
                                 normalize=False)

    whole = tl.info_nce_from_parts(part(z_u, not_rated, w, 0))
    assert whole.item() == want.item()
    blocks = tl.info_nce_from_parts(_block_parts(part, 4, z_u, not_rated, w))
    np.testing.assert_allclose(blocks.item(), want.item(), rtol=1e-6)


@pytest.mark.parametrize("l2_neg", [True, False])
def test_bpr_l2_parts_with_and_without_neg(l2_neg):
    """``bpr_l2_parts(..., l2_neg)``: the whole batch's parts give
    ``bpr_loss + l2_reg_loss(u, pos[, neg])`` bit for bit, values and
    gradients; blocks of rows summed give it within float32's rounding."""
    embs, w = _inputs(n_pad=13, seed=6)
    ts = [[torch.tensor(e, requires_grad=True) for e in embs]
          for _ in range(2)]
    wt = torch.tensor(w)
    u, pos, neg = ts[0]
    want = tl.bpr_loss(u, pos, neg, wt) + tl.l2_reg_loss(
        1e-2, *((u, pos, neg) if l2_neg else (u, pos)), weight=wt)
    parts = tl.bpr_l2_parts(*ts[1], wt, l2_neg=l2_neg)
    assert parts.shape == (5 if l2_neg else 4,)
    got = tl.bpr_l2_from_parts(parts, 1e-2)
    want.backward()
    got.backward()
    assert got.item() == want.item()
    for a, b in zip(ts[0], ts[1]):
        np.testing.assert_array_equal(b.grad.numpy(), a.grad.numpy())

    def part(u, pos, neg, w, offset):
        return tl.bpr_l2_parts(u, pos, neg, w, l2_neg=l2_neg)

    blocks = tl.bpr_l2_from_parts(_block_parts(
        part, 4, *(torch.tensor(e) for e in embs), wt), 1e-2)
    np.testing.assert_allclose(blocks.item(), want.item(), rtol=1e-6)
