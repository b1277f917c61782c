"""BPR, L2, MSE and contrastive losses on tensors, weighted for padding
(the port's copy of ``bpr_loss``, ``l2_reg_loss``, ``mse_loss``,
``_wmean``, ``_normalize``, ``unique_padded`` and ``info_nce_masked`` from
``coldrec_tpu/ops/losses.py``, and the BCE-with-logits that MetaEmbedding
and LARA write inline there; reference ColdRec util/utils.py:25-76).

Every batch has a fixed row count; the last batch of an epoch is padded and
carries ``weight`` (1.0 real / 0.0 pad), so the weighted mean equals the
reference's mean over the real rows.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_BPR_EPS = 1e-5  # reference writes 10e-6 (utils.py:28)


def _wmean(x: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    if weight is None:
        return x.mean()
    return (x * weight).sum() / weight.sum().clamp_min(1.0)


def bpr_loss(
    user_emb: torch.Tensor,
    pos_item_emb: torch.Tensor,
    neg_item_emb: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """-log(eps + sigmoid(pos - neg)) averaged (utils.py:25-29)."""
    pos_score = (user_emb * pos_item_emb).sum(dim=1)
    neg_score = (user_emb * neg_item_emb).sum(dim=1)
    loss = -torch.log(_BPR_EPS + torch.sigmoid(pos_score - neg_score))
    return _wmean(loss, weight)


def l2_reg_loss(
    reg: float, *embs: torch.Tensor, weight: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """reg * sum_e ||e||_F / batch (utils.py:44-48).

    With padding, pad rows are zeroed before the norm and the divisor is the
    real row count, which reproduces the un-padded value exactly."""
    total = 0.0
    for emb in embs:
        if weight is not None:
            emb = emb * weight.reshape((-1,) + (1,) * (emb.dim() - 1))
            denom = weight.sum().clamp_min(1.0)
        else:
            denom = emb.shape[0]
        total = total + (emb * emb).sum().sqrt() / denom
    return total * reg


def bpr_l2_parts(
    user_emb: torch.Tensor,
    pos_item_emb: torch.Tensor,
    neg_item_emb: torch.Tensor,
    weight: torch.Tensor,
) -> torch.Tensor:
    """The additive sums of a padded batch's BPR + L2 loss, stacked:
    [sum w * bpr, sum w, sum (w u)^2, sum (w pos)^2, sum (w neg)^2].

    Summed over the blocks of a batch split across ranks they are the whole
    batch's sums, which :func:`bpr_l2_from_parts` turns into the loss; the
    L2 term is a square root of a sum, so the loss itself does not add up
    over blocks."""
    pos_score = (user_emb * pos_item_emb).sum(dim=1)
    neg_score = (user_emb * neg_item_emb).sum(dim=1)
    bpr = -torch.log(_BPR_EPS + torch.sigmoid(pos_score - neg_score))
    w = weight.reshape(-1, 1)
    return torch.stack([(bpr * weight).sum(), weight.sum()] + [
        ((e * w) * (e * w)).sum()
        for e in (user_emb, pos_item_emb, neg_item_emb)])


def bpr_l2_from_parts(parts: torch.Tensor, reg: float) -> torch.Tensor:
    """``bpr_loss + l2_reg_loss(reg, u, pos, neg)`` (both weighted) from
    :func:`bpr_l2_parts`, in the same operations and order, so a whole
    batch's parts give the same value."""
    denom = parts[1].clamp_min(1.0)
    total = 0.0
    for sq in parts[2:]:
        total = total + sq.sqrt() / denom
    return parts[0] / denom + total * reg


def mse_loss(
    pred: torch.Tensor, target: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Elementwise-mean MSE (utils.py:32-34); with ``weight`` the mean over
    the real rows' elements."""
    sq = (pred - target) ** 2
    if weight is None:
        return sq.mean()
    w = weight.reshape((-1,) + (1,) * (sq.dim() - 1))
    return (sq * w).sum() / (w.sum() * sq.shape[-1]).clamp_min(1.0)


def bce_with_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy of ``logits`` against ``targets``,
    in the stable form max(x, 0) - x * t + log1p(exp(-|x|))."""
    return (logits.clamp_min(0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def _normalize(x: torch.Tensor, dim: int = -1,
               eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) (``F.normalize``)."""
    return F.normalize(x, dim=dim, eps=eps)


def unique_padded(ids: torch.Tensor, weight: Optional[torch.Tensor],
                  size: int, sentinel: int):
    """Static-shape unique: returns (safe_ids, valid_mask), both of length
    ``size`` (>= len(ids)).

    The reference calls ``torch.unique`` on the batch ids before its CL
    losses (SimGCL.py:54-55); on the card that returns a data-dependent
    size and waits for the device every step. Here the ids of the weight-0
    rows become ``sentinel`` (greater than every id), the ids are sorted,
    the first of each run is kept and packed to the front by a prefix sum:
    the ascending uniques, then pad entries (id 0, mask 0), as
    ``jnp.unique(size=size, fill_value=sentinel)`` and a mask give."""
    if weight is not None:
        ids = torch.where(weight > 0, ids, torch.full_like(ids, sentinel))
    s = torch.sort(ids).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    keep = first & (s != sentinel)
    # kept ids to their rank among the kept, the others to a spill slot
    slot = torch.where(keep, torch.cumsum(keep, 0) - 1,
                       torch.full_like(s, size))
    out = torch.zeros(size + 1, dtype=ids.dtype, device=ids.device)
    out.scatter_(0, slot, torch.where(keep, s, torch.zeros_like(s)))
    mask = torch.zeros(size + 1, dtype=torch.float32, device=ids.device)
    mask.scatter_(0, slot, keep.float())
    return out[:size], mask[:size]


def info_nce_masked(view1: torch.Tensor, view2: torch.Tensor,
                    valid: torch.Tensor, temperature: float) -> torch.Tensor:
    """InfoNCE over a padded unique batch: padded rows are dropped and
    padded columns are excluded from every denominator, which is the
    reference's InfoNCE on the unpadded unique set; the order of the
    unique ids does not matter."""
    v1 = _normalize(view1)
    v2 = _normalize(view2)
    logits = (v1 @ v2.T) / temperature
    neg_inf = torch.finfo(logits.dtype).min
    logits = torch.where(valid[None, :] > 0, logits,
                         torch.full_like(logits, neg_inf))
    log_prob = torch.diagonal(logits) - torch.logsumexp(logits, dim=1)
    return -_wmean(torch.where(valid > 0, log_prob,
                               torch.zeros_like(log_prob)), valid)
