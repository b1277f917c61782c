"""BPR, L2, MSE and contrastive losses on tensors, weighted for padding
(the port's copy of ``bpr_loss``, ``l2_reg_loss``, ``mse_loss``,
``_wmean``, ``_normalize``, ``unique_padded`` and ``info_nce_masked`` from
``coldrec_tpu/ops/losses.py``, and the BCE-with-logits that MetaEmbedding
and LARA write inline there; reference ColdRec util/utils.py:25-76).

Every batch has a fixed row count; the last batch of an epoch is padded and
carries ``weight`` (1.0 real / 0.0 pad), so the weighted mean equals the
reference's mean over the real rows.

A batch split over the data axis of a mesh sums additive parts before the
loss: ``bpr_l2_parts`` (BPR and the L2 terms, whose square roots do not add
up over blocks), ``wmean_parts`` (any weighted mean: ``_wmean``,
``mse_loss``, a BCE or KL mean), ``bpr_parts``, ``l2_parts`` and
``info_nce_parts`` (an InfoNCE whose denominators run over every column of
the global batch: a block of anchor rows scored against all columns adds
up as (sum -log p * valid, sum valid)). Each ``*_from_parts`` repeats its
one-device function's operations in their order, so one block's parts
give that function's value bit for bit.
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


def wmean_parts(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """[sum x * w, sum w * (elements of a row)], ``weight`` one value per
    row: the additive parts of a weighted mean over the real rows' elements
    (``_wmean`` of a (B,) ``x``, ``mse_loss`` and the BCE and KL means of a
    (B, d) one)."""
    w = weight.reshape((-1,) + (1,) * (x.dim() - 1))
    count = w.sum()
    if x.dim() > 1:
        count = count * x.shape[-1]
    return torch.stack([(x * w).sum(), count])


def wmean_from_parts(parts: torch.Tensor) -> torch.Tensor:
    """The weighted mean of :func:`wmean_parts` (summed over the blocks)."""
    return parts[0] / parts[1].clamp_min(1.0)


def bpr_parts(
    user_emb: torch.Tensor,
    pos_item_emb: torch.Tensor,
    neg_item_emb: torch.Tensor,
    weight: torch.Tensor,
) -> torch.Tensor:
    """:func:`wmean_parts` of :func:`bpr_loss`'s terms:
    ``wmean_from_parts`` of them is ``bpr_loss(..., weight)``."""
    pos_score = (user_emb * pos_item_emb).sum(dim=1)
    neg_score = (user_emb * neg_item_emb).sum(dim=1)
    loss = -torch.log(_BPR_EPS + torch.sigmoid(pos_score - neg_score))
    return wmean_parts(loss, weight)


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
    l2_neg: bool = True,
) -> torch.Tensor:
    """The additive sums of a padded batch's BPR + L2 loss, stacked:
    [sum w * bpr, sum w, sum (w u)^2, sum (w pos)^2, sum (w neg)^2], the
    last left out where ``l2_neg`` is False (SimGCL and XSimGCL regularise
    ``u`` and ``pos`` only).

    Summed over the blocks of a batch split across ranks they are the whole
    batch's sums, which :func:`bpr_l2_from_parts` turns into the loss; the
    L2 term is a square root of a sum, so the loss itself does not add up
    over blocks."""
    embs = (user_emb, pos_item_emb) + ((neg_item_emb,) if l2_neg else ())
    return torch.cat([bpr_parts(user_emb, pos_item_emb, neg_item_emb, weight),
                      l2_parts(*embs, weight=weight)])


def bpr_l2_from_parts(parts: torch.Tensor, reg: float) -> torch.Tensor:
    """``bpr_loss + l2_reg_loss(reg, u, pos[, neg])`` (both weighted) from
    :func:`bpr_l2_parts`, in the same operations and order, so a whole
    batch's parts give the same value."""
    denom = parts[1].clamp_min(1.0)
    return parts[0] / denom + l2_from_parts(parts[2:], denom, reg)


def l2_parts(*embs: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """[sum (w e)^2 for each e]: the additive sums of ``l2_reg_loss``."""
    w = weight.reshape(-1, 1)
    weighted = [e * w for e in embs]
    return torch.stack([(e * e).sum() for e in weighted])


def l2_from_parts(squares: torch.Tensor, denom: torch.Tensor,
                  reg: float) -> torch.Tensor:
    """``l2_reg_loss`` from :func:`l2_parts` summed over the blocks and the
    real row count ``denom`` (at least 1)."""
    total = 0.0
    for sq in squares:
        total = total + sq.sqrt() / denom
    return total * reg


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


def info_nce_parts(anchors: torch.Tensor, columns: torch.Tensor,
                   offset: int, row_valid: torch.Tensor,
                   col_valid: torch.Tensor, temperature: float,
                   normalize: bool = True) -> torch.Tensor:
    """[sum -log p * row_valid, sum row_valid] of a block of anchor rows
    against every column: row i's positive is column ``offset + i``, its
    denominator runs over the columns ``col_valid`` admits (a (C,) mask
    shared by the rows or an (R, C) mask of each row's own), p the softmax
    of ``anchors @ columns.T / temperature`` (rows and columns L2
    normalized first unless ``normalize`` is False).

    The blocks of a global batch's anchors, each with its offset, sum to
    the parts of the whole, and :func:`info_nce_from_parts` of the whole's
    parts is ``info_nce_masked(anchors, columns, valid, temperature)`` at
    ``offset`` 0 with ``row_valid`` = ``col_valid`` = ``valid``."""
    if normalize:
        anchors, columns = _normalize(anchors), _normalize(columns)
    logits = (anchors @ columns.T) / temperature
    mask = col_valid if col_valid.dim() == 2 else col_valid[None, :]
    neg_inf = torch.finfo(logits.dtype).min
    masked = torch.where(mask > 0, logits, torch.full_like(logits, neg_inf))
    log_prob = torch.diagonal(logits, offset) - torch.logsumexp(masked, dim=1)
    kept = torch.where(row_valid > 0, log_prob, torch.zeros_like(log_prob))
    return torch.stack([-(kept * row_valid).sum(), row_valid.sum()])


def info_nce_from_parts(parts: torch.Tensor) -> torch.Tensor:
    """The mean over the valid rows from :func:`info_nce_parts` (summed
    over the blocks)."""
    return parts[0] / parts[1].clamp_min(1.0)
