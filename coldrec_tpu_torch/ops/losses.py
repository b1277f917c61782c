"""BPR, L2 and MSE losses on tensors, weighted for padding (the port's copy
of ``bpr_loss``, ``l2_reg_loss``, ``mse_loss`` and ``_wmean`` from
``coldrec_tpu/ops/losses.py``; reference ColdRec util/utils.py:25-48).

Every batch has a fixed row count; the last batch of an epoch is padded and
carries ``weight`` (1.0 real / 0.0 pad), so the weighted mean equals the
reference's mean over the real rows.
"""
from __future__ import annotations

from typing import Optional

import torch

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
