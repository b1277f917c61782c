"""ALDI cold-start distillation (the port's copy of
``coldrec_tpu/models/aldi.py``; reference: model/ALDI.py). Item cold only.

Teacher = the frozen backbone tables; students = a user tower (emb -> emb)
and an item tower (content -> emb), both Linear-BN-tanh-Linear with
truncated-normal init (ALDI.py:191-208). Losses (ALDI.py:50-82): student
BPR + gamma*|rating distance| + alpha*BCE(student rank logit,
sigmoid(teacher rank logit)) + beta*BCE(identity logits), the latter two
weighted by a tanh-capped item frequency (tws flag; freq ALDI.py:12-22,
weights 226-239). The item tower runs twice a step (pos, then neg items),
so its running statistics are updated twice. Adam with weight decay on the
Linear weights and biases only, not on the BatchNorm's (ALDI.py:170-188).

Dual-table inference (ALDI.py:149-160): warm item columns are scored with
the backbone user embedding, cold columns with the user tower's output;
items in neither set score 0. Both fold into one product of concatenated
tables, [warm_u ∥ cold_u] x [item*warm_mask ∥ item*cold_mask], so the eval
tables are 2 x emb_size wide.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.losses import bpr_loss
from .cold_base import ColdStartModelBase
from .common import (
    JaxCarried, MaskedBatchNorm1d, linear_params_tn, linear_slots,
)


def aldi_item_frequency(data) -> np.ndarray:
    """freq[i] = sum over users linked to i of 1/|user's train items|
    (ALDI.py:12-22); items with no train interactions keep 1.0."""
    freq = np.ones(data.item_num, dtype=np.float32)
    tp = data.train_pairs
    user_deg = np.diff(data.train_indptr)
    contrib = 1.0 / np.maximum(user_deg[tp[:, 0]], 1.0)
    sums = np.bincount(tp[:, 1], weights=contrib, minlength=data.item_num)
    has = np.bincount(tp[:, 1], minlength=data.item_num) > 0
    freq[has] = sums[has].astype(np.float32)
    return freq


class Tower(nn.Module):
    """Linear -> BatchNorm (momentum 0.1, eps 1e-5) -> tanh -> Linear."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 generator: torch.Generator):
        super().__init__()
        self.fc1 = linear_params_tn(in_dim, hidden, generator)
        self.bn = MaskedBatchNorm1d(hidden)
        self.fc2 = linear_params_tn(hidden, out_dim, generator)

    def forward(self, x, weight: Optional[torch.Tensor] = None):
        return self.fc2(torch.tanh(self.bn(self.fc1(x), weight)))

    def slots(self, name: str, state_name: str) -> list:
        return (linear_slots(self.fc1, ("params", name, "fc1"))
                + self.bn.slots(("params", name, "bn"), ("state", state_name))
                + linear_slots(self.fc2, ("params", name, "fc2")))


def _bce_logits(logits, targets):
    return (logits.clamp_min(0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


class ALDI(JaxCarried, nn.Module):
    def __init__(self, emb_size: int, content_dim: int, hidden: int,
                 seed: int = 2024, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        self.user_tower = Tower(emb_size, hidden, emb_size, gen)
        self.item_tower = Tower(content_dim, hidden, emb_size, gen)
        self.to(resolve_device(device))

    def param_groups(self, weight_decay: float) -> list:
        """Linear weights and biases with ``weight_decay``, the BatchNorm's
        scale and bias without."""
        bn = [p for n, p in self.named_parameters() if ".bn." in n]
        rest = [p for n, p in self.named_parameters() if ".bn." not in n]
        return [{"params": rest, "weight_decay": weight_decay},
                {"params": bn, "weight_decay": 0.0}]

    def jax_slots(self) -> list:
        return (self.user_tower.slots("user_tower", "user_bn")
                + self.item_tower.slots("item_tower", "item_bn"))

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        w1 = params["item_tower"]["fc1"]["w"]
        return {"emb_size": params["user_tower"]["fc1"]["w"].shape[0],
                "content_dim": w1.shape[0], "hidden": w1.shape[1]}


class ALDITrainer(ColdStartModelBase):
    # the JAX trainer never sets up a mesh: --mesh runs on one device
    mesh_support = "one_device"

    def __init__(self, config, init_params: Optional[Dict] = None,
                 init_state: Optional[Dict] = None):
        super().__init__(config)
        self.require_item_cold()
        self.backbone = self.load_backbone()
        self.content = self.cold_side_content
        self.alpha = float(self.args.alpha)
        self.beta = float(self.args.beta)
        self.gamma = float(self.args.gamma)
        self.model = self.init_module(
            ALDI, init_params, init_state, emb_size=self.emb_size,
            content_dim=self.content_dim, hidden=int(self.args.aldi_hidden))

        # tanh-capped teacher weight per item (ALDI.py:226-239)
        train_n = max(self.data.n_train, 1)
        x_expect = (train_n / max(self.data.item_num, 1)) * (
            1.0 / max(train_n / max(self.data.user_num, 1), 1e-12)
        )
        a = float(self.args.freq_coef_M) / float(x_expect)
        freq = aldi_item_frequency(self.data)
        cap = float(np.tanh(float(self.args.freq_coef_M)))
        if int(self.args.tws):
            tw = np.clip(np.tanh(a * freq), 0.0, cap)
        else:
            tw = np.ones_like(freq)
        self.pos_item_weights = torch.as_tensor(tw, device=self.device)

        # masks of the dual-table scoring
        masks = np.zeros((2, self.data.item_num), np.float32)
        masks[0, self.data.mapped_warm_item_idx] = 1.0
        masks[1, self.data.mapped_cold_item_idx] = 1.0
        self._warm_mask, self._cold_mask = torch.as_tensor(
            masks, device=self.device)
        self.setup_optimizer(self.model.param_groups(self.reg))

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        uid, iid, nid = batch["user"], batch["pos_item"], batch["neg_item"]
        w = batch["weight"]
        m = self.model
        ue = self.backbone["user_emb"][uid]
        pe = self.backbone["item_emb"][iid]
        ne = self.backbone["item_emb"][nid]
        gen_u = m.user_tower(ue, w)
        gen_p = m.item_tower(self.content[iid], w)
        gen_n = m.item_tower(self.content[nid], w)

        basic = bpr_loss(gen_u, gen_p, gen_n, w)
        t_pos = (ue * pe).sum(dim=1)
        t_neg = (ue * ne).sum(dim=1)
        s_pos = (gen_u * gen_p).sum(dim=1)
        s_neg = (gen_u * gen_n).sum(dim=1)
        w_sum = w.sum().clamp_min(1.0)

        def wmean(x):
            return (x * w).sum() / w_sum

        rating = self.gamma * wmean((t_pos - s_pos).abs()
                                    + (t_neg - s_neg).abs())
        pos_w = self.pos_item_weights[iid]
        rank_per = _bce_logits(s_pos - s_neg, torch.sigmoid(t_pos - t_neg))
        ranking = self.alpha * wmean(pos_w * rank_per)
        s_ii = (gen_p * gen_p).sum(dim=1)
        s_ij = ((gen_p @ gen_n.T) * w[None, :]).sum(dim=1) / w_sum
        t_ii = (pe * pe).sum(dim=1)
        t_ij = ((pe @ ne.T) * w[None, :]).sum(dim=1) / w_sum
        iden_per = _bce_logits(s_ii - s_ij, torch.sigmoid(t_ii - t_ij))
        iden = self.beta * wmean(pos_w * iden_per)
        return basic + rating + ranking + iden

    def forward_tables(self):
        """The concatenated dual tables: one product scores warm and cold
        columns."""
        ue = self.backbone["user_emb"]
        ie = self.backbone["item_emb"]
        cold_u = self.model.user_tower(ue)
        gen_items = self.model.item_tower(self.content[self.cold_idx])
        item_patched = ie.index_put((self.cold_idx,), gen_items)
        user_table = torch.cat([ue, cold_u], dim=1)
        item_table = torch.cat([item_patched * self._warm_mask[:, None],
                                item_patched * self._cold_mask[:, None]],
                               dim=1)
        return user_table, item_table

    def extra_saved_tensors(self):
        # the reference saves the warm / cold user tables beside the patched
        # item table (ALDI.py:112-124): the halves of the best user table
        d = self.emb_size
        return {"warm_user_emb": self.best_user_emb[:, :d],
                "cold_user_emb": self.best_user_emb[:, d:]}
