"""CCFCRec cold-start model (the port's copy of
``coldrec_tpu/models/ccfcrec.py``; reference: model/CCFCRec.py). Item cold
start only.

Attribute attention (learned global attribute scores plus magnitude gating
over continuous content, CCFCRec.py:199-219) -> a 2-layer generator MLP ->
q_v_c. Contrastive terms: q_v_c against P co-occurring positive items with
a P x N warm-pool negative grid, and against the item's own embedding with
S self-negatives (CCFCRec.py:53-75); BPR-style rank terms on the real and
on the generated item embedding against a negative user (77-87); a lambda1
blend. With ``--pretrain`` the tables come from the backbone's bus and,
unless ``--pretrain_update``, take no gradient and stay out of Adam (JAX's
``stop_gradient``: Adam's update of a zero gradient is 0). Eval patches the
cold item rows with q_v_c. Batches: ``ccfcrec_batches`` (shared with
M2VAE).

Content with the value -1 in more than 1% of its entries is read as having
missing values (the sentinel rule): those entries are masked out of the
attention.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..data.sampler import ccfcrec_batches, warm_item_pool
from ..device import resolve_device
from .cold_base import ColdStartModelBase
from .common import (
    JaxCarried, linear_slots, rows_of, table_param, xavier_normal,
)

MASKED = -1e6  # the attention logit of a masked attribute


def xavier_linear(in_dim: int, out_dim: int,
                  gen: torch.Generator) -> nn.Linear:
    """A Linear with a xavier-normal weight and a zero bias (the JAX
    package's ``{"w": _xavier_normal, "b": zeros}``)."""
    layer = nn.utils.skip_init(nn.Linear, in_dim, out_dim)
    with torch.no_grad():
        layer.weight.copy_(xavier_normal((in_dim, out_dim), gen).T)
        layer.bias.zero_()
    return layer


class AttributeScores(nn.Module):
    """The attribute matrix (c, a) and the global attribute scores z_v (c,)
    = ((A @ W1 + b1) @ W2) of CCFCRec and M2VAE."""

    def __init__(self, content_dim: int, attr_dim: int,
                 gen: torch.Generator):
        super().__init__()
        self.attr_matrix = nn.Parameter(xavier_normal(
            (content_dim, attr_dim), gen))
        self.attr_W1 = nn.Parameter(xavier_normal((attr_dim, attr_dim), gen))
        self.attr_b1 = nn.Parameter(xavier_normal((attr_dim, 1), gen))
        self.attr_W2 = nn.Parameter(xavier_normal((attr_dim, 1), gen))

    def scores(self) -> torch.Tensor:
        return ((self.attr_matrix @ self.attr_W1 + self.attr_b1[:, 0])
                @ self.attr_W2)[:, 0]

    def slots(self) -> list:
        return [(("params", name), getattr(self, name), False)
                for name in ("attr_matrix", "attr_W1", "attr_b1", "attr_W2")]


def grid_cos(anchor, table, grid, tau):
    """cos(anchor[b], table[grid[b, ...]]) / tau for every entry of the
    (B, ...) id grid (norms floored at 1e-12): one batched product of the
    gathered rows with the anchors, over the table's row norms gathered
    (not recomputed for every gathered row)."""
    b = grid.shape[0]
    ids = grid.reshape(-1).long()
    rows = rows_of(table, ids).view(b, -1, table.shape[1])
    dots = torch.bmm(rows, anchor[:, :, None])[..., 0]
    na = torch.linalg.vector_norm(anchor, dim=-1).clamp_min(1e-12)
    nb = rows_of(torch.linalg.vector_norm(table, dim=-1).clamp_min(1e-12),
                 ids).view(b, -1)
    return (dots / (tau * na[:, None] * nb)).view(grid.shape)


def grid_contrast(anchor, item_emb, batch, tau, n_pos, weight):
    """The co-occurrence contrast of CCFCRec.py:53-64: -log(pos / (pos +
    sum of the row's N negatives)) over the (B, P) positives of
    ``pos_grid`` and the (B, P, N) negatives of ``neg_grid``, summed over P
    and the real rows, divided by P."""
    pos_exp = torch.exp(grid_cos(anchor, item_emb, batch["pos_grid"], tau))
    neg_sum = torch.exp(grid_cos(anchor, item_emb, batch["neg_grid"],
                                 tau)).sum(dim=2)
    contrast = -torch.log(pos_exp / (pos_exp + neg_sum))
    return (contrast.sum(dim=1) * weight).sum() / n_pos


def bpr_sum(item_emb, user_emb, neg_user_emb, weight):
    """-sum over the real rows of log sigmoid(<i, u> - <i, u_neg>)."""
    y = (item_emb * user_emb).sum(dim=1) - (item_emb * neg_user_emb).sum(dim=1)
    return -(F.logsigmoid(y) * weight).sum()


class CCFCRec(JaxCarried, nn.Module):
    def __init__(self, user_num: int, item_num: int, content_dim: int,
                 attr_dim: int, cat_dim: int, emb_dim: int,
                 seed: int = 2024, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        self.user_embedding = nn.Parameter(xavier_normal((user_num, emb_dim),
                                                         gen))
        self.item_embedding = nn.Parameter(xavier_normal((item_num, emb_dim),
                                                         gen))
        self.attr = AttributeScores(content_dim, attr_dim, gen)
        self.gen1 = xavier_linear(attr_dim, cat_dim, gen)
        self.gen2 = xavier_linear(cat_dim, emb_dim, gen)
        self.to(resolve_device(device))

    def generate(self, attribute: torch.Tensor,
                 missing_sentinel: bool) -> torch.Tensor:
        """q_v_c of the content rows ``attribute`` (CCFCRec.py:189-222)."""
        eps = 1e-8
        if missing_sentinel:
            valid = attribute != -1
            value = torch.where(valid, attribute, torch.zeros_like(attribute))
        else:
            valid = torch.ones_like(attribute, dtype=torch.bool)
            value = attribute
        magnitude = value.abs()
        active = valid & (magnitude > eps)
        has_active = active.any(dim=1, keepdim=True)
        effective = torch.where(has_active, active, valid)
        z = self.attr.scores()[None, :] + torch.log(magnitude.clamp_min(eps))
        z = torch.where(effective, z, torch.full_like(z, MASKED))
        attn = torch.softmax(z, dim=1)
        weighted = torch.where(has_active, attn * value, attn)
        q_v_a = weighted @ self.attr.attr_matrix
        return self.gen2(F.leaky_relu(self.gen1(q_v_a)))

    def jax_slots(self) -> list:
        return ([(("params", "user_embedding"), self.user_embedding, False),
                 (("params", "item_embedding"), self.item_embedding, False)]
                + self.attr.slots()
                + linear_slots(self.gen1, ("params", "gen1"))
                + linear_slots(self.gen2, ("params", "gen2")))

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        c, a = params["attr_matrix"].shape
        return {"user_num": params["user_embedding"].shape[0],
                "item_num": params["item_embedding"].shape[0],
                "content_dim": c, "attr_dim": a,
                "cat_dim": params["gen1"]["w"].shape[1],
                "emb_dim": params["item_embedding"].shape[1]}


class CCFCRecTrainer(ColdStartModelBase):
    """``init_params`` (the JAX trainer's ``params`` as numpy) replaces the
    seeded weights (and, under ``--pretrain``, the bus tables)."""

    def __init__(self, config, init_params: Optional[Dict] = None):
        super().__init__(config)
        self.require_item_cold()
        a = self.args
        self.tau = float(a.tau)
        self.lambda1 = float(a.lambda1)
        self.P = int(a.positive_number)
        self.N = int(a.negative_number)
        self.S = int(a.self_neg_number)
        self.content = self.cold_side_content
        self.missing_sentinel = bool(
            float((self.content == -1).float().mean()) > 0.01)
        backbone = self.load_backbone() if bool(a.pretrain) else None
        emb_dim = (int(backbone["item_emb"].shape[1]) if backbone
                   else int(a.implicit_dim))
        self.model = self.init_module(
            CCFCRec, init_params, user_num=self.data.user_num,
            item_num=self.data.item_num, content_dim=self.content_dim,
            attr_dim=int(a.attr_present_dim), cat_dim=int(a.cat_implicit_dim),
            emb_dim=emb_dim)
        m = self.model
        if backbone is not None:
            if init_params is None:
                m.user_embedding = table_param(backbone["user_emb"])
                m.item_embedding = table_param(backbone["item_emb"])
            frozen = not bool(a.pretrain_update)
            m.user_embedding.requires_grad_(not frozen)
            m.item_embedding.requires_grad_(not frozen)
        self.pool = warm_item_pool(self.data)
        self.setup_optimizer()

    def batches(self):
        return ccfcrec_batches(self.data, self.batch_size, self.host_rng,
                               self.P, self.N, self.S, self.pool)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        m = self.model
        w = batch["weight"]
        ie, ue = m.item_embedding, m.user_embedding
        q_v_c = m.generate(self.content[batch["pos_item"]],
                           self.missing_sentinel)
        contrast = grid_contrast(q_v_c, ie, batch, self.tau, self.P, w)
        self_neg_sum = torch.exp(grid_cos(q_v_c, ie, batch["self_negs"],
                                          self.tau)).sum(dim=1)
        self_pos = torch.exp(grid_cos(q_v_c, ie, batch["pos_item"][:, None],
                                      self.tau))[:, 0]
        self_contrast = (-torch.log(self_pos / (self_pos + self_neg_sum))
                         * w).sum()
        item_emb = ie[batch["pos_item"]]
        user_emb = ue[batch["user"]]
        neg_user_emb = ue[batch["neg_user"]]
        rank = (bpr_sum(item_emb, user_emb, neg_user_emb, w)
                + bpr_sum(q_v_c, user_emb, neg_user_emb, w))
        return (self.lambda1 * (contrast + self_contrast)
                + (1 - self.lambda1) * rank)

    def forward_tables(self):
        m = self.model
        gen = m.generate(self.content[self.cold_idx], self.missing_sentinel)
        return self.patch_cold_rows(m.user_embedding, m.item_embedding, gen)
