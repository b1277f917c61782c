"""M2VAE hierarchical multimodal VAE (the port's copy of
``coldrec_tpu/models/m2vae.py``; reference: model/M2VAE.py). Item cold
start only.

Two views of an item's content: the attribute-attention view a_v and the
content projection c_v (M2VAE.py:271-287); a Gaussian encoder per view,
their product of experts (27-33), a user-gated mixture of the view
posteriors, a view gate, and the MoPoE average with the item embedding's
posterior (289-349); a decoder on [z, a_v, c_v]. Loss = KLD (the prior
from fc2([a_v, c_v])) + reconstruction + rank + the CCFCRec-style
co-occurrence contrast + the decoupling InfoNCE (373-402). Cold inference
drops the user branch (404-419) and draws its z from an eval generator
re-seeded at the start of every epoch (the JAX package's ``eval_key``).

The three BatchNorm blocks are ``MaskedBatchNorm1d`` (weighted by the
batch's pad weights); their running statistics are buffers. The loss's
four reparameterisation normals come from the trainer's generator, or
from ``loss(batch, draws=)`` (the tests hand it the JAX package's).

The optimizer is Adam with coupled weight decay (optax's
``chain(add_decayed_weights(wd), adam(lr))``: the decay is added to the
gradient before Adam's moments), which is ``torch.optim.Adam``'s
``weight_decay``, not AdamW. Frozen backbone tables (``--m2vae_pretrain``
without ``--m2vae_pretrain_update``) take no gradient and stay out of the
optimizer (optax's ``set_to_zero``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..data.sampler import ccfcrec_batches, warm_item_pool
from ..device import resolve_device
from .ccfcrec import MASKED, AttributeScores, bpr_sum, grid_contrast
from .cold_base import ColdStartModelBase
from .common import (
    JaxCarried, MaskedBatchNorm1d, linear_params, linear_slots, mlp_slots,
    table_param, xavier_normal, xavier_uniform,
)

HEADS = ("mean_a_q", "log_a_q", "mean_c_q", "log_c_q", "mean_i", "log_i",
         "mean_a_p", "log_a_p")
BN_BLOCKS = ("fc2", "fc3", "decoder")
DRAWS = ("z_a", "z_c", "z_p", "z")


def kl_to_std(mu, logvar, w):
    """-0.5 * sum(1 - e^lv - mu^2 + lv) over the real rows."""
    el = 1 - torch.exp(logvar) - mu ** 2 + logvar
    return -0.5 * (el * w[:, None]).sum()


def kl_between(mu0, lv0, mu1, lv1, w):
    el = (1 - torch.exp(lv0) / torch.exp(lv1)
          - (mu0 - mu1) ** 2 / torch.exp(lv1) + lv0 - lv1)
    return -0.5 * (el * w[:, None]).sum()


def poe(mu_a, lv_a, mu_c, lv_c, eps=1e-8):
    """Product of two Gaussian experts: (mean, log variance)."""
    var_a = torch.exp(lv_a) + eps
    var_c = torch.exp(lv_c) + eps
    prec = 1.0 / var_a + 1.0 / var_c
    return (mu_a / var_a + mu_c / var_c) / prec, torch.log(1.0 / prec + eps)


def _norm(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-12)


def infonce_3(tau, e1, e2, e3, w):
    """Cross-entropy of [cos(e1, e2) | e1 @ e3.T] at label 0, the pad rows
    masked out of the in-batch negatives (M2VAE.py:36-45)."""
    n1, n2, n3 = _norm(e1), _norm(e2), _norm(e3)
    pos = (n1 * n2).sum(dim=-1) / tau
    negs = (n1 @ n3.T) / tau
    negs = torch.where(w[None, :] > 0, negs,
                       torch.full_like(negs, torch.finfo(negs.dtype).min))
    logits = torch.cat([pos[:, None], negs], dim=1)
    lp = logits[:, 0] - torch.logsumexp(logits, dim=1)
    return -(lp * w).sum() / w.sum().clamp_min(1.0)


class BNBlock(nn.Module):
    """tanh(BatchNorm(Linear(x)))."""

    def __init__(self, in_dim: int, out_dim: int, bn_dim: int,
                 gen: torch.Generator):
        super().__init__()
        self.lin = linear_params(in_dim, out_dim, gen)
        self.bn = MaskedBatchNorm1d(bn_dim)

    def forward(self, x, weight=None):
        return torch.tanh(self.bn(self.lin(x), weight))

    def slots(self, name: str) -> list:
        return (linear_slots(self.lin, ("params", name, "lin"))
                + self.bn.slots(("params", name, "bn"), ("state", name)))


def _mlp2(layers, x, act):
    return layers[1](act(layers[0](x)))


class M2VAE(JaxCarried, nn.Module):
    def __init__(self, user_num: int, item_num: int, content_dim: int,
                 emb_dim: int, attr_dim: int, cat_dim: int,
                 seed: int = 2024, device="cuda"):
        super().__init__()
        d, a, c = emb_dim, attr_dim, content_dim
        gen = torch.Generator().manual_seed(int(seed))
        self.user_embedding = nn.Parameter(xavier_normal((user_num, d), gen))
        self.item_embedding = nn.Parameter(xavier_normal((item_num, d), gen))
        self.attr = AttributeScores(c, a, gen)
        self.content_projection = nn.utils.skip_init(nn.Linear, c, d,
                                                     bias=False)
        with torch.no_grad():
            self.content_projection.weight.copy_(xavier_normal((c, d), gen).T)

        def lin(i, o):
            return linear_params(i, o, gen)

        self.moe_gate_a = nn.ModuleList([lin(d, d // 2), lin(d // 2, 1)])
        self.moe_gate_c = nn.ModuleList([lin(d, d // 2), lin(d // 2, 1)])
        self.user_gate_w = nn.Parameter(xavier_uniform((2, d, d), gen))
        self.user_gate_b = nn.Parameter(torch.zeros(2, d))
        self.view_gate = nn.ModuleList([lin(2 * d, d), lin(d, 1)])
        self.fc2 = BNBlock(2 * a, cat_dim, a, gen)
        self.fc3 = BNBlock(a + 2 * d, cat_dim, cat_dim, gen)
        self.decoder = BNBlock(cat_dim, d, d, gen)
        for name, i in zip(HEADS, (a, a, d, d, d, d, d, d)):
            setattr(self, name, lin(i, d))
        self.to(resolve_device(device))

    def encode_views(self, attribute: torch.Tensor, mask_neg1: bool):
        """(a_v, c_v) of the content rows ``attribute``."""
        z_v = self.attr.scores()[None, :].expand_as(attribute)
        if mask_neg1:
            masked = attribute == -1
        else:
            valid = attribute != 0
            masked = ~(valid | (valid.sum(dim=1, keepdim=True) == 0))
        z_v = torch.where(masked, torch.full_like(z_v, MASKED), z_v)
        a_v = torch.softmax(z_v, dim=1) @ self.attr.attr_matrix
        return a_v, self.content_projection(attribute)

    def generate(self, attribute, item_rows, normal, mask_neg1: bool):
        """The cold rows' embeddings without the user branch
        (M2VAE.py:404-419); ``normal`` is z's N(0, 1) draw."""
        a_v, c_v = self.encode_views(attribute, mask_neg1)
        mean_p1, log_p1 = poe(self.mean_a_q(a_v), self.log_a_q(a_v),
                              self.mean_c_q(c_v), self.log_c_q(c_v))
        mean = 0.5 * (mean_p1 + self.mean_i(item_rows))
        log = 0.5 * (log_p1 + self.log_i(item_rows))
        z = mean + torch.exp(0.5 * log) * normal
        return self.decoder(self.fc3(torch.cat([z, a_v, c_v], -1)))

    def jax_slots(self) -> list:
        out = [(("params", "user_embedding"), self.user_embedding, False),
               (("params", "item_embedding"), self.item_embedding, False),
               *self.attr.slots(),
               (("params", "content_projection", "w"),
                self.content_projection.weight, True),
               (("params", "user_gate_w"), self.user_gate_w, False),
               (("params", "user_gate_b"), self.user_gate_b, False)]
        for name in ("moe_gate_a", "moe_gate_c", "view_gate"):
            out += mlp_slots(getattr(self, name), ("params", name))
        for name in BN_BLOCKS:
            out += getattr(self, name).slots(name)
        for name in HEADS:
            out += linear_slots(getattr(self, name), ("params", name))
        return out

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        c, a = params["attr_matrix"].shape
        return {"user_num": params["user_embedding"].shape[0],
                "item_num": params["item_embedding"].shape[0],
                "content_dim": c, "emb_dim": params["item_embedding"].shape[1],
                "attr_dim": a,
                "cat_dim": params["fc2"]["lin"]["w"].shape[1]}


class M2VAETrainer(ColdStartModelBase):
    """``init_params`` / ``init_state`` (the JAX trainer's ``params`` and
    ``net_state`` as numpy) replace the seeded weights and statistics."""

    # the JAX trainer never sets up a mesh: --mesh runs on one device
    mesh_support = "one_device"

    def __init__(self, config, init_params: Optional[Dict] = None,
                 init_state: Optional[Dict] = None):
        super().__init__(config)
        self.require_item_cold()
        a = self.args
        self.content = self.cold_side_content
        self.tau = float(a.tau)
        self.P = int(a.positive_number)
        self.N = int(a.negative_number)
        self.mask_neg1 = bool(a.m2vae_attr_mask_neg1)
        d = int(a.implicit_dim)
        attr_dim, cat_dim = int(a.attr_present_dim), int(a.cat_implicit_dim)
        backbone = self.load_backbone() if bool(a.m2vae_pretrain) else None
        if backbone is not None:
            d = attr_dim = cat_dim = int(backbone["user_emb"].shape[1])
            a.implicit_dim = a.attr_present_dim = a.cat_implicit_dim = d
        self.d = d
        self.model = self.init_module(
            M2VAE, init_params, init_state, user_num=self.data.user_num,
            item_num=self.data.item_num, content_dim=self.content_dim,
            emb_dim=d, attr_dim=attr_dim, cat_dim=cat_dim)
        m = self.model
        if backbone is not None:
            if init_params is None:
                m.user_embedding = table_param(backbone["user_emb"])
                m.item_embedding = table_param(backbone["item_emb"])
            frozen = not bool(a.m2vae_pretrain_update)
            m.user_embedding.requires_grad_(not frozen)
            m.item_embedding.requires_grad_(not frozen)
        self.eval_seed = 0
        self.pool = warm_item_pool(self.data)
        self.setup_optimizer(optimizer=torch.optim.Adam(
            [p for p in m.parameters() if p.requires_grad], lr=self.lr,
            weight_decay=float(a.m2vae_weight_decay)))

    def batches(self):
        return ccfcrec_batches(self.data, self.batch_size, self.host_rng,
                               self.P, self.N, 1, self.pool)

    def epoch_hook(self, epoch: int):
        """A new eval draw for this epoch's tables."""
        self.eval_seed = int(torch.randint(
            0, 2 ** 62, (1,), generator=self.generator,
            device=self.device).item())

    def eval_normal(self, n: int) -> torch.Tensor:
        """z's (n, d) N(0, 1) draw of the cold rows at eval, fixed within
        an epoch."""
        gen = torch.Generator(device=self.device).manual_seed(self.eval_seed)
        return torch.randn((n, self.d), generator=gen, device=self.device)

    def draw(self, n: int) -> Dict[str, torch.Tensor]:
        """The loss's four (n, d) N(0, 1) draws: z_a, z_c, z_p and z."""
        return {k: torch.randn((n, self.d), generator=self.generator,
                               device=self.device) for k in DRAWS}

    def loss(self, batch: Dict[str, torch.Tensor],
             draws: Optional[Dict[str, torch.Tensor]] = None
             ) -> torch.Tensor:
        m = self.model
        a = self.args
        w = batch["weight"]
        if draws is None:
            draws = self.draw(w.shape[0])
        user_emb = m.user_embedding[batch["user"]]
        a_v, c_v = m.encode_views(self.content[batch["pos_item"]],
                                  self.mask_neg1)
        i_v = m.item_embedding[batch["pos_item"]]

        mean_i, log_i = m.mean_i(i_v), m.log_i(i_v)
        mean_a_q, log_a_q = m.mean_a_q(a_v), m.log_a_q(a_v)
        z_a = mean_a_q + torch.exp(0.5 * log_a_q) * draws["z_a"]
        h1 = m.fc2(torch.cat([a_v, c_v], -1), w)
        mean_p, log_p = m.mean_a_p(h1), m.log_a_p(h1)
        mean_c_q, log_c_q = m.mean_c_q(c_v), m.log_c_q(c_v)
        z_c = mean_c_q + torch.exp(0.5 * log_c_q) * draws["z_c"]
        mean_p1, log_p1 = poe(mean_a_q, log_a_q, mean_c_q, log_c_q)
        z_p = mean_p1 + torch.exp(0.5 * log_p1) * draws["z_p"]

        # user-gated mixture of the view posteriors (M2VAE.py:309-321)
        gates = torch.sigmoid(
            torch.einsum("bd,mdh->mbh", user_emb, m.user_gate_w)
            + m.user_gate_b[:, None, :])
        moe_a = _mlp2(m.moe_gate_a, user_emb * gates[0] * z_a * z_p,
                      torch.tanh)
        moe_c = _mlp2(m.moe_gate_c, user_emb * gates[1] * z_c * z_p,
                      torch.tanh)
        moe_w = torch.softmax(torch.cat([moe_a, moe_c], 1), dim=1)
        mean_u = moe_w[:, 0:1] * mean_a_q + moe_w[:, 1:2] * mean_c_q
        log_u = moe_w[:, 0:1] * log_a_q + moe_w[:, 1:2] * log_c_q
        com_w = torch.sigmoid(_mlp2(m.view_gate,
                                    torch.cat([user_emb, z_p], 1),
                                    F.leaky_relu))
        mean_q = com_w * mean_p1 + (1 - com_w) * mean_u
        log_q = com_w * log_p1 + (1 - com_w) * log_u
        mean_mopoe = 0.5 * (mean_q + mean_i)
        log_mopoe = 0.5 * (log_q + log_i)
        z = mean_mopoe + torch.exp(0.5 * log_mopoe) * draws["z"]
        decoder = m.decoder(m.fc3(torch.cat([z, a_v, c_v], -1), w), w)

        decouple = (infonce_3(self.tau, z_a, a_v, z_p, w)
                    + infonce_3(self.tau, z_c, c_v, z_p, w))
        kld = kl_between(mean_mopoe, log_mopoe, mean_p, log_p, w) + (
            kl_to_std(mean_i, log_i, w) + kl_to_std(mean_c_q, log_c_q, w)
            + kl_to_std(mean_a_q, log_a_q, w)) / 3.0
        recon = (((i_v - decoder) ** 2).sum(dim=1) * w).sum() \
            / w.sum().clamp_min(1.0)
        contrast = grid_contrast(decoder, m.item_embedding, batch, self.tau,
                                 self.P, w)
        rank = bpr_sum(decoder, m.user_embedding[batch["user"]],
                       m.user_embedding[batch["neg_user"]], w)
        return (float(a.m2vae_kld_weight) * kld
                + float(a.m2vae_recon_weight) * recon + rank + contrast
                + float(a.m2vae_decouple_weight) * decouple)

    def forward_tables(self):
        m = self.model
        idx = self.cold_idx
        gen = m.generate(self.content[idx], m.item_embedding[idx],
                         self.eval_normal(idx.shape[0]), self.mask_neg1)
        return self.patch_cold_rows(m.user_embedding, m.item_embedding, gen)
