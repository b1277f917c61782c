"""GoRec cold-start CVAE (the port's copy of ``coldrec_tpu/models/gorec.py``;
reference: model/GoRec.py).

A CVAE over the warm embeddings, conditioned on the L2-normalized content:
encoder fc (BatchNorm, tanh) -> (mu, logvar), beside a content-only prior
branch (mu_zgc, logvar_zgc); losses = MSE reconstruction + uniformity of
mu (log mean exp(-2 d^2) over the pairwise distances, GoRec.py:199-201) +
KLDiv(log softmax z ∥ softmax zgc), elementwise mean (GoRec.py:41-45).
k-means of the backbone's cold-side table at start (``ops/kmeans.py``; the
labels go to the bus as ``cluster_label``, the means are not used in the
loss, GoRec.py:133-141). Eval decodes mu for EVERY row of the cold side's
table (GoRec.py:167-189) from the raw content: training normalizes it,
eval does not (a reference quirk, kept).

Initialization as the reference's torch modules: the fc blocks keep
nn.Linear's default weight (no bias, GoRec.py:219/252), the four heads
have xavier weights and nn.Linear's default bias (GoRec.py:228-231), the
two generator layers are default nn.Linear. The two BatchNorms are
``MaskedBatchNorm1d`` (momentum 0.1, eps 1e-5) weighted by the batch's pad
weights. The loss's draws (the two normals and the content dropout) come
from the trainer's generator, or from ``loss(batch, draws=)`` (the tests
hand it the JAX package's).

On ``--mesh DxM`` nothing shards (the backbone tables are buffers, outside
the JAX package's ``params`` too): each data rank takes its block of the
batch, both BatchNorms take their statistics over the global batch
(``MaskedBatchNorm1d.group``), every rank draws the global batch's planes
and keeps its block, and the loss is made of parts summed over the data
group: the reconstruction and KL sums over the global weight, and the
uniformity's pairs of this rank's rows against every row of the global
batch (``uniformity_parts``; each pair i < j counted once).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.kmeans import kmeans
from ..ops.losses import wmean_from_parts
from ..parallel.ops import AllGatherRows
from .cold_base import ColdStartModelBase
from .common import (
    JaxCarried, MaskedBatchNorm1d, linear_params, linear_slots,
    xavier_uniform,
)

HEADS = ("l_mu", "l_var", "l_mu_zgc", "l_var_zgc")


def uniformity(mu: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """log mean_{i<j} exp(-2 |x_i - x_j|^2) over the real pairs of the
    normalized rows x, the distances from one (B, B) Gram product
    (|x_i - x_j|^2 = 2 - 2 x_i.x_j for unit rows)."""
    return torch.log(wmean_from_parts(uniformity_parts(mu, mu, weight,
                                                       weight, 0)))


def uniformity_parts(mu: torch.Tensor, mu_all: torch.Tensor,
                     weight: torch.Tensor, weight_all: torch.Tensor,
                     offset: int) -> torch.Tensor:
    """[sum val * pair_w, sum pair_w] of the pairs (i, j), j > i, of the
    rows ``mu`` (the global batch's rows ``offset`` on) against every row
    ``mu_all`` of the global batch: summed over the blocks of a global
    batch they are its :func:`uniformity`'s parts, each pair once."""
    x = _unit(mu)
    x_all = x if mu_all is mu else _unit(mu_all)
    sq = (2.0 - 2.0 * (x @ x_all.T)).clamp_min(0.0)
    pair_w = torch.triu(weight[:, None] * weight_all[None, :],
                        diagonal=1 + offset)
    val = torch.exp(-2.0 * sq)
    return torch.stack([(val * pair_w).sum(), pair_w.sum()])


def _unit(mu: torch.Tensor) -> torch.Tensor:
    return mu / mu.norm(dim=1, keepdim=True).clamp_min(1e-12)


def head_params(in_dim: int, out_dim: int, gen: torch.Generator) -> nn.Linear:
    """A head: xavier-uniform weight, nn.Linear's default bias."""
    layer = linear_params(in_dim, out_dim, gen)
    with torch.no_grad():
        layer.weight.copy_(xavier_uniform((in_dim, out_dim), gen).T)
    return layer


class GoRec(JaxCarried, nn.Module):
    def __init__(self, content_dim: int, emb_size: int, seed: int = 2024,
                 device="cuda"):
        super().__init__()
        d, c = emb_size, content_dim
        gen = torch.Generator().manual_seed(int(seed))
        self.enc_fc = linear_params(d + c, d, gen, bias=False)
        self.enc_bn = MaskedBatchNorm1d(d)
        self.l_mu = head_params(d, d, gen)
        self.l_var = head_params(d, d, gen)
        self.l_mu_zgc = head_params(c, d, gen)
        self.l_var_zgc = head_params(c, d, gen)
        self.dec_fc = linear_params(d + c, d, gen, bias=False)
        self.dec_bn = MaskedBatchNorm1d(d)
        self.gen = nn.ModuleList([linear_params(d, d, gen),
                                  linear_params(d, d, gen)])
        self.to(resolve_device(device))

    def encode(self, warm, side, weight=None):
        h = torch.tanh(self.enc_bn(self.enc_fc(torch.cat([side, warm], 1)),
                                   weight))
        return (self.l_mu(h), self.l_var(h), self.l_mu_zgc(side),
                self.l_var_zgc(side))

    def decode(self, z, side, weight=None):
        h = torch.tanh(self.dec_bn(self.dec_fc(torch.cat([side, z], 1)),
                                   weight))
        for layer in self.gen:
            h = layer(h)
        return h

    def jax_slots(self) -> list:
        out = (linear_slots(self.enc_fc, ("params", "enc_fc"))
               + self.enc_bn.slots(("params", "enc_bn"), ("state", "enc_bn"))
               + linear_slots(self.dec_fc, ("params", "dec_fc"))
               + self.dec_bn.slots(("params", "dec_bn"), ("state", "dec_bn")))
        for name in HEADS:
            out += linear_slots(getattr(self, name), ("params", name))
        for i, layer in enumerate(self.gen):
            out += linear_slots(layer, ("params", "gen", i))
        return out

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        c, d = np.shape(params["l_mu_zgc"]["w"])
        return {"content_dim": c, "emb_size": d}


class GoRecTrainer(ColdStartModelBase):
    """``init_params`` / ``init_state`` (the JAX trainer's ``params`` and
    ``net_state`` as numpy) replace the seeded weights and statistics;
    ``kmeans_init`` the k-means' initial rows (the JAX package draws them
    with ``jax.random.choice``)."""

    fused_ok = False  # BatchNorm state: stateful in the JAX package
    mesh_support = "sharded"
    global_keys = ("weight",)

    def __init__(self, config, init_params: Optional[Dict] = None,
                 init_state: Optional[Dict] = None, kmeans_init=None):
        super().__init__(config)
        self.backbone = self.load_backbone()
        self.content = self.cold_side_content
        self.uni_coeff = float(self.args.uni_coeff)
        self.kl_coeff = float(self.args.kl_coeff)
        self.drop_rate = float(self.args.dropout)
        self.model = self.init_module(GoRec, init_params, init_state,
                                      content_dim=self.content_dim,
                                      emb_size=self.emb_size)
        _, labels = kmeans(self.warm_table, int(self.args.pre_cluster_num),
                           generator=self.generator, init_idx=kmeans_init)
        self.cluster_label = labels
        self.setup_optimizer()

    @property
    def warm_table(self) -> torch.Tensor:
        """The backbone's table of the cold side."""
        side = "item_emb" if self.args.cold_object == "item" else "user_emb"
        return self.backbone[side]

    def draw(self, n: int) -> dict:
        """The loss's draws for ``n`` rows: N(0, 1) for z and for zgc (n, d)
        and the content dropout's keep mask (n, c)."""
        d = self.emb_size
        g, dev = self.generator, self.device
        return {"z": torch.randn((n, d), generator=g, device=dev),
                "zgc": torch.randn((n, d), generator=g, device=dev),
                "keep": torch.rand((n, self.content_dim), generator=g,
                                   device=dev) >= self.drop_rate}

    def loss(self, batch: Dict[str, torch.Tensor],
             draws: Optional[dict] = None) -> torch.Tensor:
        """``draws`` (else drawn): the global batch's planes; this rank
        keeps its block of each."""
        m = self.model
        side_idx = (batch["pos_item"] if self.args.cold_object == "item"
                    else batch["user"])
        warm = self.warm_table[side_idx]
        side = self.content[side_idx]
        side = side / side.norm(dim=1, keepdim=True).clamp_min(1e-12)
        w = batch["weight"]
        if draws is None:
            draws = self.draw(w.shape[0] * self.n_data)
        draws = {k: self.data_block(v) for k, v in draws.items()}
        mu, logvar, mu_zgc, logvar_zgc = m.encode(warm, side, w)
        z = draws["z"] * torch.exp(0.5 * logvar) + mu
        zgc = draws["zgc"] * torch.exp(0.5 * logvar_zgc) + mu_zgc
        if self.drop_rate > 0.0:
            keep = 1.0 - self.drop_rate
            side = torch.where(draws["keep"], side / keep,
                               torch.zeros_like(side))
        rec = m.decode(z, side, w)
        wcol = w[:, None]
        z_sm = torch.softmax(z, dim=1)
        zgc_sm = torch.softmax(zgc, dim=1)
        log_z = torch.log(z_sm + 1e-10)
        # torch KLDivLoss(log_z, zgc): zgc * (log zgc - log_z), elementwise
        kl_el = torch.where(
            zgc_sm > 0,
            zgc_sm * (torch.log(zgc_sm.clamp_min(1e-38)) - log_z),
            torch.zeros_like(zgc_sm))
        if self.n_data > 1:  # mu of the global batch, every row
            mu_all = AllGatherRows.apply(mu, self.mesh.data_group, False)
            w_all = self.global_rows(batch, "weight")
        else:
            mu_all, w_all = mu, w
        p = self.reduce_parts(torch.cat([
            torch.stack([((rec - warm) ** 2 * wcol).sum(),
                         (kl_el * wcol).sum(), w.sum()]),
            uniformity_parts(mu, mu_all, w, w_all,
                             self.data_offset(w_all.shape[0]))]))
        denom = (p[2] * warm.shape[1]).clamp_min(1.0)
        rec_loss = p[0] / denom
        uni_loss = self.uni_coeff * torch.log(wmean_from_parts(p[3:5]))
        kl_loss = self.kl_coeff * p[1] / denom
        return rec_loss + uni_loss + kl_loss

    def forward_tables(self):
        n = (self.data.item_num if self.args.cold_object == "item"
             else self.data.user_num)
        side = self.content[:n]
        mu, _, _, _ = self.model.encode(self.warm_table, side)
        rec = self.model.decode(mu, side)
        if self.args.cold_object == "item":
            return self.backbone["user_emb"], rec
        return rec, self.backbone["item_emb"]

    def extra_saved_tensors(self) -> Dict[str, torch.Tensor]:
        return {"cluster_label": self.cluster_label}

