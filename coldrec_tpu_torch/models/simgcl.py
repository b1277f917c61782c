"""SimGCL warm backbone (the port's copy of ``coldrec_tpu/models/simgcl.py``;
reference: model/SimGCL.py).

LightGCN propagation with per-layer uniform noise ``sign(e) *
normalize(U(0,1)) * eps`` when perturbed (SimGCL.py:101-113); CL loss =
InfoNCE between two independently perturbed views on the unique batch
users / items (53-60). The layer mean is over layers 1..L — layer 0 is
EXCLUDED, unlike LightGCN (SimGCL.py:110-111), so a node with no edge (a
cold item) gets an all-zero clean row. L2 applies to user + pos only
(SimGCL.py:29). The noise comes from the trainer's device generator, or is
injected (``noise_pair=``, as the JAX ``loss_fn`` takes it).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.losses import (
    _normalize, bpr_loss, info_nce_masked, l2_reg_loss, unique_padded,
)
from ..ops.spmm import spmm
from .lightgcn import GraphTrainer


def perturb(ego: torch.Tensor, eps: float, noise: Optional[torch.Tensor] =
            None, generator: Optional[torch.Generator] = None):
    """ego + sign(ego) * normalize(U(0,1)) * eps: the U(0,1) draw is
    ``noise`` or comes from ``generator``; neither -> ego unchanged."""
    if noise is None:
        if generator is None:
            return ego
        noise = torch.rand(ego.shape, generator=generator, device=ego.device,
                           dtype=ego.dtype)
    return ego + torch.sign(ego) * _normalize(noise) * eps


def simgcl_forward(graph, user_emb, item_emb, n_layers: int, eps: float,
                   generator: Optional[torch.Generator] = None, noise=None):
    """Perturbed (``generator`` or ``noise`` given) or clean LightGCN-style
    forward, mean over layers 1..L. ``noise``, an (L, U+I, d) stack of
    U(0,1) draws, overrides ``generator``."""
    ego = torch.cat([user_emb, item_emb], dim=0)
    acc = torch.zeros_like(ego)
    for layer in range(n_layers):
        ego = perturb(spmm(graph, ego), eps,
                      None if noise is None else noise[layer], generator)
        acc = acc + ego
    mean = acc / n_layers
    n_users = user_emb.shape[0]
    return mean[:n_users], mean[n_users:]


class ContrastiveTrainer(GraphTrainer):
    """The CL flags and the InfoNCE of the unique batch users and items."""

    def __init__(self, config, init_params: Optional[Dict] = None):
        self.eps = float(config.args.eps)
        self.cl_rate = float(config.args.cl_rate)
        self.tau = float(config.args.tau)
        super().__init__(config, init_params)

    def cl_loss(self, batch, user_a, item_a, user_b, item_b):
        w = batch["weight"]
        bs = batch["user"].shape[0]
        uu, um = unique_padded(batch["user"], w, bs, self.data.user_num)
        iu, im = unique_padded(batch["pos_item"], w, bs, self.data.item_num)
        return (info_nce_masked(user_a[uu], user_b[uu], um, self.tau)
                + info_nce_masked(item_a[iu], item_b[iu], im, self.tau))


class SimGCLTrainer(ContrastiveTrainer):
    def views(self, noise_pair=None):
        """The two perturbed (user, item) views."""
        m = self.model
        return [simgcl_forward(self.graph, m.user_emb, m.item_emb,
                               self.n_layers, self.eps, self.generator,
                               None if noise_pair is None else noise_pair[v])
                for v in range(2)]

    def loss(self, batch: Dict[str, torch.Tensor],
             noise_pair=None) -> torch.Tensor:
        u, pos, neg, w = self.rows(batch, *self.forward_tables())
        rec = bpr_loss(u, pos, neg, w)
        (uv1, iv1), (uv2, iv2) = self.views(noise_pair)
        cl = self.cl_loss(batch, uv1, iv1, uv2, iv2)
        return rec + l2_reg_loss(self.reg, u, pos, weight=w) + self.cl_rate * cl

    def forward_tables(self):
        m = self.model
        return simgcl_forward(self.graph, m.user_emb, m.item_emb,
                              self.n_layers, self.eps)
