"""NGCF warm backbone (the port's copy of ``coldrec_tpu/models/ngcf.py``;
reference: model/NGCF.py).

Per layer: side = Â·E; E' = LeakyReLU_0.01(W_gc(side) + W_bi(E ⊙ side));
mean over layers 0..L (NGCF.py:90-104). Per-layer learned Linears, carried
from the JAX package's (in, out) weights by ``jax_slots``.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..device import resolve_device
from ..ops.losses import bpr_loss, l2_reg_loss
from ..ops.spmm import spmm
from .common import linear_params, linear_slots
from .lightgcn import GraphTables, GraphTrainer


class NGCF(GraphTables):
    """The ego tables and the per-layer ``W_gc`` / ``W_bi`` Linears."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64,
                 n_layers: int = 2, seed: int = 2024, device="cuda"):
        super().__init__(user_num, item_num, emb_size, seed, device="cpu")
        gen = torch.Generator().manual_seed(int(seed) + 1)
        self.W_gc = nn.ModuleList()
        self.W_bi = nn.ModuleList()
        for _ in range(n_layers):
            self.W_gc.append(linear_params(emb_size, emb_size, gen))
            self.W_bi.append(linear_params(emb_size, emb_size, gen))
        self.to(resolve_device(device))

    def jax_slots(self) -> list:
        slots = super().jax_slots()
        for name in ("W_gc", "W_bi"):
            for layer, lin in enumerate(getattr(self, name)):
                slots += linear_slots(lin, ("params", name, layer))
        return slots

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        return {**GraphTables.jax_shapes(params),
                "n_layers": len(params["W_gc"])}

    def propagate(self, graph):
        ego = torch.cat([self.user_emb, self.item_emb], dim=0)
        acc = ego
        for gc, bi in zip(self.W_gc, self.W_bi):
            side = spmm(graph, ego)
            ego = nn.functional.leaky_relu(gc(side) + bi(ego * side),
                                           negative_slope=0.01)
            acc = acc + ego
        mean = acc / (len(self.W_gc) + 1)
        n_users = self.user_emb.shape[0]
        return mean[:n_users], mean[n_users:]


class NGCFTrainer(GraphTrainer):
    module = NGCF

    def module_kw(self) -> dict:
        return {"n_layers": self.n_layers}

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        u, pos, neg, w = self.rows(batch, *self.forward_tables())
        return bpr_loss(u, pos, neg, w) + l2_reg_loss(self.reg, u, pos, neg,
                                                      weight=w)

    def forward_tables(self):
        return self.model.propagate(self.graph)
