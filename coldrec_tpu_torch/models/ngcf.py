"""NGCF warm backbone (the port's copy of ``coldrec_tpu/models/ngcf.py``;
reference: model/NGCF.py).

Per layer: side = Â·E; E' = LeakyReLU_0.01(W_gc(side) + W_bi(E ⊙ side));
mean over layers 0..L (NGCF.py:90-104). Per-layer learned Linears, carried
from the JAX package's (in, out) weights by ``jax_slots``. The propagation
is ``GraphTrainer``'s with NGCF's layer as its hook; BPR + L2 (u, pos,
neg) as additive parts, summed over the data axis of a mesh.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..device import resolve_device
from ..ops.losses import bpr_l2_from_parts, bpr_l2_parts
from ..parallel.ops import CopyToGroup
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

    def layer(self, k: int, side: torch.Tensor, prev: torch.Tensor,
              group=None) -> torch.Tensor:
        """Layer ``k`` + 1 from ``side`` = Â ``prev``. ``group``: the
        Linears act on this rank's node block, so their gradient is summed
        over the group (``CopyToGroup``)."""
        gc, bi = self.W_gc[k], self.W_bi[k]
        if group is None:
            return nn.functional.leaky_relu(gc(side) + bi(prev * side),
                                            negative_slope=0.01)
        w = [CopyToGroup.apply(p, group) for p in (gc.weight, gc.bias,
                                                   bi.weight, bi.bias)]
        return nn.functional.leaky_relu(
            nn.functional.linear(side, w[0], w[1])
            + nn.functional.linear(prev * side, w[2], w[3]),
            negative_slope=0.01)


class NGCFTrainer(GraphTrainer):
    """On the mesh graph each rank runs the Linears on its node block and
    sums their gradient over the model group, so the replicated weights
    stay the same on every rank."""

    module = NGCF

    def module_kw(self) -> dict:
        return {"n_layers": self.n_layers}

    def layer_hook(self):
        group = self.mesh.model_group if self.on_mesh else None

        def hook(k, side, prev):
            return self.model.layer(k, side, prev, group)

        return hook

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        mean, _ = self.propagate(self.layer_hook())
        u, pos, neg = self.node_rows([mean], self.batch_groups(batch))[0]
        parts = bpr_l2_parts(u, pos, neg, batch["weight"])
        return bpr_l2_from_parts(self.reduce_parts(parts), self.reg)

    def forward_tables(self):
        return self.node_tables(self.propagate(self.layer_hook())[0])
