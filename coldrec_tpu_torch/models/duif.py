"""DUIF cold-start model (the port's copy of ``coldrec_tpu/models/duif.py``;
reference: model/DUIF.py).

The cold-object side's table is replaced entirely by a bias-free linear
projection of content (DUIF.py:87-91); the other side is a learned xavier
table. Trained jointly with BPR + L2: a "joint" model, no backbone.

On ``--mesh DxM`` both tables are row-sharded over the model axis (the JAX
rule; the cold side's takes no gradient), the warm side's rows come
through the trainer's lookup, the projected side is computed whole on
every rank, and the BPR + L2 parts are summed over the data group.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops.losses import bpr_l2_from_parts, bpr_l2_parts
from .cold_base import ColdStartModelBase
from .common import JaxCarried, linear_params, linear_slots, xavier_uniform


class DUIF(JaxCarried, nn.Module):
    def __init__(self, user_num: int, item_num: int, emb_size: int,
                 content_dim: int, seed: int = 2024, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        self.user_emb = nn.Parameter(xavier_uniform((user_num, emb_size),
                                                    gen))
        self.item_emb = nn.Parameter(xavier_uniform((item_num, emb_size),
                                                    gen))
        self.projector = linear_params(content_dim, emb_size, gen, bias=False)
        self.to(resolve_device(device))

    def jax_slots(self) -> list:
        return ([(("params", "user_emb"), self.user_emb, False),
                 (("params", "item_emb"), self.item_emb, False)]
                + linear_slots(self.projector, ("params", "projector")))

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        return {"user_num": params["user_emb"].shape[0],
                "item_num": params["item_emb"].shape[0],
                "emb_size": params["user_emb"].shape[1],
                "content_dim": params["projector"]["w"].shape[0]}


class DUIFTrainer(ColdStartModelBase):
    mesh_support = "sharded"

    def __init__(self, config, init_params: Optional[Dict] = None,
                 init_state: Optional[Dict] = None):
        super().__init__(config)
        self.content = self.cold_side_content
        self.model = self.init_module(
            DUIF, init_params, init_state, user_num=self.data.user_num,
            item_num=self.data.item_num, emb_size=self.emb_size,
            content_dim=self.content_dim)
        self.setup_optimizer()

    def projected(self) -> torch.Tensor:
        """The cold side's table: the projection of every row's content."""
        n = (self.data.item_num if self.args.cold_object == "item"
             else self.data.user_num)
        return self.model.projector(self.content[:n])

    def forward_tables(self):
        if self.args.cold_object == "item":
            return self.full_table("user_emb"), self.projected()
        return self.projected(), self.full_table("item_emb")

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.args.cold_object == "item":
            item_table = self.projected()
            u = self.lookup("user_emb", batch["user"])
            pos = item_table[batch["pos_item"]]
            neg = item_table[batch["neg_item"]]
        else:
            u = self.projected()[batch["user"]]
            pos = self.lookup("item_emb", batch["pos_item"])
            neg = self.lookup("item_emb", batch["neg_item"])
        parts = bpr_l2_parts(u, pos, neg, batch["weight"])
        return bpr_l2_from_parts(self.reduce_parts(parts), self.reg)
