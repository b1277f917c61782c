"""DUIF cold-start model (the port's copy of ``coldrec_tpu/models/duif.py``;
reference: model/DUIF.py).

The cold-object side's table is replaced entirely by a bias-free linear
projection of content (DUIF.py:87-91); the other side is a learned xavier
table. Trained jointly with BPR + L2: a "joint" model, no backbone.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops.losses import bpr_loss, l2_reg_loss
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
    def __init__(self, config, init_params: Optional[Dict] = None,
                 init_state: Optional[Dict] = None):
        super().__init__(config)
        self.content = self.cold_side_content
        self.model = self.init_module(
            DUIF, init_params, init_state, user_num=self.data.user_num,
            item_num=self.data.item_num, emb_size=self.emb_size,
            content_dim=self.content_dim)
        self.setup_optimizer()

    def forward_tables(self):
        m = self.model
        if self.args.cold_object == "item":
            return m.user_emb, m.projector(self.content[: self.data.item_num])
        return m.projector(self.content[: self.data.user_num]), m.item_emb

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        user_table, item_table = self.forward_tables()
        u = user_table[batch["user"]]
        pos = item_table[batch["pos_item"]]
        neg = item_table[batch["neg_item"]]
        w = batch["weight"]
        return bpr_loss(u, pos, neg, w) + l2_reg_loss(self.reg, u, pos, neg,
                                                      weight=w)
