"""GAR cold-start generator (the port's copy of
``coldrec_tpu/models/gar.py``; reference: model/GAR.py).

Generator-vs-recommender objective (GAR.py:25-31):
  gen_loss = (1-alpha)*BPR(u, gen, pos) + alpha*MSE(pos, gen)
  rec_loss = (1-beta)*BPR(u, pos, gen) + beta*BPR(u, pos, neg)
Generator = content -> 2d tanh -> d tanh MLP (GAR.py:102-107). The backbone
tables are loaded from the bus and fine-tuned (plain Parameters,
GAR.py:110-115). Eval patches the cold rows with the generator's output.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops.losses import bpr_loss, l2_reg_loss, mse_loss
from .cold_base import ColdStartModelBase
from .common import (
    JaxCarried, mlp_apply, mlp_params, mlp_slots, table_param,
)


class GAR(JaxCarried, nn.Module):
    def __init__(self, content_dim: int, user_emb, item_emb,
                 seed: int = 2024, device="cuda"):
        super().__init__()
        d = int(user_emb.shape[1])
        gen = torch.Generator().manual_seed(int(seed))
        self.generator = mlp_params([content_dim, 2 * d, d], gen)
        self.user_emb = table_param(user_emb)
        self.item_emb = table_param(item_emb)
        self.to(resolve_device(device))

    def generate(self, content: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.generator, content, activation=torch.tanh,
                         final_activation=torch.tanh)

    def jax_slots(self) -> list:
        return ([(("params", "user_emb"), self.user_emb, False),
                 (("params", "item_emb"), self.item_emb, False)]
                + mlp_slots(self.generator, ("params", "generator")))

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        return {"content_dim": params["generator"][0]["w"].shape[0],
                "user_emb": params["user_emb"],
                "item_emb": params["item_emb"]}


class GARTrainer(ColdStartModelBase):
    def __init__(self, config, init_params: Optional[Dict] = None,
                 init_state: Optional[Dict] = None):
        super().__init__(config)
        backbone = self.load_backbone()
        self.alpha = float(self.args.alpha)
        self.beta = float(self.args.beta)
        self.content = self.cold_side_content
        self.model = self.init_module(
            GAR, init_params, init_state, content_dim=self.content_dim,
            user_emb=backbone["user_emb"], item_emb=backbone["item_emb"])
        self.setup_optimizer()

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        m = self.model
        u = m.user_emb[batch["user"]]
        pos = m.item_emb[batch["pos_item"]]
        neg = m.item_emb[batch["neg_item"]]
        w = batch["weight"]
        a, b = self.alpha, self.beta
        if self.args.cold_object == "item":
            gen = m.generate(self.content[batch["pos_item"]])
            gen_loss = ((1 - a) * bpr_loss(u, gen, pos, w)
                        + a * mse_loss(gen, pos, w))
        else:
            gen = m.generate(self.content[batch["user"]])
            gen_loss = ((1 - a) * bpr_loss(pos, gen, u, w)
                        + a * mse_loss(gen, u, w))
        rec_loss = ((1 - b) * bpr_loss(u, pos, gen, w)
                    + b * bpr_loss(u, pos, neg, w))
        return gen_loss + rec_loss + l2_reg_loss(self.reg, u, pos, neg, gen,
                                                 weight=w)

    def forward_tables(self):
        m = self.model
        return self.patch_cold_rows(m.user_emb, m.item_emb,
                                    m.generate(self.content[self.cold_idx]))
