"""GAR cold-start generator (the port's copy of
``coldrec_tpu/models/gar.py``; reference: model/GAR.py).

Generator-vs-recommender objective (GAR.py:25-31):
  gen_loss = (1-alpha)*BPR(u, gen, pos) + alpha*MSE(pos, gen)
  rec_loss = (1-beta)*BPR(u, pos, gen) + beta*BPR(u, pos, neg)
Generator = content -> 2d tanh -> d tanh MLP (GAR.py:102-107). The backbone
tables are loaded from the bus and fine-tuned (plain Parameters,
GAR.py:110-115). Eval patches the cold rows with the generator's output.

On ``--mesh DxM`` both tables are row-sharded over the model axis and read
through the trainer's lookups (the eval patch on the tables gathered
whole); the loss's parts (four BPR sums, the MSE sum, the weight and the
L2 squares) are summed over the data group.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops.losses import (
    bpr_parts, l2_from_parts, l2_parts, wmean_from_parts, wmean_parts,
)
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
    mesh_support = "sharded"

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
        u = self.lookup("user_emb", batch["user"])
        pos = self.lookup("item_emb", batch["pos_item"])
        neg = self.lookup("item_emb", batch["neg_item"])
        w = batch["weight"]
        a, b = self.alpha, self.beta
        if self.args.cold_object == "item":
            gen = m.generate(self.content[batch["pos_item"]])
            gen_parts = [bpr_parts(u, gen, pos, w),
                         wmean_parts((gen - pos) ** 2, w)]
        else:
            gen = m.generate(self.content[batch["user"]])
            gen_parts = [bpr_parts(pos, gen, u, w),
                         wmean_parts((gen - u) ** 2, w)]
        # [gen BPR, gen MSE, rec BPR vs gen, rec BPR vs neg] as (sum, count)
        # pairs, then the L2 squares of u, pos, neg, gen
        p = self.reduce_parts(torch.cat(
            gen_parts + [bpr_parts(u, pos, gen, w), bpr_parts(u, pos, neg, w),
                         l2_parts(u, pos, neg, gen, weight=w)]))
        gen_loss = ((1 - a) * wmean_from_parts(p[0:2])
                    + a * wmean_from_parts(p[2:4]))
        rec_loss = ((1 - b) * wmean_from_parts(p[4:6])
                    + b * wmean_from_parts(p[6:8]))
        return gen_loss + rec_loss + l2_from_parts(p[8:], p[1].clamp_min(1.0),
                                                   self.reg)

    def forward_tables(self):
        m = self.model
        return self.patch_cold_rows(self.full_table("user_emb"),
                                    self.full_table("item_emb"),
                                    m.generate(self.content[self.cold_idx]))
