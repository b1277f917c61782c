"""MTPR cold-start model (the port's copy of ``coldrec_tpu/models/mtpr.py``;
reference: model/MTPR.py).

Counterfactual dual representation: the cold side's factual vector
[id emb ∥ content·W] against its counterfactual [0 ∥ content·W]
(MTPR.py:126-138), both projected from 2d to d (wei for items, weu for
users); the WARM side's id table is 2d wide (P is (U, 2d) under item cold
start, MTPR.py:87-112). A four-way multi-task softplus BPR over the (ii,
ff, if, fi) pairs (MTPR.py:181-185) and the manual weighted L2 (187-202).
Three optimizers: ``torch.optim.Adagrad(lr1)`` on {P, Q}, ``Adam(lr2)`` on
{W, weu} and ``Adam(lr3)`` on {wei} (MTPR.py:19-21).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .cold_base import ColdStartModelBase
from .common import JaxCarried, xavier_uniform
from .warm_base import OptimizerGroups

TABLES = ("P", "Q", "W", "weu", "wei")


class MTPR(JaxCarried, nn.Module):
    def __init__(self, user_num: int, item_num: int, content_dim: int,
                 emb_size: int, cold_object: str = "item", seed: int = 2024,
                 device="cuda"):
        super().__init__()
        d = emb_size
        gen = torch.Generator().manual_seed(int(seed))
        wide_user = cold_object == "item"
        shapes = {"P": (user_num, 2 * d if wide_user else d),
                  "Q": (item_num, d if wide_user else 2 * d),
                  "W": (content_dim, d), "weu": (2 * d, d),
                  "wei": (2 * d, d)}
        for name in TABLES:
            setattr(self, name, nn.Parameter(xavier_uniform(shapes[name],
                                                            gen)))
        self.to(resolve_device(device))

    def jax_slots(self) -> list:
        return [(("params", name), getattr(self, name), False)
                for name in TABLES]

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        u, pw = params["P"].shape
        c, d = params["W"].shape
        return {"user_num": u, "item_num": params["Q"].shape[0],
                "content_dim": c, "emb_size": d,
                "cold_object": "item" if pw == 2 * d else "user"}


class MTPRTrainer(ColdStartModelBase):
    """``init_params`` (the JAX trainer's ``params`` as numpy) replaces the
    seeded tables."""

    # the JAX trainer never sets up a mesh: --mesh runs on one device
    mesh_support = "one_device"

    def __init__(self, config, init_params: Optional[Dict] = None):
        super().__init__(config)
        self.content = self.cold_side_content
        self.lr1, self.wd1 = [float(x) for x in self.args.p_emb]
        self.lr2, self.wd2 = [float(x) for x in self.args.p_ctx]
        self.lr3, self.wd3 = [float(x) for x in self.args.p_proj]
        self.model = self.init_module(
            MTPR, init_params, user_num=self.data.user_num,
            item_num=self.data.item_num, content_dim=self.content_dim,
            emb_size=self.emb_size, cold_object=self.args.cold_object)
        m = self.model
        self.setup_optimizer(optimizer=OptimizerGroups(
            torch.optim.Adagrad([m.P, m.Q], lr=self.lr1),
            torch.optim.Adam([m.W, m.weu], lr=self.lr2),
            torch.optim.Adam([m.wei], lr=self.lr3)))

    # --------------------------------------------------------------- pieces
    def user_vec(self, uid, factual: bool):
        m = self.model
        if self.args.cold_object == "item":
            return m.P[uid] @ m.weu
        idp = m.P[uid] if factual else torch.zeros_like(m.P[uid])
        return torch.cat([idp, self.content[uid] @ m.W], dim=1) @ m.weu

    def item_vec(self, iid, factual: bool):
        m = self.model
        if self.args.cold_object == "item":
            idq = m.Q[iid] if factual else torch.zeros_like(m.Q[iid])
            return torch.cat([idq, self.content[iid] @ m.W], dim=1) @ m.wei
        return m.Q[iid] @ m.wei

    def pred(self, uid, iid, factual: bool):
        """Scores of the factual (True) or counterfactual (False) pair; only
        the cold side's vector changes."""
        return (self.user_vec(uid, factual)
                * self.item_vec(iid, factual)).sum(dim=1)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        m = self.model
        uid, iid, nid = batch["user"], batch["pos_item"], batch["neg_item"]
        w = batch["weight"]

        def bpr(pp, pn):
            return (F.softplus(-(pp - pn)) * w).sum()

        pos = {f: self.pred(uid, iid, f) for f in (True, False)}
        neg = {f: self.pred(uid, nid, f) for f in (True, False)}
        loss = (bpr(pos[True], neg[True]) + bpr(pos[False], neg[False])
                + bpr(pos[True], neg[False]) + bpr(pos[False], neg[True]))
        wcol = w[:, None]
        emb_regs = ((m.P[uid] ** 2 * wcol).sum()
                    + (m.Q[iid] ** 2 * wcol).sum()
                    + (m.Q[nid] ** 2 * wcol).sum())
        ctx_regs = (m.W ** 2).sum() + (m.weu ** 2).sum()
        proj_regs = (m.wei ** 2).sum()
        return (loss + self.wd1 * emb_regs + self.wd2 * ctx_regs
                + self.wd3 * proj_regs)

    def forward_tables(self):
        m = self.model
        if self.args.cold_object == "item":
            ctx = self.content[: self.data.item_num] @ m.W
            return m.P @ m.weu, torch.cat([m.Q, ctx], dim=1) @ m.wei
        ctx = self.content[: self.data.user_num] @ m.W
        return torch.cat([m.P, ctx], dim=1) @ m.weu, m.Q @ m.wei
