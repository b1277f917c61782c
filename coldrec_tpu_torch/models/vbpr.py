"""VBPR cold-start model (the port's copy of ``coldrec_tpu/models/vbpr.py``;
reference: model/VBPR.py).

Two scores summed: P·Q (id tables, started from the backbone's and
fine-tuned) + PQ2·(content·W) (the content path). Two optimizers,
``torch.optim.Adagrad(lr1)`` on {P, Q, PQ2} and ``torch.optim.Adam(lr2)`` on
W (VBPR.py:18-19; the JAX package pins its Adagrad to torch's: eps outside
the square root). Loss = sum of softplus(neg - pos) + the manual weighted L2
(VBPR.py:136-165: the (lr, wd) pairs put wd into the loss, the optimizers'
weight decay stays 0). Eval concatenates the two factor pairs, so the
tables are 2d wide and one product gives score1 + score2. The best
weights' five tensors go to the bus for AMR (VBPR.py:49-54).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .cold_base import ColdStartModelBase
from .common import JaxCarried, table_param, xavier_uniform
from .warm_base import OptimizerGroups

TABLES = ("P", "Q", "PQ2", "W")


class VBPR(JaxCarried, nn.Module):
    """The id tables P (users) and Q (items), the aux table PQ2 of the warm
    side and the content projection W (c, d)."""

    def __init__(self, P, Q, content_dim: int, aux_rows: int, PQ2=None,
                 W=None, seed: int = 2024, device="cuda"):
        super().__init__()
        d = int(P.shape[1])
        gen = torch.Generator().manual_seed(int(seed))
        self.P = table_param(P)
        self.Q = table_param(Q)
        self.PQ2 = table_param(xavier_uniform((aux_rows, d), gen)
                               if PQ2 is None else PQ2)
        self.W = table_param(xavier_uniform((content_dim, d), gen)
                             if W is None else W)
        self.to(resolve_device(device))

    def jax_slots(self) -> list:
        return [(("params", name), getattr(self, name), False)
                for name in TABLES]

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        return {"P": params["P"], "Q": params["Q"],
                "content_dim": params["W"].shape[0],
                "aux_rows": params["PQ2"].shape[0]}


class VBPRTrainer(ColdStartModelBase):
    """``init_params`` (the JAX trainer's ``params`` as numpy) replaces the
    seeded tables and the bus tables."""

    # the JAX trainer never sets up a mesh: --mesh runs on one device
    mesh_support = "one_device"

    def __init__(self, config, init_params: Optional[Dict] = None):
        super().__init__(config)
        self.content = self.cold_side_content
        self.lr1, self.wd1 = [float(x) for x in self.args.p_emb]
        self.lr2, self.wd2 = [float(x) for x in self.args.p_ctx]
        self.model = self.init_module(VBPR, init_params, **self.tables())
        self.setup_optimizer(optimizer=OptimizerGroups(
            torch.optim.Adagrad([self.model.P, self.model.Q, self.model.PQ2],
                                lr=self.lr1),
            torch.optim.Adam([self.model.W], lr=self.lr2)))

    def tables(self) -> dict:
        """The module's starting tables: the backbone's P and Q."""
        backbone = self.load_backbone()
        aux_rows = (self.data.user_num if self.args.cold_object == "item"
                    else self.data.item_num)
        return {"P": backbone["user_emb"], "Q": backbone["item_emb"],
                "content_dim": self.content_dim, "aux_rows": aux_rows}

    # --------------------------------------------------------------- scores
    def pair_scores(self, uid, iid, content_rows):
        """P·Q + the content score, the cold side's content rows given."""
        m = self.model
        p1 = (m.P[uid] * m.Q[iid]).sum(dim=1)
        if self.args.cold_object == "item":
            p2 = (m.PQ2[uid] * (content_rows @ m.W)).sum(dim=1)
        else:
            p2 = ((content_rows @ m.W) * m.PQ2[iid]).sum(dim=1)
        return p1 + p2

    def cold_rows(self, batch):
        """The content rows of the pos and neg pairs' cold-side entities."""
        if self.args.cold_object == "item":
            return (self.content[batch["pos_item"]],
                    self.content[batch["neg_item"]])
        rows = self.content[batch["user"]]
        return rows, rows

    def bpr_sum(self, batch, c_pos, c_neg) -> torch.Tensor:
        """The weighted sum of softplus(neg - pos)."""
        pred_p = self.pair_scores(batch["user"], batch["pos_item"], c_pos)
        pred_n = self.pair_scores(batch["user"], batch["neg_item"], c_neg)
        return (F.softplus(-(pred_p - pred_n)) * batch["weight"]).sum()

    def regs(self, batch) -> torch.Tensor:
        """wd1 * the weighted squared rows + wd2 * |W|^2."""
        m = self.model
        uid, iid, nid = batch["user"], batch["pos_item"], batch["neg_item"]
        wcol = batch["weight"][:, None]

        def sq(t):
            return (t ** 2 * wcol).sum()

        if self.args.cold_object == "item":
            emb = sq(m.P[uid]) + sq(m.PQ2[uid]) + sq(m.Q[iid]) + sq(m.Q[nid])
        else:
            emb = (sq(m.P[uid]) + sq(m.PQ2[iid]) + sq(m.PQ2[nid])
                   + sq(m.Q[iid]) + sq(m.Q[nid]))
        return self.wd1 * emb + self.wd2 * (m.W ** 2).sum()

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.bpr_sum(batch, *self.cold_rows(batch)) + self.regs(batch)

    # ----------------------------------------------------------------- eval
    def aux_tables(self):
        """(aux_u, aux_i): PQ2 and content·W, on their sides."""
        m = self.model
        if self.args.cold_object == "item":
            return m.PQ2, self.content[: self.data.item_num] @ m.W
        return self.content[: self.data.user_num] @ m.W, m.PQ2

    def forward_tables(self):
        """[P ∥ aux_u] · [Q ∥ aux_i]^T = score1 + score2."""
        aux_u, aux_i = self.aux_tables()
        m = self.model
        return torch.cat([m.P, aux_u], dim=1), torch.cat([m.Q, aux_i], dim=1)

    def save(self):
        super().save()
        # copies now: the optimizers update the tables in place
        m = self.model
        with torch.no_grad():
            aux_u, aux_i = self.aux_tables()
            self._best_extra = {
                "user_emb_main_P": m.P.detach().clone(),
                "item_emb_main_Q": m.Q.detach().clone(),
                "user_emb_aux": aux_u.detach().clone(),
                "item_emb_aux": aux_i.detach().clone(),
                "W": m.W.detach().clone(),
            }

    def extra_saved_tensors(self) -> Dict[str, torch.Tensor]:
        return getattr(self, "_best_extra", {})
