"""Heater cold-start re-encoder (the port's copy of
``coldrec_tpu/models/heater.py``; reference: model/Heater.py).

Mixture-of-experts content tower: n_expert shared-weight FC experts (the
reference calls the same DenseFC n times, Heater.py:191-194, so the expert
mix is gate.sum() * fc(content)), tanh gate, the similarity-constraint
diff loss alpha*sum||content_emb - emb||^2 (Heater.py:197), the blend
emb*(1-p) + content_emb*p at p = n_dropout (198; the JAX package blends by
the dropout rate, no draw), shared out/trans Linears (218-222). Target =
the frozen backbone pair scores (MSE). Eval re-encodes all users+items
(127-136). The backbone is frozen (105-106).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from .cold_base import ColdStartModelBase
from .common import JaxCarried, linear_params, linear_slots

LAYERS = ("fc1", "fc2", "gate", "out", "trans")


class Heater(JaxCarried, nn.Module):
    def __init__(self, content_dim: int, emb_size: int, hidden: int,
                 n_expert: int, seed: int = 2024, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        d = emb_size
        self.fc1 = linear_params(content_dim, hidden, gen)
        self.fc2 = linear_params(hidden, d, gen)
        self.gate = linear_params(content_dim, n_expert, gen)
        self.out = linear_params(d, d, gen)
        self.trans = linear_params(d, d, gen)
        self.to(resolve_device(device))

    def content_emb(self, content: torch.Tensor) -> torch.Tensor:
        """tanh(bmm(gate, expert stack)); the experts share weights, so the
        mix is (sum_e gate_e) * fc(content) (Heater.py:187-195)."""
        gate = torch.tanh(self.gate(content))
        expert = torch.tanh(self.fc2(torch.tanh(self.fc1(content))))
        return torch.tanh(gate.sum(dim=1, keepdim=True) * expert)

    def jax_slots(self) -> list:
        return [s for name in LAYERS
                for s in linear_slots(getattr(self, name), ("params", name))]

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        return {"content_dim": params["fc1"]["w"].shape[0],
                "emb_size": params["fc2"]["w"].shape[1],
                "hidden": params["fc1"]["w"].shape[1],
                "n_expert": params["gate"]["w"].shape[1]}


class HeaterTrainer(ColdStartModelBase):
    def __init__(self, config, init_params: Optional[Dict] = None,
                 init_state: Optional[Dict] = None):
        super().__init__(config)
        self.backbone = self.load_backbone()
        self.content = self.cold_side_content
        self.alpha = float(self.args.alpha)
        self.n_dropout = float(self.args.n_dropout)
        self.model = self.init_module(
            Heater, init_params, init_state, content_dim=self.content_dim,
            emb_size=self.emb_size, hidden=int(self.args.heater_mlp_hidden),
            n_expert=int(self.args.n_expert))
        self.setup_optimizer()

    def _encode(self, user_emb, item_emb, content, weight=None):
        """(U_emb, V_emb, diff_loss), the cold-object side fed content."""
        m = self.model
        item = self.args.cold_object == "item"
        cold_in = item_emb if item else user_emb
        c_last = m.content_emb(content)
        sq = ((c_last - cold_in) ** 2).sum(dim=1)
        if weight is not None:
            sq = sq * weight
        diff_loss = self.alpha * sq.sum()
        keep = 1.0 - self.n_dropout
        blended = cold_in * keep + c_last * (1.0 - keep)
        u_last, v_last = (user_emb, blended) if item else (blended, item_emb)
        u_last = torch.tanh(m.out(u_last))
        v_last = torch.tanh(m.out(v_last))
        return m.trans(u_last), m.trans(v_last), diff_loss

    def _pair_pred(self, uid, iid, weight):
        ue = self.backbone["user_emb"][uid]
        ie = self.backbone["item_emb"][iid]
        cid = iid if self.args.cold_object == "item" else uid
        u, v, diff = self._encode(ue, ie, self.content[cid], weight)
        return (u * v).sum(dim=1), diff

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        ue, ie = self.backbone["user_emb"], self.backbone["item_emb"]
        w = batch["weight"]
        u = ue[batch["user"]]
        pos_t = (u * ie[batch["pos_item"]]).sum(dim=1)
        neg_t = (u * ie[batch["neg_item"]]).sum(dim=1)
        pos_p, diff1 = self._pair_pred(batch["user"], batch["pos_item"], w)
        neg_p, diff2 = self._pair_pred(batch["user"], batch["neg_item"], w)
        se = ((pos_p - pos_t) ** 2 + (neg_p - neg_t) ** 2) * w
        mse = se.sum() / (2 * w.sum()).clamp_min(1.0)
        return mse + diff1 + diff2

    def forward_tables(self):
        n = (self.data.item_num if self.args.cold_object == "item"
             else self.data.user_num)
        u, v, _ = self._encode(self.backbone["user_emb"],
                               self.backbone["item_emb"], self.content[:n])
        return u, v
