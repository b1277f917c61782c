"""AMR cold-start model (the port's copy of ``coldrec_tpu/models/amr.py``;
reference: model/AMR.py).

VBPR plus adversarial FGSM noise on the content: the noise direction is
the gradient of the softplus-BPR sum with respect to the gathered content
rows, detached; the adversarial pass moves each row by eps * the
normalized direction, and its loss is weighted by lmd (AMR.py:146-180).
Starts from **VBPR's** bus (P, Q, the aux table, W; AMR.py:94-124), not
the backbone's.

Divergence from the reference, kept from the JAX package: the reference
takes the gradient with respect to the FULL content matrix, so an item
that occurs several times in one batch sums its occurrences' gradients
into one noise row; here the gradient is per batch row (the same when the
batch's items are distinct).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ops.losses import _normalize
from .vbpr import VBPRTrainer


class AMRTrainer(VBPRTrainer):
    def __init__(self, config, init_params=None):
        super().__init__(config, init_params)
        self.eps = float(self.args.eps)
        self.lmd = float(self.args.lmd)

    def tables(self) -> dict:
        """VBPR's five tensors from the bus (its P, Q, aux table and W)."""
        vbpr = self.load_backbone(
            model="VBPR",
            required=("user_emb_main_P", "item_emb_main_Q", "W"))
        aux_key = ("user_emb_aux" if self.args.cold_object == "item"
                   else "item_emb_aux")
        if aux_key not in vbpr:
            raise KeyError(f"VBPR checkpoint missing {aux_key}")
        return {"P": vbpr["user_emb_main_P"], "Q": vbpr["item_emb_main_Q"],
                "content_dim": int(vbpr["W"].shape[0]),
                "aux_rows": int(vbpr[aux_key].shape[0]),
                "PQ2": vbpr[aux_key], "W": vbpr["W"]}

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        c_pos, c_neg = (c.detach().requires_grad_(True)
                        for c in self.cold_rows(batch))
        # the FGSM direction: d(softplus BPR sum) / d(content rows)
        g_pos, g_neg = torch.autograd.grad(
            self.bpr_sum(batch, c_pos, c_neg), (c_pos, c_neg))
        c_pos, c_neg = c_pos.detach(), c_neg.detach()
        loss = self.bpr_sum(batch, c_pos, c_neg)
        adv = self.bpr_sum(batch, c_pos + self.eps * _normalize(g_pos, dim=1),
                           c_neg + self.eps * _normalize(g_neg, dim=1))
        return loss + self.lmd * adv + self.regs(batch)
