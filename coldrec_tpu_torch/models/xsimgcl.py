"""XSimGCL warm backbone (the port's copy of
``coldrec_tpu/models/xsimgcl.py``; reference: model/XSimGCL.py).

A single perturbed forward returns both the final (mean over layers 1..L)
embeddings and a snapshot at layer l_cl; CL is InfoNCE between the two
(XSimGCL.py:106-124, 58-63): one perturbed forward a step, not SimGCL's
three. Requires 1 <= l_cl <= layers (XSimGCL.py:14-18). The noise comes
from the trainer's device generator, or is injected (``noise=``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.losses import bpr_loss, l2_reg_loss
from ..ops.spmm import spmm
from .simgcl import ContrastiveTrainer, perturb


class XSimGCLTrainer(ContrastiveTrainer):
    def check_flags(self):
        self.layer_cl = int(self.args.l_cl)
        if not (1 <= self.layer_cl <= self.n_layers):
            raise ValueError(
                "XSimGCL requires 1 <= l_cl <= layers; "
                f"got l_cl={self.layer_cl}, layers={self.n_layers}.")

    def forward(self, perturbed: bool, noise=None):
        """(user, item, cl_user, cl_item); clean unless ``perturbed``.
        ``noise``, an (L, U+I, d) stack of U(0,1) draws, overrides the
        generator (XSimGCL.py:112-114)."""
        m = self.model
        ego = torch.cat([m.user_emb, m.item_emb], dim=0)
        acc = torch.zeros_like(ego)
        snapshot = ego
        gen = self.generator if perturbed else None
        for layer in range(self.n_layers):
            ego = perturb(spmm(self.graph, ego), self.eps,
                          None if noise is None else noise[layer], gen)
            acc = acc + ego
            if layer == self.layer_cl - 1:
                snapshot = ego
        mean = acc / self.n_layers
        nu = self.data.user_num
        return mean[:nu], mean[nu:], snapshot[:nu], snapshot[nu:]

    def loss(self, batch: Dict[str, torch.Tensor],
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        ut, it, cu, ci = self.forward(True, noise)
        u, pos, neg, w = self.rows(batch, ut, it)
        rec = bpr_loss(u, pos, neg, w)
        cl = self.cl_loss(batch, ut, it, cu, ci)
        return rec + l2_reg_loss(self.reg, u, pos, weight=w) + self.cl_rate * cl

    def forward_tables(self):
        ut, it, _, _ = self.forward(False)
        return ut, it
