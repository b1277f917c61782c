"""MetaEmbedding cold-start generator (the port's copy of
``coldrec_tpu/models/metaembedding.py``; reference: model/MetaEmbedding.py).

MAML-lite: the meta embedding is Linear(content) / 5 (MetaEmbedding.py:
129-138); loss_a is the BCE-with-logits of the scores with the meta
embedding; one gradient step of lr / 10 on the meta embedding gives the
adapted embedding; loss_b scores with that; total = alpha * loss_a +
(1 - alpha) * loss_b (MetaEmbedding.py:30-47). The adapted embedding stays
differentiable through the inner gradient: ``torch.autograd.grad(...,
create_graph=True)``, the reference's second-order step (194) and the JAX
package's nested ``jax.grad``. The backbone tables are frozen; eval patches
the cold rows with the meta embeddings.

On ``--mesh DxM`` nothing shards (the backbone tables are buffers): each
data rank takes its block of the batch. Both BCE means divide by the
global batch's weight (``global_keys``), also inside the inner step, so
each row's inner gradient is that of the global loss_a; the numerators are
summed over the data group.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops.losses import bce_with_logits
from .cold_base import ColdStartModelBase
from .common import JaxCarried, linear_params, linear_slots


class MetaEmbedding(JaxCarried, nn.Module):
    def __init__(self, content_dim: int, emb_size: int, seed: int = 2024,
                 device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        self.dense = linear_params(content_dim, emb_size, gen)
        self.to(resolve_device(device))

    def forward(self, content_rows):
        return self.dense(content_rows) / 5.0

    def jax_slots(self) -> list:
        return linear_slots(self.dense, ("params", "dense"))

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        c, d = params["dense"]["w"].shape
        return {"content_dim": c, "emb_size": d}


class MetaEmbeddingTrainer(ColdStartModelBase):
    """``init_params`` (the JAX trainer's ``params`` as numpy) replaces the
    seeded layer."""

    mesh_support = "sharded"
    global_keys = ("weight",)

    def __init__(self, config, init_params: Optional[Dict] = None):
        super().__init__(config)
        self.backbone = self.load_backbone()
        self.content = self.cold_side_content
        self.cold_lr = self.lr / 10.0
        self.alpha = float(self.args.alpha)
        self.model = self.init_module(MetaEmbedding, init_params,
                                      content_dim=self.content_dim,
                                      emb_size=self.emb_size)
        self.setup_optimizer()

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        uid = torch.cat([batch["user"], batch["user"]])
        iid = torch.cat([batch["pos_item"], batch["neg_item"]])
        w = torch.cat([batch["weight"], batch["weight"]])
        n = batch["user"].shape[0]
        targets = torch.cat([torch.ones(n, device=w.device),
                             torch.zeros(n, device=w.device)])
        ue = self.backbone["user_emb"][uid]
        ie = self.backbone["item_emb"][iid]
        item_cold = self.args.cold_object == "item"
        meta = self.model(self.content[iid if item_cold else uid])

        w_all = self.global_rows(batch, "weight")
        denom = torch.cat([w_all, w_all]).sum().clamp_min(1.0)

        def numerator(emb):
            y = (ue * emb).sum(dim=1) if item_cold else (emb * ie).sum(dim=1)
            return (bce_with_logits(y, targets) * w).sum()

        num_a = numerator(meta)
        adapted = meta - self.cold_lr * self.inner_grad(num_a / denom, meta)
        p = self.reduce_parts(torch.stack([num_a, numerator(adapted)]))
        return self.alpha * (p[0] / denom) + (1 - self.alpha) * (p[1] / denom)

    @staticmethod
    def inner_grad(loss_a: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
        """d loss_a / d meta, keeping its graph (second order: the adapted
        embedding stays differentiable through it). ``loss_a`` is this
        rank's numerator over the global weight, so each of its rows gets
        the global loss_a's gradient."""
        (grad,) = torch.autograd.grad(loss_a, meta, create_graph=True)
        return grad

    def forward_tables(self):
        gen = self.model(self.content[self.cold_idx])
        return self.patch_cold_rows(self.backbone["user_emb"],
                                    self.backbone["item_emb"], gen)
