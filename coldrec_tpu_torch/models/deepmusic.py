"""DeepMusic cold-start generator (the port's copy of
``coldrec_tpu/models/deepmusic.py``; reference: model/DeepMusic.py).

An MLP (content -> 2d -> d, ReLU) regresses the frozen backbone embeddings
of the cold-object side: per batch, MSE between the backbone embeddings of
the batch's entities and their generated content embeddings, plus L2 on the
generated ones (DeepMusic.py:22-29). Eval tables = the frozen backbone
tables with the cold rows overwritten by generator(content)
(DeepMusic.py:42-47).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops.losses import l2_reg_loss, mse_loss
from .cold_base import ColdStartModelBase
from .common import JaxCarried, mlp_apply, mlp_params, mlp_slots


class DeepMusic(JaxCarried, nn.Module):
    def __init__(self, content_dim: int, emb_size: int, seed: int = 2024,
                 device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        self.transform = mlp_params([content_dim, 2 * emb_size, emb_size],
                                    gen)
        self.to(resolve_device(device))

    def generate(self, content: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.transform, content)

    def jax_slots(self) -> list:
        return mlp_slots(self.transform, ("params", "transform"))

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        return {"content_dim": params["transform"][0]["w"].shape[0],
                "emb_size": params["transform"][-1]["w"].shape[1]}


class DeepMusicTrainer(ColdStartModelBase):
    def __init__(self, config, init_params: Optional[Dict] = None,
                 init_state: Optional[Dict] = None):
        super().__init__(config)
        self.backbone = self.load_backbone()
        self.content = self.cold_side_content
        self.model = self.init_module(
            DeepMusic, init_params, init_state, content_dim=self.content_dim,
            emb_size=self.emb_size)
        self.setup_optimizer()

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.args.cold_object == "item":
            idx, table = batch["pos_item"], self.backbone["item_emb"]
        else:
            idx, table = batch["user"], self.backbone["user_emb"]
        gen = self.model.generate(self.content[idx])
        w = batch["weight"]
        return mse_loss(gen, table[idx], w) + l2_reg_loss(self.reg, gen,
                                                          weight=w)

    def forward_tables(self):
        gen = self.model.generate(self.content[self.cold_idx])
        return self.patch_cold_rows(self.backbone["user_emb"],
                                    self.backbone["item_emb"], gen)
