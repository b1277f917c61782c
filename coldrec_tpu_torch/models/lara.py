"""LARA cold-start conditional GAN (the port's copy of
``coldrec_tpu/models/lara.py``; reference: model/LARA.py).

Generator: [content ∥ backbone emb] -> three tanh Linear layers -> a fake
embedding (LARA.py:116-140); the discriminator scores [content ∥ emb]
(142-152). One joint Adam over everything (17, 43): D gets the real / fake
/ counter BCE terms, G the term that fools D, and both reach both nets and
the (trainable) backbone tables, as the reference's single optimizer does.
Batches come from the LARA sampler (a positive pair with a negative user
AND a negative item, utils.py:160-188). Eval replaces the cold side's table
ENTIRELY with the generator's output (LARA.py:116-128).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..data.sampler import pairwise_batches_with_neg_users
from ..device import resolve_device
from ..ops.losses import bce_with_logits
from .cold_base import ColdStartModelBase
from .common import JaxCarried, linear_params, linear_slots, table_param

LAYERS = ("G1", "G2", "G3", "D1", "D2", "D3")


def bce_logits_mean(logits, targets, weight):
    """BCE-with-logits per element, the mean over the real rows' (B, d)
    elements."""
    loss = bce_with_logits(logits, targets)
    w = weight.reshape((-1,) + (1,) * (loss.dim() - 1))
    return (loss * w).sum() / (w.sum() * loss.shape[-1]).clamp_min(1.0)


class LARA(JaxCarried, nn.Module):
    def __init__(self, user_emb, item_emb, content_dim: int,
                 seed: int = 2024, device="cuda"):
        super().__init__()
        d = int(user_emb.shape[1])
        gen = torch.Generator().manual_seed(int(seed))
        self.user_emb = table_param(user_emb)
        self.item_emb = table_param(item_emb)
        dims = {"G1": (content_dim + d, d), "D1": (content_dim + d, d)}
        for name in LAYERS:
            setattr(self, name, linear_params(*dims.get(name, (d, d)), gen))
        self.to(resolve_device(device))

    def generator(self, content_rows, table_rows):
        x = torch.tanh(self.G1(torch.cat([content_rows, table_rows], 1)))
        return torch.tanh(self.G3(torch.tanh(self.G2(x))))

    def discriminator(self, content_rows, emb):
        """Logits (B, d)."""
        x = torch.tanh(self.D1(torch.cat([content_rows, emb], 1)))
        return self.D3(torch.tanh(self.D2(x)))

    def jax_slots(self) -> list:
        return ([(("params", "user_emb"), self.user_emb, False),
                 (("params", "item_emb"), self.item_emb, False)]
                + [s for name in LAYERS
                   for s in linear_slots(getattr(self, name),
                                         ("params", name))])

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        d = np.shape(params["user_emb"])[1]
        return {"user_emb": params["user_emb"],
                "item_emb": params["item_emb"],
                "content_dim": np.shape(params["G1"]["w"])[0] - d}


class LARATrainer(ColdStartModelBase):
    """``init_params`` (the JAX trainer's ``params`` as numpy) replaces the
    seeded layers and the bus tables."""

    def __init__(self, config, init_params: Optional[Dict] = None):
        super().__init__(config)
        backbone = self.load_backbone()
        self.content = self.cold_side_content
        self.model = self.init_module(
            LARA, init_params, user_emb=backbone["user_emb"],
            item_emb=backbone["item_emb"], content_dim=self.content_dim)
        self.setup_optimizer()

    def batches(self):
        return pairwise_batches_with_neg_users(self.data, self.batch_size,
                                               self.host_rng)

    def generate(self, idx):
        m = self.model
        table = m.item_emb if self.args.cold_object == "item" else m.user_emb
        return m.generator(self.content[idx], table[idx])

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        m = self.model
        w = batch["weight"]
        if self.args.cold_object == "item":
            cold, counter = batch["pos_item"], batch["neg_item"]
            real_emb = m.user_emb[batch["user"]]
            neg_emb = m.user_emb[batch["neg_user"]]
        else:
            cold, counter = batch["user"], batch["neg_user"]
            real_emb = m.item_emb[batch["pos_item"]]
            neg_emb = m.item_emb[batch["neg_item"]]
        fake_emb = self.generate(cold)
        d_real = m.discriminator(self.content[cold], real_emb)
        d_fake = m.discriminator(self.content[cold], fake_emb)
        d_counter = m.discriminator(self.content[counter], neg_emb)
        ones, zeros = torch.ones_like(d_real), torch.zeros_like(d_real)
        d_loss = (bce_logits_mean(d_real, ones, w)
                  + bce_logits_mean(d_fake, zeros, w)
                  + bce_logits_mean(d_counter, zeros, w))
        return d_loss + bce_logits_mean(d_fake, ones, w)

    def forward_tables(self):
        m = self.model
        if self.args.cold_object == "item":
            idx = torch.arange(self.data.item_num, device=self.device)
            return m.user_emb, self.generate(idx)
        idx = torch.arange(self.data.user_num, device=self.device)
        return self.generate(idx), m.item_emb
