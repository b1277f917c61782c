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

On ``--mesh DxM`` both tables are row-sharded over the model axis and read
through the trainer's lookups (the eval on the tables gathered whole);
the four BCE means are parts (``wmean_parts``) summed over the data group.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..data.sampler import pairwise_batches_with_neg_users
from ..device import resolve_device
from ..ops.losses import bce_with_logits, wmean_from_parts, wmean_parts
from .cold_base import ColdStartModelBase
from .common import JaxCarried, linear_params, linear_slots, table_param

LAYERS = ("G1", "G2", "G3", "D1", "D2", "D3")


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

    mesh_support = "sharded"

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

    def cold_table(self) -> str:
        return "item_emb" if self.args.cold_object == "item" else "user_emb"

    def generate(self, idx, rows):
        """The generator's embedding of the cold-side entities ``idx``,
        whose table rows are ``rows``."""
        return self.model.generator(self.content[idx], rows)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        m = self.model
        w = batch["weight"]
        if self.args.cold_object == "item":
            cold, counter = batch["pos_item"], batch["neg_item"]
            real_emb = self.lookup("user_emb", batch["user"])
            neg_emb = self.lookup("user_emb", batch["neg_user"])
        else:
            cold, counter = batch["user"], batch["neg_user"]
            real_emb = self.lookup("item_emb", batch["pos_item"])
            neg_emb = self.lookup("item_emb", batch["neg_item"])
        fake_emb = self.generate(cold, self.lookup(self.cold_table(), cold))
        d_real = m.discriminator(self.content[cold], real_emb)
        d_fake = m.discriminator(self.content[cold], fake_emb)
        d_counter = m.discriminator(self.content[counter], neg_emb)
        ones, zeros = torch.ones_like(d_real), torch.zeros_like(d_real)
        # the (sum, count) parts of D's real, fake and counter terms, then
        # G's
        p = self.reduce_parts(torch.cat([
            wmean_parts(bce_with_logits(d, t), w)
            for d, t in ((d_real, ones), (d_fake, zeros), (d_counter, zeros),
                         (d_fake, ones))]))
        d_loss = (wmean_from_parts(p[0:2]) + wmean_from_parts(p[2:4])
                  + wmean_from_parts(p[4:6]))
        return d_loss + wmean_from_parts(p[6:8])

    def forward_tables(self):
        n = (self.data.item_num if self.args.cold_object == "item"
             else self.data.user_num)
        idx = torch.arange(n, device=self.device)
        gen = self.generate(idx, self.full_table(self.cold_table()))
        if self.args.cold_object == "item":
            return self.full_table("user_emb"), gen
        return gen, self.full_table("item_emb")
