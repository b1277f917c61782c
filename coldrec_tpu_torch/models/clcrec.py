"""CLCRec cold-start model (the port's copy of
``coldrec_tpu/models/clcrec.py``; reference: model/CLCRec.py). Item cold
start only.

Contrastive user-item and item-feature learning: a 2-layer leaky-ReLU
content encoder (CLCRec.py:106-115); loss1 = NCE(pos-item embedding, item
features over the (1 + num_neg) group), loss2 = NCE(user embedding, the
hybrid item set in which a ``num_sample`` fraction of the item embeddings
is replaced by features) (125-148); the negatives are warm items drawn
without the user's positives (utils.py:191-233); reg = the mean row norm of
the user and item embeddings. Eval: the learned tables with the cold item
rows = encoder(content) (155-157).

The hybrid set's rows are drawn with replacement, so an index may repeat.
The JAX package's ``.at[rand_index].set(feat[rand_index])`` writes the same
feature row at each copy, and its gradient reaches the feature row once (a
scatter's winning copy takes the cotangent, the others 0); torch's
``index_put`` would hand every copy the full cotangent, counting a repeated
row twice. So the hybrid set here is a ``where`` over the mask of replaced
rows: the same values, and each replaced row's feature takes its cotangent
once, as in JAX. ``loss(batch, rand_index=)`` takes the draw (the tests
hand it one with repeated rows).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..data.sampler import pairwise_batches_multi_neg, warm_item_pool
from ..device import resolve_device
from ..ops.losses import _normalize
from .cold_base import ColdStartModelBase
from .common import JaxCarried, linear_params, linear_slots, xavier_uniform

HIDDEN = 256


class CLCRec(JaxCarried, nn.Module):
    def __init__(self, user_num: int, item_num: int, content_dim: int,
                 emb_size: int, seed: int = 2024, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        self.user_emb = nn.Parameter(xavier_uniform((user_num, emb_size),
                                                    gen))
        self.item_emb = nn.Parameter(xavier_uniform((item_num, emb_size),
                                                    gen))
        self.enc1 = linear_params(content_dim, HIDDEN, gen)
        self.enc2 = linear_params(HIDDEN, emb_size, gen)
        self.to(resolve_device(device))

    def encode(self, content_rows):
        return self.enc2(F.leaky_relu(self.enc1(content_rows)))

    def jax_slots(self) -> list:
        return ([(("params", "user_emb"), self.user_emb, False),
                 (("params", "item_emb"), self.item_emb, False)]
                + linear_slots(self.enc1, ("params", "enc1"))
                + linear_slots(self.enc2, ("params", "enc2")))

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        u, d = params["user_emb"].shape
        return {"user_num": u, "item_num": params["item_emb"].shape[0],
                "content_dim": params["enc1"]["w"].shape[0], "emb_size": d}


class CLCRecTrainer(ColdStartModelBase):
    """``init_params`` (the JAX trainer's ``params`` as numpy) replaces the
    seeded weights."""

    def __init__(self, config, init_params: Optional[Dict] = None):
        super().__init__(config)
        self.require_item_cold()
        self.num_neg = int(self.args.num_neg)
        self.temp = float(self.args.temp_value)
        self.lr_lambda = float(self.args.lr_lambda)
        self.num_sample = float(self.args.num_sample)
        self.content = self.cold_side_content
        self.pool = warm_item_pool(self.data)
        self.model = self.init_module(
            CLCRec, init_params, user_num=self.data.user_num,
            item_num=self.data.item_num, content_dim=self.content_dim,
            emb_size=self.emb_size)
        self.setup_optimizer()

    def batches(self):
        return pairwise_batches_multi_neg(self.data, self.batch_size,
                                          self.host_rng, self.num_neg,
                                          self.pool)

    def group_nce(self, anchor, others, weight):
        """-log(pos / sum) over (B, 1 + num_neg) groups (CLCRec.py:117-123)."""
        scores = torch.exp((anchor * others).sum(dim=-1) / self.temp)
        loss = -torch.log(scores[:, 0] / scores.sum(dim=1))
        return (loss * weight).sum() / weight.sum().clamp_min(1.0)

    def draw_rand_index(self, n: int) -> torch.Tensor:
        """The hybrid set's replaced rows: ``int(n * num_sample)`` of the
        ``n`` flat rows, with replacement."""
        return torch.randint(0, n, (int(n * self.num_sample),),
                             generator=self.generator, device=self.device)

    def loss(self, batch: Dict[str, torch.Tensor],
             rand_index: Optional[torch.Tensor] = None) -> torch.Tensor:
        m = self.model
        b = batch["user"].shape[0]
        n1 = 1 + self.num_neg
        # (B, 1 + n) item groups: column 0 the positive, then the negatives
        items = torch.cat([batch["pos_item"][:, None], batch["neg_items"]],
                          dim=1)
        w = batch["weight"]
        feats = m.encode(self.content[items.reshape(-1)]).reshape(b, n1, -1)
        item_embs = m.item_emb[items]
        user_emb = m.user_emb[batch["user"]][:, None, :]
        head_embed = _normalize(m.item_emb[batch["pos_item"]][:, None, :])
        flat_emb = item_embs.reshape(b * n1, -1)
        flat_feat = feats.reshape(b * n1, -1)
        if rand_index is None:
            rand_index = self.draw_rand_index(b * n1)
        replaced = torch.zeros(b * n1, dtype=torch.bool, device=w.device)
        replaced[rand_index.long()] = True
        hybrid = torch.where(replaced[:, None], flat_feat, flat_emb)
        loss1 = self.group_nce(head_embed, _normalize(feats), w)
        loss2 = self.group_nce(user_emb, hybrid.reshape(b, n1, -1), w)
        w_rep = w.repeat_interleave(n1)
        reg = ((user_emb[:, 0].norm(dim=1) * w).sum()
               / w.sum().clamp_min(1.0)
               + (flat_emb.norm(dim=1) * w_rep).sum()
               / w_rep.sum().clamp_min(1.0)) / 2.0
        return (self.lr_lambda * loss1 + (1 - self.lr_lambda) * loss2
                + self.reg * reg)

    def forward_tables(self):
        m = self.model
        return self.patch_cold_rows(m.user_emb, m.item_emb,
                                    m.encode(self.content[self.cold_idx]))
