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

On ``--mesh DxM`` both tables are row-sharded over the model axis and read
through the trainer's lookups (the eval patch on the tables gathered
whole). Every rank draws the hybrid set's rows for the global batch from
the shared generator and keeps those of its own block of the flat rows
(``replaced_rows``), so the ranks replace one rank's rows; the two NCE
means and the two row-norm means of ``reg`` are parts summed over the
data group.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..data.sampler import pairwise_batches_multi_neg, warm_item_pool
from ..device import resolve_device
from ..ops.losses import _normalize, wmean_from_parts, wmean_parts
from .cold_base import ColdStartModelBase
from .common import JaxCarried, linear_params, linear_slots, xavier_uniform

HIDDEN = 256


def replaced_rows(rand_index: torch.Tensor, start: int,
                  n_rows: int) -> torch.Tensor:
    """(n_rows,) mask of the flat rows ``[start, start + n_rows)`` that
    ``rand_index`` (drawn over the global batch's flat rows) names, re-based
    to 0; a row named twice is marked once."""
    local = rand_index.long() - start
    own = (local >= 0) & (local < n_rows)
    mask = torch.zeros(n_rows, dtype=torch.bool, device=rand_index.device)
    mask[local[own]] = True
    return mask


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

    mesh_support = "sharded"

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

    def group_nce(self, anchor, others):
        """Each row's -log(pos / sum) over its (1 + num_neg) group
        (CLCRec.py:117-123)."""
        scores = torch.exp((anchor * others).sum(dim=-1) / self.temp)
        return -torch.log(scores[:, 0] / scores.sum(dim=1))

    def draw_rand_index(self, n: int) -> torch.Tensor:
        """The hybrid set's replaced rows: ``int(n * num_sample)`` of the
        ``n`` flat rows, with replacement."""
        return torch.randint(0, n, (int(n * self.num_sample),),
                             generator=self.generator, device=self.device)

    def loss(self, batch: Dict[str, torch.Tensor],
             rand_index: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``rand_index`` (else drawn): the replaced rows of the global
        batch's flat (B * (1 + num_neg)) rows."""
        m = self.model
        b = batch["user"].shape[0]
        n1 = 1 + self.num_neg
        # (B, 1 + n) item groups: column 0 the positive, then the negatives
        items = torch.cat([batch["pos_item"][:, None], batch["neg_items"]],
                          dim=1)
        w = batch["weight"]
        feats = m.encode(self.content[items.reshape(-1)]).reshape(b, n1, -1)
        flat_emb = self.lookup("item_emb", items.reshape(-1))
        user_emb = self.lookup("user_emb", batch["user"])[:, None, :]
        head_embed = _normalize(
            self.lookup("item_emb", batch["pos_item"])[:, None, :])
        flat_feat = feats.reshape(b * n1, -1)
        n_flat = b * self.n_data * n1
        if rand_index is None:
            rand_index = self.draw_rand_index(n_flat)
        replaced = replaced_rows(rand_index, self.data_offset(n_flat), b * n1)
        hybrid = torch.where(replaced[:, None], flat_feat, flat_emb)
        w_rep = w.repeat_interleave(n1)
        # (sum, count) parts of loss1, loss2 and reg's two row-norm means
        p = self.reduce_parts(torch.cat([
            wmean_parts(self.group_nce(head_embed, _normalize(feats)), w),
            wmean_parts(self.group_nce(user_emb,
                                       hybrid.reshape(b, n1, -1)), w),
            wmean_parts(user_emb[:, 0].norm(dim=1), w),
            wmean_parts(flat_emb.norm(dim=1), w_rep)]))
        reg = (wmean_from_parts(p[4:6]) + wmean_from_parts(p[6:8])) / 2.0
        return (self.lr_lambda * wmean_from_parts(p[0:2])
                + (1 - self.lr_lambda) * wmean_from_parts(p[2:4])
                + self.reg * reg)

    def forward_tables(self):
        m = self.model
        return self.patch_cold_rows(self.full_table("user_emb"),
                                    self.full_table("item_emb"),
                                    m.encode(self.content[self.cold_idx]))
