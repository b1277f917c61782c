"""AGNN cold-start model (the port's copy of ``coldrec_tpu/models/agnn.py``;
reference: model/AGNN.py).

A content encoder MLP, then gated aggregation over precomputed cosine-kNN
warm neighbours (add / erase gates and a LeakyReLU fusion, AGNN.py:219-243);
two 2-layer VAEs rebuild the backbone embedding from the semantic x
(AGNN.py:251-263); loss = BPR(gcn) + w * BPR(gen) + w * align-MSE +
lambda * (recon + KL) + L2 (AGNN.py:285-317). The backbone tables are
frozen (no gradient) unless ``--agnn_finetune``; xavier tables with
``--agnn_no_backbone``. Eval computes the gated embedding of every user
and item and patches the cold rows with the VAE's decoded mean.

The neighbours of both sides come from ``ops/knn.py``'s ``knn_cosine`` (on
the card the retrieval kernel, at the content's width). The loss's draws
(four dropout masks and the VAE's normal) come from the trainer's
generator, or from ``loss(batch, draws=)`` (the tests hand it the JAX
package's).

On ``--mesh DxM`` both tables are row-sharded over the model axis (the JAX
rule, also while they take no gradient). ``gcn_embed`` reads each batch
side's own rows and its neighbours' (B * K) through one lookup of the
stacked ids, the eval on the tables gathered whole. Every rank draws the
masks and the normal for the global batch and keeps its block, and the
loss's parts (``bpr_parts``, ``wmean_parts``, ``l2_parts``) are summed
over the data group.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.knn import knn_cosine
from ..ops.losses import (
    bpr_parts, l2_from_parts, l2_parts, wmean_from_parts, wmean_parts,
)
from .cold_base import ColdStartModelBase
from .common import (
    JaxCarried, linear_params, linear_slots, table_param, xavier_uniform,
)

VAE_LAYERS = ("enc1", "mu", "logvar", "dec1", "dec2")
GATES = ("dense_self", "dense_hop", "dense_addgate", "dense_erasegate")


def cosine_knn_warm(features: np.ndarray, warm_ids: np.ndarray, k: int,
                    device="cuda") -> np.ndarray:
    """(n, k) warm global ids nearest each row by cosine, a warm row's own
    id left out (AGNN.py:48-82): the best min(k, n_warm) others, and where
    fewer remain, the last of them (or ``warm_ids[0]``) repeated."""
    n = features.shape[0]
    nw = warm_ids.shape[0]
    _, idx = knn_cosine(features, features[warm_ids], min(k + 1, nw),
                        device=device)
    chosen = warm_ids[idx]  # (n, kk) global ids, best first
    keep = chosen != np.arange(n)[:, None]
    # each row's kept ids first, in their order
    order = np.argsort(~keep, axis=1, kind="stable")
    kept = np.take_along_axis(chosen, order, axis=1)
    size = np.minimum(keep.sum(axis=1), min(k, nw))
    last = np.where(size > 0, kept[np.arange(n), np.maximum(size - 1, 0)],
                    warm_ids[0])
    cols = np.arange(k)[None, :]
    out = np.where(cols < size[:, None],
                   kept[:, np.minimum(np.arange(k), kept.shape[1] - 1)],
                   last[:, None])
    return out.astype(np.int64)


def pad_rows(content: Optional[np.ndarray], rows: int) -> Optional[np.ndarray]:
    """``content`` cut or zero-padded to ``rows`` rows (float32)."""
    if content is None:
        return None
    out = np.zeros((rows, content.shape[1]), np.float32)
    n = min(rows, content.shape[0])
    out[:n] = content[:n]
    return out


class VAE(nn.Module):
    def __init__(self, d: int, generator: torch.Generator):
        super().__init__()
        for name in VAE_LAYERS:
            setattr(self, name, linear_params(d, d, generator))

    def encode(self, x):
        h = torch.relu(self.enc1(x))
        return self.mu(h), self.logvar(h)

    def decode(self, z):
        return self.dec2(torch.relu(self.dec1(z)))

    def slots(self, path: tuple) -> list:
        return [s for name in VAE_LAYERS
                for s in linear_slots(getattr(self, name), path + (name,))]


class AGNN(JaxCarried, nn.Module):
    """Tables, the two content encoders, the gates and the two VAEs."""

    def __init__(self, user_emb, item_emb, f_user: int, f_item: int,
                 finetune: bool = False, seed: int = 2024, device="cuda"):
        super().__init__()
        d = int(user_emb.shape[1])
        gen = torch.Generator().manual_seed(int(seed))
        self.user_emb = table_param(user_emb)
        self.item_emb = table_param(item_emb)
        self.user_emb.requires_grad_(finetune)
        self.item_emb.requires_grad_(finetune)
        self.enc_item = nn.ModuleList([linear_params(f_item, 2 * d, gen),
                                       linear_params(2 * d, d, gen)])
        self.enc_user = nn.ModuleList([linear_params(f_user, 2 * d, gen),
                                       linear_params(2 * d, d, gen)])
        for name in GATES:
            setattr(self, name, linear_params(2 * d, d, gen))
        self.user_vae = VAE(d, gen)
        self.item_vae = VAE(d, gen)
        self.to(resolve_device(device))

    def jax_slots(self) -> list:
        out = [(("params", "user_emb"), self.user_emb, False),
               (("params", "item_emb"), self.item_emb, False)]
        for name in ("enc_item", "enc_user"):
            for i, layer in enumerate(getattr(self, name)):
                out += linear_slots(layer, ("params", name, i))
        for name in GATES:
            out += linear_slots(getattr(self, name), ("params", name))
        return (out + self.user_vae.slots(("params", "user_vae"))
                + self.item_vae.slots(("params", "item_vae")))

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        return {"user_emb": params["user_emb"],
                "item_emb": params["item_emb"],
                "f_user": np.shape(params["enc_user"][0]["w"])[0],
                "f_item": np.shape(params["enc_item"][0]["w"])[0]}


class AGNNTrainer(ColdStartModelBase):
    """``init_params`` (the JAX trainer's ``params`` as numpy) replaces the
    seeded weights and the bus tables."""

    mesh_support = "sharded"

    def __init__(self, config, init_params: Optional[Dict] = None):
        super().__init__(config)
        d = self.emb_size
        self.drop = float(self.args.agnn_dropout)
        n_u, n_i = self.data.user_num, self.data.item_num
        if bool(self.args.agnn_no_backbone):
            gen = torch.Generator().manual_seed(self.seed)
            user_emb = xavier_uniform((n_u, d), gen)
            item_emb = xavier_uniform((n_i, d), gen)
            finetune = True
        else:
            backbone = self.load_backbone()
            user_emb, item_emb = backbone["user_emb"], backbone["item_emb"]
            finetune = bool(self.args.agnn_finetune)
        item_np = pad_rows(self.data.item_content, n_i)
        user_np = pad_rows(self.data.user_content, n_u)
        if item_np is None and self.args.cold_object == "item":
            raise ValueError("AGNN item cold-start requires item content")
        if user_np is None and self.args.cold_object == "user":
            raise ValueError("AGNN user cold-start requires user content")
        # a side without content encodes its own table rows
        self.item_content = (None if item_np is None else
                             torch.as_tensor(item_np, device=self.device))
        self.user_content = (None if user_np is None else
                             torch.as_tensor(user_np, device=self.device))
        k = int(self.args.agnn_knn_k)
        warm_i = np.asarray(self.data.mapped_warm_item_idx, np.int64)
        warm_u = np.asarray(self.data.mapped_warm_user_idx, np.int64)
        item_feat = (item_np if item_np is not None
                     else item_emb.detach().cpu().numpy())
        user_feat = (user_np if user_np is not None
                     else user_emb.detach().cpu().numpy())
        self.knn_item = self._ids(cosine_knn_warm(item_feat, warm_i, k,
                                                  self.device))
        self.knn_user = self._ids(cosine_knn_warm(user_feat, warm_u, k,
                                                  self.device))
        self.model = self.init_module(
            AGNN, init_params, user_emb=user_emb, item_emb=item_emb,
            f_user=d if user_np is None else user_np.shape[1],
            f_item=d if item_np is None else item_np.shape[1],
            finetune=finetune)
        self.setup_optimizer()

    # ------------------------------------------------------------- draws
    def draw(self, n: int) -> dict:
        """The loss's draws for a batch of ``n`` rows: four dropout keep
        masks (n, 2d) and the VAE's N(0, 1) (n, d)."""
        d = self.emb_size
        keep = 1.0 - self.drop
        masks = [torch.rand((n, 2 * d), generator=self.generator,
                            device=self.device) < keep for _ in range(4)]
        normal = torch.randn((n, d), generator=self.generator,
                             device=self.device)
        return {"masks": masks, "normal": normal}

    # ---------------------------------------------------------- encoders
    def semantic_x(self, idx, is_user: bool, own, mask=None):
        """The content encoding of ``idx``; a side without content encodes
        its table rows ``own``."""
        m = self.model
        content = self.user_content if is_user else self.item_content
        feat = content[idx] if content is not None else own
        enc = m.enc_user if is_user else m.enc_item
        h = torch.relu(enc[0](feat))
        if mask is not None and self.drop > 0.0:
            keep = 1.0 - self.drop
            h = torch.where(mask, h / keep, torch.zeros_like(h))
        return enc[1](h)

    def gcn_embed(self, idx, is_user: bool, mask=None, table=None):
        """The gated embedding of ``idx``. Its own table rows and its
        neighbours' come from ``table`` (whole) or, without one, from one
        lookup of the stacked ids."""
        m = self.model
        knn = (self.knn_user if is_user else self.knn_item)[idx]  # (B, K)
        n = idx.shape[0]
        ids = torch.cat([idx, knn.reshape(-1)])
        if table is None:
            rows = self.lookup("user_emb" if is_user else "item_emb", ids)
        else:
            rows = table[ids]
        own, neigh_e = rows[:n], rows[n:].view(n, knn.shape[1], -1)
        x = self.semantic_x(idx, is_user, own, mask)
        self_embed = m.dense_self(torch.cat([x, own], 1))
        self_rep = self_embed[:, None, :].expand_as(neigh_e)
        hop_raw = m.dense_hop(torch.cat([self_rep, neigh_e], -1))
        add_gate = torch.sigmoid(
            m.dense_addgate(torch.cat([self_rep, hop_raw], -1)))
        hop_g = (hop_raw * add_gate).mean(dim=1)
        erase_gate = torch.sigmoid(m.dense_erasegate(
            torch.cat([self_embed, hop_raw.mean(dim=1)], 1)))
        return F.leaky_relu((1.0 - erase_gate) * self_embed + hop_g,
                            negative_slope=0.2)

    def loss(self, batch: Dict[str, torch.Tensor],
             draws: Optional[dict] = None) -> torch.Tensor:
        """``draws`` (else drawn): the global batch's masks and normal;
        this rank keeps its block of each."""
        if draws is None:
            draws = self.draw(batch["user"].shape[0] * self.n_data)
        m = self.model
        masks = [self.data_block(x) for x in draws["masks"]]
        normal = self.data_block(draws["normal"])
        w = batch["weight"]
        u_g = self.gcn_embed(batch["user"], True, masks[0])
        pos_g = self.gcn_embed(batch["pos_item"], False, masks[1])
        neg_g = self.gcn_embed(batch["neg_item"], False, masks[2])
        # each term's (sum, count) parts in the one-device loss's order
        rank = bpr_parts(u_g, pos_g, neg_g, w)
        if self.args.cold_object == "item":
            idx, is_user, vae = batch["pos_item"], False, m.item_vae
        else:
            idx, is_user, vae = batch["user"], True, m.user_vae
        target = self.lookup("user_emb" if is_user else "item_emb", idx)
        x = self.semantic_x(idx, is_user, target, masks[3])
        mu, logvar = vae.encode(x)
        gen = vae.decode(mu + torch.exp(0.5 * logvar) * normal)
        recon = wmean_parts((gen - target) ** 2, w)
        kl_el = (1 + logvar - mu ** 2 - torch.exp(logvar)).sum(dim=1)
        kl = wmean_parts(kl_el, w)
        if self.args.cold_object == "item":
            gen_rank = bpr_parts(u_g, gen, neg_g, w)
        else:
            gen_rank = bpr_parts(gen, pos_g, neg_g, w)
        # the same value as recon, a term of its own as in the JAX loss
        align = wmean_parts((gen - target) ** 2, w)
        p = self.reduce_parts(torch.cat([
            rank, recon, kl, gen_rank, align,
            l2_parts(u_g, pos_g, neg_g, gen, weight=w)]))
        kl_loss = -0.5 * wmean_from_parts(p[4:6])
        reg_loss = l2_from_parts(p[10:], p[1].clamp_min(1.0), self.reg)
        a = self.args
        return (wmean_from_parts(p[0:2])
                + float(a.agnn_rank_weight) * wmean_from_parts(p[6:8])
                + float(a.agnn_align_weight) * wmean_from_parts(p[8:10])
                + float(a.agnn_vae_lambda) * (wmean_from_parts(p[2:4])
                                              + kl_loss)
                + reg_loss)

    def forward_tables(self):
        m = self.model
        dev = self.device
        ut, it = self.full_table("user_emb"), self.full_table("item_emb")
        u_all = self.gcn_embed(torch.arange(self.data.user_num, device=dev),
                               True, table=ut)
        i_all = self.gcn_embed(torch.arange(self.data.item_num, device=dev),
                               False, table=it)
        # the cold rows: the VAE's decoded mean
        is_user = self.args.cold_object == "user"
        vae = m.user_vae if is_user else m.item_vae
        table = ut if is_user else it
        mu, _ = vae.encode(self.semantic_x(self.cold_idx, is_user,
                                           table[self.cold_idx]))
        return self.patch_cold_rows(u_all, i_all, vae.decode(mu))
