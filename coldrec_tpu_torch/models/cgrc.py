"""CGRC graph-reconstruction cold-start model (the port's copy of
``coldrec_tpu/models/cgrc.py``; reference: model/CGRC.py). Item cold start
only.

Training (CGRC.py:291-344): item x = Linear(content); an edge-predictor
MLP, relu(h_u W_u + x_i W_i + b1) . w2 + b2, trained on simulated cold
items: the graph G' without their edges, LightGCN over it with the cold
rows pinned to content after each layer, and a per-edge softmax
reconstruction loss L_E over a fixed count of sampled training edges;
L_R = a temperature contrastive ranking over a shared item set B (the
batch's positives and uniform extra items). Inference (CGRC.py:369-401)
adds the top-K predicted users of every true cold item to the graph (Ĝ,
rebuilt with scipy on the host once per evaluation), renormalizes and
re-propagates.

As in the JAX package, G' is the full static edge list with 0/1 weights
(``ops/spmm.reweighted_sym_graph``: the degrees recomputed by a segment sum
each step), and the edge MLP's first layer is split into a user part and
an item part. The softmax terms of L_E are an exact running logsumexp over
blocks of items (:class:`EdgeLogSumExp`, its backward recomputing each
block), with four times the JAX package's element budget for the
(edges, items, hidden) block (``DENSE_ELEMS_CAP``, 2^29 against its 2^27).
Only the sampled edges of simulated-cold items carry weight
in L_E, and only simulated-cold items enter any row's softmax, so the port
computes the terms for those edges over those items alone: the same loss
and gradients (the dropped terms are exact zeros), on about 1/14 of the
masked sweep's work at book-crossing shape (30% of the edges x 30% of the
items). Membership (did the edge's user rate the item) is a binary search
over the sorted (user, item) keys of the training pairs.

The top-k users of the cold items score the edge MLP, not an inner product,
so they are plain torch: dense while the (users, cold items, hidden) block
fits the budget, else blocks of 512 cold items each swept over user chunks
with a running merge of (previous top-k | chunk) through ``stable_topk``,
so that ties keep the lowest user id, as ``lax.top_k`` does. The loss's
draws (simulated cold items, sampled edges, extra items) come from the
trainer's generator, or from ``loss(batch, draws=)`` (the tests hand it
the JAX package's). Each evaluation's seconds (top-k users, the Ĝ rebuild,
the re-propagation) go to the event log (``cgrc_eval``).
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from ..data.builder import SparseGraphHost
from ..device import resolve_device
from ..ops.losses import l2_reg_loss
from ..ops.spmm import SparseGraph, reweighted_sym_graph, spmm
from ..runtime.eval import stable_topk
from ..utils.logging import event_log
from .cold_base import ColdStartModelBase
from .common import (
    JaxCarried, linear_params, linear_slots, mlp_slots, xavier_uniform,
)
from .lightgcn import lightgcn_propagate

# fp32 elements of one (edges or users, items, hidden) block of the edge
# MLP (2 GiB): four times the JAX package's budget for its TPU, so that a
# step of L_E at book-crossing shape sweeps 10 blocks, not 38, and a top-k
# 8,192 users a chunk (each block's launches cost host time)
DENSE_ELEMS_CAP = 1 << 29
TOPK_ITEM_BLOCK = 512
NEG = torch.finfo(torch.float32).min


def block_logits(hb, x, w2, b2):
    """(R, H) x (B, H) -> (R, B) edge logits relu(hb[:, None] + x[None]) .
    w2 + b2 from the split first layer, ``hb`` holding its bias."""
    return torch.relu_(hb[:, None, :] + x[None, :, :]) @ w2 + b2


class EdgeLogSumExp(torch.autograd.Function):
    """logsumexp over the valid items of each edge's logits, as a running
    (max, sum) over blocks of items, the (E, block, H) hidden layer never
    kept: the backward recomputes it block by block and reduces it with
    products (d/dw2 = g . r, d/dhb and d/dxi = w2 * g . [r > 0]).

    forward(hb (E, H), xi (V, H), w2 (H,), b2 (), valid_fn, blk) -> (lse
    (E,), has_valid (E,)); ``hb`` holds the first layer's bias,
    ``valid_fn(start, stop)`` gives the (E, stop - start) mask of the items
    that may enter each row."""

    @staticmethod
    def forward(ctx, hb, xi, w2, b2, valid_fn, blk):
        e = hb.shape[0]
        m = hb.new_full((e,), NEG)
        s = hb.new_zeros(e)
        for start in range(0, xi.shape[0], blk):
            stop = min(start + blk, xi.shape[0])
            valid = valid_fn(start, stop)
            lg = block_logits(hb, xi[start:stop], w2, b2)
            lg = torch.where(valid, lg, torch.full_like(lg, NEG))
            nm = torch.maximum(m, lg.amax(dim=1))
            scale = torch.where(nm == NEG, torch.zeros_like(m),
                                torch.exp(m - nm))
            add = torch.where(valid, torch.exp(lg - nm[:, None]),
                              torch.zeros_like(lg)).sum(dim=1)
            m, s = nm, s * scale + add
        lse = m + torch.log(s.clamp_min(1e-38))
        ctx.save_for_backward(hb, xi, w2, b2, lse)
        ctx.valid_fn, ctx.blk = valid_fn, blk
        has_valid = s > 0
        ctx.mark_non_differentiable(has_valid)
        return lse, has_valid

    @staticmethod
    def backward(ctx, g_lse, _):
        hb, xi, w2, b2, lse = ctx.saved_tensors
        g_hb, g_xi = torch.zeros_like(hb), torch.zeros_like(xi)
        g_w2, g_b2 = torch.zeros_like(w2), torch.zeros_like(b2)
        for start in range(0, xi.shape[0], ctx.blk):
            stop = min(start + ctx.blk, xi.shape[0])
            valid = ctx.valid_fn(start, stop)
            r = torch.relu_(hb[:, None, :] + xi[start:stop][None, :, :])
            lg = r @ w2 + b2
            # d lse / d logit: the softmax weight of each valid item
            g = torch.where(valid, torch.exp(lg - lse[:, None]),
                            torch.zeros_like(lg)) * g_lse[:, None]
            g_w2 += g.reshape(1, -1).matmul(r.reshape(-1, r.shape[2]))[0]
            g_b2 += g.sum()
            mask = r.gt_(0)  # r > 0 as 0 / 1, in place
            g_hb += torch.einsum("eb,ebh->eh", g, mask) * w2
            g_xi[start:stop] = torch.einsum("eb,ebh->bh", g, mask) * w2
        return g_hb, g_xi, g_w2, g_b2, None, None


class CGRC(JaxCarried, nn.Module):
    def __init__(self, user_num: int, content_dim: int, emb_size: int,
                 hidden: int, seed: int = 2024, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        self.user_emb = nn.Parameter(xavier_uniform((user_num, emb_size),
                                                    gen))
        self.item_lin = linear_params(content_dim, emb_size, gen)
        self.edge_mlp = nn.ModuleList([linear_params(2 * emb_size, hidden,
                                                     gen),
                                       linear_params(hidden, 1, gen)])
        self.to(resolve_device(device))

    def edge_parts(self, h_users, item_x):
        """The edge MLP's first layer split: [h_u | x_i] @ W = h_u @ W_u +
        x_i @ W_i, a user part (R, H) and an item part (I, H)."""
        w = self.edge_mlp[0].weight  # (H, 2d)
        d = h_users.shape[1]
        return h_users @ w[:, :d].T, item_x @ w[:, d:].T

    def mlp_tail(self):
        """(b1 (H,), w2 (H,), b2 ()) of the edge MLP."""
        second = self.edge_mlp[1]
        return self.edge_mlp[0].bias, second.weight[0], second.bias[0]

    def topk_users(self, h_u_bar, x_cold, k):
        """(C, k) int64 top-scoring users of each cold item by the edge MLP
        (ties: lowest user id first): dense under ``DENSE_ELEMS_CAP``, else
        in blocks of ``TOPK_ITEM_BLOCK`` cold items, each over user chunks
        with a running top-k merge (exact)."""
        n_u, c = h_u_bar.shape[0], x_cold.shape[0]
        hidden = self.edge_mlp[0].out_features
        hu, xi = self.edge_parts(h_u_bar, x_cold)
        b1, w2, b2 = self.mlp_tail()
        xi = xi + b1
        if n_u * c * hidden <= DENSE_ELEMS_CAP:
            return stable_topk(block_logits(xi, hu, w2, b2), k)[1]
        ublk = max(256, min(8192, DENSE_ELEMS_CAP
                            // (TOPK_ITEM_BLOCK * hidden)))
        out = []
        for s in range(0, c, TOPK_ITEM_BLOCK):
            xb = xi[s:s + TOPK_ITEM_BLOCK]
            bv = xb.new_full((xb.shape[0], k), NEG)
            bi = torch.zeros((xb.shape[0], k), dtype=torch.int64,
                             device=xb.device)
            for u0 in range(0, n_u, ublk):
                lg = block_logits(xb, hu[u0:u0 + ublk], w2, b2)
                ids = torch.arange(u0, u0 + lg.shape[1], device=xb.device)
                bv, pos = stable_topk(torch.cat([bv, lg], dim=1), k)
                bi = torch.cat([bi, ids.expand(lg.shape[0], -1)],
                               dim=1).gather(1, pos)
            out.append(bi)
        return torch.cat(out)

    def jax_slots(self) -> list:
        return ([(("params", "user_emb"), self.user_emb, False)]
                + linear_slots(self.item_lin, ("params", "item_lin"))
                + mlp_slots(self.edge_mlp, ("params", "edge_mlp")))

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        u, d = params["user_emb"].shape
        return {"user_num": u, "content_dim": params["item_lin"]["w"].shape[0],
                "emb_size": d,
                "hidden": params["edge_mlp"][0]["w"].shape[1]}


class CGRCTrainer(ColdStartModelBase):
    """``init_params`` (the JAX trainer's ``params`` as numpy) replaces the
    seeded weights."""

    def __init__(self, config, init_params: Optional[Dict] = None):
        super().__init__(config)
        self.require_item_cold()
        a = self.args
        self.Lg = int(a.cgrc_layers_gprime)
        self.Lf = int(a.cgrc_layers_full)
        self.Lh = int(a.cgrc_layers_ghat)
        self.rho = float(a.cgrc_mask_rho)
        self.topk = int(a.cgrc_recon_topk)
        self.lambda_e = float(a.cgrc_lambda_e)
        self.tau = float(a.cgrc_tau)
        self.le_max = int(a.cgrc_le_max_edges)
        self.n_extra = int(a.cgrc_ranking_neg_per_user) * 8
        self.hidden = int(a.cgrc_mlp_hidden)
        n_u, n_i = self.data.user_num, self.data.item_num
        self.content = self.cold_side_content[:n_i]
        tp = self.data.train_pairs
        # the static bipartite edge list (both directions) and each edge's
        # item, for G'
        self.edge_rows = self._ids(np.concatenate([tp[:, 0], tp[:, 1] + n_u]))
        self.edge_cols = self._ids(np.concatenate([tp[:, 1] + n_u, tp[:, 0]]))
        self.edge_item = self._ids(np.concatenate([tp[:, 1], tp[:, 1]]))
        self.train_pairs = self._ids(tp)
        # sorted keys u * (n_i + 1) + i of the training pairs: membership
        self.pair_keys = torch.sort(self._ids(
            tp[:, 0].astype(np.int64) * (n_i + 1) + tp[:, 1]))[0]
        eligible = np.zeros(n_i, bool)
        eligible[np.unique(tp[:, 1])] = True
        self.eligible = torch.as_tensor(eligible, device=self.device)
        self.full_graph = self.build_graph()
        self.model = self.init_module(
            CGRC, init_params, user_num=n_u, content_dim=self.content_dim,
            emb_size=self.emb_size, hidden=self.hidden)
        self.setup_optimizer()

    # ----------------------------------------------------------- helpers
    def rated(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        """Whether each (user, item) (broadcast) is a training pair."""
        keys = users.long() * (self.data.item_num + 1) + items.long()
        pos = torch.searchsorted(self.pair_keys, keys).clamp_max(
            self.pair_keys.shape[0] - 1)
        return self.pair_keys[pos] == keys

    def item_x(self):
        return self.model.item_lin(self.content)

    def propagate_frozen(self, graph, user_emb, item_x, n_layers,
                         cold_mask=None):
        """The user rows' mean over propagation layers 1..L, the cold item
        rows pinned to x after each layer (CGRC.py:76-93)."""
        if n_layers <= 0:
            return user_emb
        n_u = user_emb.shape[0]
        ego = torch.cat([user_emb, item_x], dim=0)
        acc_u = torch.zeros_like(user_emb)
        h = ego
        pin = None
        if cold_mask is not None:
            pin = torch.cat([torch.zeros(n_u, dtype=torch.bool,
                                         device=self.device),
                             cold_mask])[:, None]
        for _ in range(n_layers):
            h = spmm(graph, h)
            if pin is not None:
                h = torch.where(pin, ego, h)
            acc_u = acc_u + h[:n_u]
        return acc_u / n_layers

    def draw(self) -> Dict[str, torch.Tensor]:
        """The loss's draws: the simulated cold items (among the items with
        a training pair), ``le_max`` training edges and the extra items of
        the shared set B."""
        g, dev = self.generator, self.device
        n_i = self.data.item_num
        cold = (torch.rand(n_i, generator=g, device=dev) < self.rho) \
            & self.eligible
        return {"cold_mask": cold,
                "edges": torch.randint(0, self.train_pairs.shape[0],
                                       (self.le_max,), generator=g,
                                       device=dev),
                "extra": torch.randint(0, n_i, (self.n_extra,), generator=g,
                                       device=dev)}

    # ------------------------------------------------------------ losses
    def reconstruction_loss(self, user_emb, x_all, cold_mask, edges):
        """L_E (Eq. 6, CGRC.py:206-256): over the sampled edges of
        simulated-cold items, the mean of -(pos logit - logsumexp of the
        logits of the simulated-cold items the edge's user did not rate);
        edges with no such item drop."""
        m = self.model
        keep = (~cold_mask[self.edge_item]).float()
        graph = reweighted_sym_graph(self.edge_rows, self.edge_cols, keep,
                                     self.data.user_num + self.data.item_num)
        h_u_bar = self.propagate_frozen(graph, user_emb, x_all, self.Lg,
                                        cold_mask)
        pairs = self.train_pairs[edges]
        pairs = pairs[cold_mask[pairs[:, 1]]]  # the edges of weight 1
        cols = cold_mask.nonzero().squeeze(1)  # the items any row may take
        e_u, e_i = pairs[:, 0], pairs[:, 1]
        hu, xi_all = m.edge_parts(h_u_bar[e_u], x_all)
        b1, w2, b2 = m.mlp_tail()
        pos = torch.relu(hu + xi_all[e_i] + b1) @ w2 + b2
        n_e = max(int(e_u.shape[0]), 1)
        blk = max(1, min(int(cols.shape[0]),
                         DENSE_ELEMS_CAP // (n_e * self.hidden)))

        def valid_fn(start, stop):
            return ~self.rated(e_u[:, None], cols[None, start:stop])

        lse, has_valid = EdgeLogSumExp.apply(hu + b1, xi_all[cols], w2, b2,
                                             valid_fn, blk)
        w = has_valid.float()
        return (-(pos - lse) * w).sum() / w.sum().clamp_min(1.0)

    def ranking_loss(self, z_u, z_i, users, b_items, weight):
        """L_R (Eq. 8, CGRC.py:258-287): temperature contrastive over the
        shared item set B, whose first ``len(users)`` entries are the
        aligned positives; rows with no unrated candidate drop."""
        bs = users.shape[0]
        sim = (z_u[users] @ z_i[b_items].T) / self.tau
        not_rated = ~self.rated(users[:, None], b_items[None, :])
        le_row = torch.logsumexp(
            torch.where(not_rated, sim, torch.full_like(sim, NEG)), dim=1)
        pos = torch.diagonal(sim[:, :bs])
        w = weight * not_rated.any(dim=1)
        return (-(pos - le_row) * w).sum() / w.sum().clamp_min(1.0)

    def loss(self, batch: Dict[str, torch.Tensor],
             draws: Optional[Dict[str, torch.Tensor]] = None
             ) -> torch.Tensor:
        m = self.model
        if draws is None:
            draws = self.draw()
        x_all = self.item_x()
        users, w = batch["user"].long(), batch["weight"]
        loss_e = self.reconstruction_loss(m.user_emb, x_all,
                                          draws["cold_mask"],
                                          draws["edges"].long())
        z_u, z_i = lightgcn_propagate(self.full_graph, m.user_emb, x_all,
                                      self.Lf)
        b_items = torch.cat([batch["pos_item"].long(),
                             draws["extra"].long()])
        loss_r = self.ranking_loss(z_u, z_i, users, b_items, w)
        reg = l2_reg_loss(self.reg, m.user_emb[users],
                          x_all[batch["pos_item"]], weight=w)
        return self.lambda_e * loss_e + loss_r + reg

    # -------------------------------------------------------------- eval
    def ghat_graph(self, top_users: np.ndarray, cold: np.ndarray):
        """Ĝ on the host: the training graph with the predicted (user, cold
        item) edges added (weights clamped to 1), normalized."""
        n_u, n_i = self.data.user_num, self.data.item_num
        r = self.data.interaction_csr.tocoo()
        rows = np.concatenate([r.row, top_users.reshape(-1)])
        cols = np.concatenate([r.col, np.repeat(cold, top_users.shape[1])])
        r_hat = sp.csr_matrix((np.ones(rows.shape[0], np.float32),
                               (rows, cols)), shape=(n_u, n_i))
        r_hat.data = np.minimum(r_hat.data, 1.0)
        bip = sp.bmat([[None, r_hat], [r_hat.T, None]],
                      format="csr").astype(np.float32)
        host = SparseGraphHost.from_scipy(self.data.normalize_graph(bip))
        return SparseGraph.from_host(host, device=self.device)

    def forward_tables(self):
        """Ĝ reconstruction, then LightGCN over it (CGRC.py:369-401)."""
        m = self.model
        x_all = self.item_x()
        cold = np.asarray(self.data.mapped_cold_item_idx)
        if cold.size == 0:
            return lightgcn_propagate(self.full_graph, m.user_emb, x_all,
                                      self.Lh)
        h_u_bar = self.propagate_frozen(self.full_graph, m.user_emb, x_all,
                                        self.Lg)
        k = min(self.topk, self.data.user_num)
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        top = m.topk_users(h_u_bar, x_all[self.cold_idx], k).cpu().numpy()
        t1 = time.perf_counter()
        graph = self.ghat_graph(top, cold)
        t2 = time.perf_counter()
        tables = lightgcn_propagate(graph, m.user_emb, x_all, self.Lh)
        if cuda:
            torch.cuda.synchronize(self.device)
        event_log().emit("cgrc_eval", topk_users_s=t1 - t0,
                         ghat_rebuild_s=t2 - t1,
                         propagate_s=time.perf_counter() - t2,
                         ghat_edges=int(graph.rows.shape[0]),
                         cold_items=int(cold.size), k=int(k))
        return tables

    def extra_saved_tensors(self) -> Dict[str, torch.Tensor]:
        m = self.model
        with torch.no_grad():
            z_u, z_i = lightgcn_propagate(self.full_graph, m.user_emb,
                                          self.item_x(), self.Lf)
        return {"user_emb_full": z_u, "item_emb_full": z_i}
