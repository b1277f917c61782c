"""FS-GNN feature and structure completion model (the port's copy of
``coldrec_tpu/models/fsgnn.py``; reference: model/FSGNN.py).

Pipeline (FSGNN.py:444-457): content -> Linear h0; a bipartite GAT encoder
with a segment-softmax attention (319-356); a stacked GCN decoder on the
training graph (358-366); L_fc = MSE on the cold rows (368-387); structure
completion: precomputed PPR top-k extra user-item edges (54-103) and
cosine-kNN user-user / item-item graphs (106-152), merged into one weighted
graph (155-170); a GCN per kNN graph and an edge MLP, L_sc on sampled kNN
edges (401-431); LightGCN over the merged graph (433-442); loss = BPR +
lambda L_fc + mu L_sc + L2 (485-492). Adam with coupled weight decay
(optax's ``chain(add_decayed_weights, adam)`` = ``torch.optim.Adam``'s
``weight_decay``).

Every graph is built once on the host at set-up: the PPR by dense power
iteration while the (users x nodes) block is small, else by the native
forward push (``native.ppr_push_topk_native``; a failed build raises, as
the dense path would take hours at book-crossing shape and gives another
graph); the kNN graphs through ``ops/knn.knn_cosine``, which takes the
retrieval kernel on the card. The four propagation matrices are ELL + COO
``SymSpmm`` operators (``ops/spmm.py``). A side with no content gets
N(0, 0.01^2) fallback columns from ``--seed``. The loss's draws (the cold
side's dropout mask and the structure loss's edges, drawn with
replacement) come from the trainer's generator, or from
``loss(batch, draws=)`` (the tests hand it the JAX package's). The graph
build's seconds and sizes go to the event log (``fsgnn_graph``).
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn

from ..data.builder import SparseGraphHost
from ..device import resolve_device
from ..ops.knn import knn_cosine
from ..ops.losses import bpr_loss, l2_reg_loss
from ..ops.spmm import make_sym_spmm
from ..utils.logging import event_log
from .cold_base import ColdStartModelBase
from .common import (
    JaxCarried, linear_params, linear_slots, mlp_slots, rows_of,
    xavier_uniform,
)
from .lightgcn import lightgcn_propagate

# dense power-iteration PPR only while the (users x nodes) block fits this
# element budget; above it the native forward push runs (a module constant,
# so tests can force the push path on small graphs)
DENSE_PPR_ELEMS = 1 << 28


def ppr_topk_extra_edges(r_train, delta, n_iter, topk, weighted, chunk=1024,
                         push_eps=1e-5):
    """PPR restarting at each user over the self-looped bipartite graph: the
    top-k unobserved items of every user as extra user-item edges
    (FSGNN.py:54-103), a (users, items) float32 CSR, weights the row-max
    normalized scores (``weighted``) or 1.

    Dense power iteration (the reference's formulation, chunked over users)
    while the (users x nodes) block stays small; above that the native
    forward push, whose scores carry an additive error <= push_eps * degree
    and which emits only the items a push reached (the dense path fills an
    unweighted row up to k with zero-score items)."""
    nu, ni = r_train.shape
    n = nu + ni
    rows, cols = r_train.nonzero()
    a = sp.coo_matrix(
        (np.ones(2 * len(rows), np.float32),
         (np.concatenate([rows, cols + nu]),
          np.concatenate([cols + nu, rows]))),
        shape=(n, n)).tocsr()
    a = a + sp.eye(n, format="csr", dtype=np.float32)

    if nu * n > DENSE_PPR_ELEMS:
        from ..native import ppr_push_topk_native

        r_csr = r_train.tocsr().astype(np.float32)
        r_csr.sort_indices()
        items, vals = ppr_push_topk_native(
            a.indptr, a.indices, nu, r_csr.indptr, r_csr.indices,
            float(delta), float(push_eps), int(topk))
        valid = items >= 0
        w = np.where(valid, np.clip(vals, 0.0, None), 0.0)
        if weighted:
            # per-row max-normalized; rows with a zero max keep zero weights
            mx = w.max(axis=1, keepdims=True)
            w = np.where(mx > 0, w / np.maximum(mx, 1e-30), w)
        else:
            w = valid.astype(np.float32)
        out_r = np.repeat(np.arange(nu), items.shape[1])[valid.ravel()]
        out_c = items.ravel()[valid.ravel()]
        out_v = w.ravel()[valid.ravel()].astype(np.float32)
        if out_r.size == 0:
            return sp.csr_matrix((nu, ni), dtype=np.float32)
        return sp.csr_matrix((out_v, (out_r, out_c)), shape=(nu, ni))

    deg = np.asarray(a.sum(1)).flatten()
    d_inv = np.divide(1.0, deg, out=np.zeros_like(deg), where=deg > 0)
    p_mat = (sp.diags(d_inv) @ a).tocsr().astype(np.float64)
    out_rows, out_cols, out_vals = [], [], []
    r_csr = r_train.tocsr()
    for u0 in range(0, nu, chunk):
        u1 = min(u0 + chunk, nu)
        c = u1 - u0
        pi = np.zeros((c, n))
        pi[np.arange(c), np.arange(u0, u1)] = 1.0
        restart = pi * float(delta)
        for _ in range(int(n_iter)):
            pi = (1.0 - delta) * (pi @ p_mat) + restart
        scores = pi[:, nu:]
        for r in range(c):
            u = u0 + r
            observed = r_csr[u].indices
            cand = scores[r].copy()
            cand[observed] = -np.inf
            k_eff = min(int(topk), ni - len(observed))
            if k_eff <= 0:
                continue
            top = np.argpartition(-cand, kth=k_eff - 1)[:k_eff]
            if weighted:
                w = np.clip(cand[top], 0.0, None).astype(np.float32)
                mx = w.max() if w.size else 0.0
                if mx > 0:
                    w = w / mx
            else:
                w = np.ones(k_eff, np.float32)
            out_rows.extend([u] * k_eff)
            out_cols.extend(top.tolist())
            out_vals.extend(w.tolist())
    if not out_rows:
        return sp.csr_matrix((nu, ni), dtype=np.float32)
    return sp.csr_matrix((out_vals, (out_rows, out_cols)), shape=(nu, ni))


def cosine_knn_graph(feat, k, weighted, device="cuda"):
    """Symmetric cosine kNN graph, weights in (0, 1] (FSGNN.py:106-152):
    each row's first k neighbours other than itself among its top k + 1 by
    cosine (``knn_cosine``: the kernel route on the card), weight (cos +
    1) / 2 clipped to [1e-6, 1] or 1, symmetrized by the maximum, no
    diagonal. The JAX package's per-row loop, vectorized: the same CSR."""
    n = feat.shape[0]
    k_eff = min(int(k), n - 1)
    if n <= 1 or k_eff <= 0:
        return sp.csr_matrix((n, n), dtype=np.float32)
    sims, idx = knn_cosine(feat, feat, k_eff + 1, device=device)
    other = idx != np.arange(n)[:, None]
    take = other & (np.cumsum(other, axis=1) <= k_eff)
    rows = np.nonzero(take)[0]
    if weighted:
        vals = np.clip((sims[take].astype(np.float64) + 1.0) * 0.5, 1e-6,
                       1.0)
    else:
        vals = np.ones(rows.shape[0])
    g = sp.coo_matrix((vals, (rows, idx[take])), shape=(n, n),
                      dtype=np.float32).tocsr()
    g = g.maximum(g.T)
    g.setdiag(0)
    g.eliminate_zeros()
    return g


def sym_norm(adj):
    """D^-1/2 A D^-1/2 (rows of zero sum stay zero)."""
    rowsum = np.asarray(adj.sum(1)).flatten()
    d_inv = np.zeros_like(rowsum, dtype=np.float32)
    np.power(rowsum, -0.5, out=d_inv, where=rowsum != 0)
    d = sp.diags(d_inv)
    return (d @ adj @ d).tocsr()


def segment_softmax_sum(scores, seg, n_seg, values):
    """sum over each segment's edges of softmax(scores) * values, the
    scores clipped to +-20 (no max subtracted) and a segment whose
    denominator is <= 1e-8 left at 0 (FSGNN.py:320-347)."""
    alpha = torch.exp(scores.clamp(-20.0, 20.0))
    den = rows_of(alpha.new_zeros(n_seg).index_add_(0, seg, alpha), seg)
    w = torch.where(den > 1e-8, alpha / den.clamp_min(1e-8),
                    torch.zeros_like(alpha))
    return values.new_zeros((n_seg, values.shape[1])).index_add_(
        0, seg, w[:, None] * values)


class FSGNN(JaxCarried, nn.Module):
    def __init__(self, user_dim: int, item_dim: int, emb_size: int,
                 hidden: int, n_dec: int, n_sc: int, user_num: int = 0,
                 item_num: int = 0, id_residual: bool = False,
                 seed: int = 2024, device="cuda"):
        super().__init__()
        d = emb_size
        gen = torch.Generator().manual_seed(int(seed))

        def lin(i, o, bias=True):
            return linear_params(i, o, gen, bias=bias)

        self.proj_u = lin(user_dim, d)
        self.proj_i = lin(item_dim, d)
        self.lin_u_gat = lin(d, hidden)
        self.lin_i_gat = lin(d, hidden)
        self.gat_att = lin(2 * hidden, 1, bias=False)
        self.fc_dec = nn.ModuleList(lin(d, d) for _ in range(n_dec))
        self.struct_mlp = nn.ModuleList([lin(2 * d, hidden), lin(hidden, 1)])
        self.sc_uu = nn.ModuleList(lin(d, d) for _ in range(n_sc))
        self.sc_ii = nn.ModuleList(lin(d, d) for _ in range(n_sc))
        self.id_residual = id_residual
        if id_residual:
            self.emb_user = nn.Parameter(xavier_uniform((user_num, d), gen))
            self.emb_item = nn.Parameter(xavier_uniform((item_num, d), gen))
        self.to(resolve_device(device))

    def jax_slots(self) -> list:
        out = []
        for name in ("proj_u", "proj_i", "lin_u_gat", "lin_i_gat",
                     "gat_att"):
            out += linear_slots(getattr(self, name), ("params", name))
        for name in ("fc_dec", "struct_mlp", "sc_uu", "sc_ii"):
            out += mlp_slots(getattr(self, name), ("params", name))
        if self.id_residual:
            out += [(("params", "emb_user"), self.emb_user, False),
                    (("params", "emb_item"), self.emb_item, False)]
        return out

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        d = params["proj_u"]["w"].shape[1]
        out = {"user_dim": params["proj_u"]["w"].shape[0],
               "item_dim": params["proj_i"]["w"].shape[0], "emb_size": d,
               "hidden": params["lin_u_gat"]["w"].shape[1],
               "n_dec": len(params["fc_dec"]),
               "n_sc": len(params["sc_uu"]),
               "id_residual": "emb_user" in params}
        if out["id_residual"]:
            out.update(user_num=params["emb_user"].shape[0],
                       item_num=params["emb_item"].shape[0])
        return out


class FSGNNTrainer(ColdStartModelBase):
    """``init_params`` (the JAX trainer's ``params`` as numpy) replaces the
    seeded weights."""

    # the JAX trainer never sets up a mesh: --mesh runs on one device
    mesh_support = "one_device"

    def __init__(self, config, init_params: Optional[Dict] = None):
        super().__init__(config)
        a = self.args
        nu, ni = self.data.user_num, self.data.item_num
        rng = np.random.default_rng(int(a.seed))

        def side_feat(content, rows):
            if content is not None:
                return np.asarray(content[:rows], np.float32)
            return (rng.standard_normal((rows, int(a.fsgnn_fallback_dim)))
                    * 0.01).astype(np.float32)

        fu = side_feat(self.data.user_content, nu)
        fi = side_feat(self.data.item_content, ni)
        self.raw_u = torch.as_tensor(fu, device=self.device)
        self.raw_i = torch.as_tensor(fi, device=self.device)
        self.build_graphs(fu, fi)
        self.n_layers = int(a.fsgnn_light_layers)
        self.p_drop = float(a.fsgnn_p_drop)
        self.model = self.init_module(
            FSGNN, init_params, user_dim=fu.shape[1], item_dim=fi.shape[1],
            emb_size=self.emb_size, hidden=int(a.fsgnn_gat_hidden),
            n_dec=max(1, int(a.fsgnn_fc_decoder_layers)),
            n_sc=max(1, int(a.fsgnn_sc_layers)), user_num=nu, item_num=ni,
            id_residual=bool(a.fsgnn_id_residual))
        self.setup_optimizer(optimizer=torch.optim.Adam(
            self.model.parameters(), lr=self.lr,
            weight_decay=float(a.fsgnn_weight_decay)))

    def build_graphs(self, fu: np.ndarray, fi: np.ndarray):
        """The one-time host graphs (FSGNN.py:54-170) as device operators."""
        a = self.args
        nu, ni = self.data.user_num, self.data.item_num
        t0 = time.perf_counter()
        r_train = self.data.interaction_csr.tocsr()
        r_extra = ppr_topk_extra_edges(
            r_train, delta=float(a.fsgnn_ppr_delta),
            n_iter=int(a.fsgnn_ppr_iter), topk=int(a.fsgnn_ppr_topk),
            weighted=bool(a.fsgnn_ppr_weighted))
        t1 = time.perf_counter()
        r_ui = (r_train.astype(np.float32) + r_extra).tocsr()
        k, weighted = int(a.fsgnn_knn_k), bool(a.fsgnn_knn_weighted)
        a_uu = cosine_knn_graph(fu, k, weighted, self.device)
        a_ii = cosine_knn_graph(fi, k, weighted, self.device)
        t2 = time.perf_counter()
        merged = sp.bmat(
            [[sp.csr_matrix((nu, nu), dtype=np.float32), r_ui],
             [r_ui.T, sp.csr_matrix((ni, ni), dtype=np.float32)]],
            format="csr") + sp.block_diag((a_uu, a_ii), format="csr")
        merged = merged.maximum(merged.T)

        def operator(mat):
            return make_sym_spmm(SparseGraphHost.from_scipy(sym_norm(mat)),
                                 device=self.device)

        self.g_complete = operator(merged)
        self.g_train = self.build_graph()
        self.g_uu = operator(a_uu + sp.eye(nu, format="csr",
                                           dtype=np.float32))
        self.g_ii = operator(a_ii + sp.eye(ni, format="csr",
                                           dtype=np.float32))
        tp = self.data.train_pairs
        self.edge_u, self.edge_i = self._ids(tp[:, 0]), self._ids(tp[:, 1])
        self.knn_edges = {}
        for tag, g in (("uu", a_uu), ("ii", a_ii)):
            upper = sp.triu(g, k=1).tocoo()
            self.knn_edges[tag] = (self._ids(upper.row),
                                   self._ids(upper.col))
        event_log().emit(
            "fsgnn_graph", ppr_s=t1 - t0, knn_s=t2 - t1,
            build_s=time.perf_counter() - t0,
            ppr_route="push" if nu * (nu + ni) > DENSE_PPR_ELEMS
            else "dense", ppr_edges=int(r_extra.nnz), uu_edges=int(a_uu.nnz),
            ii_edges=int(a_ii.nnz), merged_nnz=int(merged.nnz))

    # ----------------------------------------------------------- forward
    def draw(self) -> Dict[str, torch.Tensor]:
        """The loss's draws: the dropout keep masks of the dropped side(s)
        and the structure loss's edges of each kNN graph (with
        replacement)."""
        g, dev, d = self.generator, self.device, self.emb_size
        keep = 1.0 - self.p_drop
        out = {}
        if self.p_drop > 0:
            for side, n in (("u", self.data.user_num),
                            ("i", self.data.item_num)):
                if self.dropped(side):
                    out[f"keep_{side}"] = torch.rand(
                        (n, d), generator=g, device=dev) < keep
        max_e = int(self.args.fsgnn_sc_max_edges)
        for tag, (rows, _) in self.knn_edges.items():
            m = rows.shape[0]
            if m:
                out[f"sel_{tag}"] = torch.randint(0, m, (min(m, max_e),),
                                                  generator=g, device=dev)
        return out

    def dropped(self, side: str) -> bool:
        """Whether dropout applies to ``side`` ("u" or "i") in training."""
        if not bool(self.args.fsgnn_dropout_cold_side_only):
            return True
        return side == self.args.cold_object[0]

    def gat_encode(self, h0_u, h0_i, hu_t, hi_t):
        """The segment-softmax bipartite GAT (FSGNN.py:319-356)."""
        m = self.model
        eu, ei = self.edge_u, self.edge_i
        wh_u, wh_i = m.lin_u_gat(h0_u), m.lin_i_gat(h0_i)
        att = m.gat_att.weight[0]
        wu_e, wi_e = rows_of(wh_u, eu), rows_of(wh_i, ei)
        z_i = F.leaky_relu(torch.cat([wi_e, wu_e], -1) @ att, 0.2)
        enc_i = torch.sigmoid(segment_softmax_sum(
            z_i, ei, h0_i.shape[0], rows_of(h0_u, eu)) + hi_t)
        z_u = F.leaky_relu(torch.cat([wu_e, wi_e], -1) @ att, 0.2)
        enc_u = torch.sigmoid(segment_softmax_sum(
            z_u, eu, h0_u.shape[0], rows_of(h0_i, ei)) + hu_t)
        return enc_u, enc_i

    def forward_training(self, draws=None):
        """(dec_u, dec_i, L_fc); ``draws`` None: no dropout (eval)."""
        m = self.model
        a = self.args
        h0_u, h0_i = m.proj_u(self.raw_u), m.proj_i(self.raw_i)
        h_t = {"u": h0_u, "i": h0_i}
        if draws is not None and self.p_drop > 0:
            keep = 1.0 - self.p_drop
            for side, h in (("u", h0_u), ("i", h0_i)):
                if self.dropped(side):
                    h_t[side] = torch.where(draws[f"keep_{side}"], h / keep,
                                            torch.zeros_like(h))
        enc_u, enc_i = self.gat_encode(h0_u, h0_i, h_t["u"], h_t["i"])
        x = torch.cat([enc_u, enc_i], 0)
        for k, lin in enumerate(m.fc_dec):
            x = self.g_train(lin(x))
            if k < len(m.fc_dec) - 1:
                x = torch.relu(x)
        nu = h0_u.shape[0]
        dec_u, dec_i = x[:nu], x[nu:]
        if bool(a.fsgnn_lfc_cold_side_only):
            if a.cold_object == "item":
                l_fc = ((dec_i[self.cold_idx] - h0_i[self.cold_idx]) ** 2
                        ).mean()
            else:
                l_fc = ((dec_u[self.cold_idx] - h0_u[self.cold_idx]) ** 2
                        ).mean()
        else:
            l_fc = ((dec_u - h0_u) ** 2).mean() + ((dec_i - h0_i) ** 2).mean()
        return dec_u, dec_i, l_fc

    def structure_loss(self, hu, hi, draws):
        """L_sc: a GCN per kNN graph, then the edge MLP's squared error
        against 1 on the sampled edges of each (FSGNN.py:392-424)."""
        m = self.model

        def gcn(h, graph, layers):
            for lin in layers:
                h = torch.relu(graph(lin(h)))
            return h

        h_n = {"uu": gcn(hu, self.g_uu, m.sc_uu),
               "ii": gcn(hi, self.g_ii, m.sc_ii)}
        parts = []
        for tag, (rows, cols) in self.knn_edges.items():
            if rows.shape[0] == 0:
                continue
            sel = draws[f"sel_{tag}"].long()
            x = torch.relu(m.struct_mlp[0](torch.cat(
                [h_n[tag][rows[sel]], h_n[tag][cols[sel]]], -1)))
            pred = m.struct_mlp[1](x)[:, 0]
            parts.append(((pred - 1.0) ** 2).mean())
        if not parts:
            return hu.new_zeros(())
        return sum(parts) / len(parts)

    def residual(self, dec_u, dec_i):
        m = self.model
        if m.id_residual:
            return dec_u + m.emb_user, dec_i + m.emb_item
        return dec_u, dec_i

    def loss(self, batch: Dict[str, torch.Tensor],
             draws: Optional[Dict[str, torch.Tensor]] = None
             ) -> torch.Tensor:
        a = self.args
        if draws is None:
            draws = self.draw()
        dec_u, dec_i, l_fc = self.forward_training(draws)
        l_sc = self.structure_loss(dec_u, dec_i, draws)
        rec_u, rec_i = lightgcn_propagate(
            self.g_complete, *self.residual(dec_u, dec_i), self.n_layers)
        u = rec_u[batch["user"]]
        pos = rec_i[batch["pos_item"]]
        neg = rec_i[batch["neg_item"]]
        w = batch["weight"]
        return (bpr_loss(u, pos, neg, w)
                + float(a.fsgnn_lambda_fc) * l_fc
                + float(a.fsgnn_mu_sc) * l_sc
                + l2_reg_loss(self.reg, u, pos, neg, weight=w))

    def forward_tables(self):
        dec_u, dec_i, _ = self.forward_training(None)
        return lightgcn_propagate(self.g_complete,
                                  *self.residual(dec_u, dec_i),
                                  self.n_layers)
