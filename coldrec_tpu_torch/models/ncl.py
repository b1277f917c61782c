"""NCL warm backbone (the port's copy of ``coldrec_tpu/models/ncl.py``;
reference: model/NCL.py).

LightGCN propagation + two SSL terms:

  * layer contrast between the layer-0 and layer-(2*hyper_layers)
    embeddings, negatives = ALL users (items), sum-reduced (NCL.py:68-94);
  * ProtoNCE against k-means centroids (NCL.py:57-66), the e-step rerun at
    the start of every epoch >= ``WARMUP_EPOCHS`` (101-104); earlier epochs
    skip the proto term (116-121).

faiss.Kmeans is replaced by ``ops/kmeans.py``, drawn from the trainer's
device generator. Requires hyper_layers*2 <= layers (NCL.py:19-23). The
JAX package swaps step functions when the proto term comes on; here
``loss`` adds it while ``_proto_on`` is set (or when ``clusters`` are
passed in).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.kmeans import kmeans
from ..ops.losses import (
    _normalize, bpr_l2_from_parts, bpr_l2_parts, info_nce_from_parts,
    info_nce_parts,
)
from .lightgcn import GraphTrainer

WARMUP_EPOCHS = 20  # NCL.py:103,116


def _ssl_one_side(context, initial, initial_all, w, temp):
    """sum_rows -log(exp(c.i / t) / sum_all exp(c.a / t)) * w of the batch
    rows' ``context`` and ``initial`` rows against every row of
    ``initial_all`` (a plain weighted sum: it adds up over data blocks)."""
    c = _normalize(context)
    i = _normalize(initial)
    all_n = _normalize(initial_all)
    pos = torch.exp((c * i).sum(dim=1) / temp)
    ttl = torch.exp(c @ all_n.T / temp).sum(dim=1)
    return (-torch.log(pos / ttl) * w).sum()


class NCLTrainer(GraphTrainer):
    """On a mesh: the layer-SSL negatives are every user (item), so each
    rank takes the whole layer-0 table (``ego(replicated=True)``) and its
    batch block's context rows; ProtoNCE's anchors are this rank's data
    block of the global batch, its columns the global batch's centroid rows
    (``info_nce_parts``); the e-step runs k-means on the whole tables, the
    generator in one state on every rank, so every rank holds one rank's
    clusters."""

    global_keys = ("user", "pos_item", "weight")

    def check_flags(self):
        a = self.args
        self.hyper_layers = int(a.hyper_layers)
        if self.hyper_layers * 2 > self.n_layers:
            raise ValueError(
                "NCL needs hyper_layers*2 <= layers, got "
                f"hyper_layers={self.hyper_layers}, layers={self.n_layers}.")
        self.ssl_temp = float(a.tau)
        self.ssl_reg = float(a.ssl_reg)
        self.alpha = float(a.alpha)
        self.proto_reg = float(a.proto_reg)
        self.k = int(a.num_clusters)
        # (user centroids, user -> cluster, item centroids, item -> cluster)
        self.clusters = None
        self._proto_on = False

    # ----------------------------------------------------------------- ssl
    def ssl_parts(self, initial, context_rows, batch) -> torch.Tensor:
        """[user side, item side] of the layer contrast (each a weighted
        sum over the batch block): ``initial`` the whole layer-0 table,
        ``context_rows`` the block's (user, pos) rows of layer
        2 * hyper_layers."""
        nu = self.data.user_num
        w = batch["weight"]
        init_u, init_i = initial[:nu], initial[nu:]
        cu, ci = context_rows
        return torch.stack([
            _ssl_one_side(cu, init_u[batch["user"].long()], init_u, w,
                          self.ssl_temp),
            _ssl_one_side(ci, init_i[batch["pos_item"].long()], init_i, w,
                          self.ssl_temp)])

    def proto_parts(self, initial, batch, clusters) -> torch.Tensor:
        """ProtoNCE's [user, item] ``info_nce_parts``: InfoNCE(emb[idx],
        centroid[cluster[idx]]) over the global batch (NCL.py:61-64), the
        anchors this rank's block, pad rows left out of the mean and of the
        negative columns."""
        uc, u2c, ic, i2c = clusters
        nu = self.data.user_num
        w = self.global_rows(batch, "weight")
        off = self.data_offset(w.shape[0])
        out = []
        for table, cent, assign, key in ((initial[:nu], uc, u2c, "user"),
                                         (initial[nu:], ic, i2c, "pos_item")):
            ids = self.global_rows(batch, key).long()
            out.append(info_nce_parts(
                table[batch[key].long()], cent[assign[ids]], off,
                batch["weight"], w, self.ssl_temp))
        return torch.cat(out)

    def loss(self, batch: Dict[str, torch.Tensor],
             clusters: Optional[tuple] = None) -> torch.Tensor:
        """BPR + L2 + layer SSL, + ProtoNCE on ``clusters`` or, while the
        proto term is on, on the e-step's."""
        if clusters is None and self._proto_on:
            clusters = self.clusters
        ego = self.ego()
        mean, layers = self.propagate(ego=ego)
        # the whole layer 0 (the negatives): its gradient kept per block
        initial = self.ego(replicated=True) if self.on_mesh else ego
        context = layers[self.hyper_layers * 2]
        groups = self.batch_groups(batch)
        rows = self.node_rows([mean, context], groups)
        u, pos, neg = rows[0]
        parts = [bpr_l2_parts(u, pos, neg, batch["weight"]),
                 self.ssl_parts(initial, rows[1][:2], batch)]
        if clusters is not None:
            parts.append(self.proto_parts(initial, batch, clusters))
        p = self.reduce_parts(torch.cat(parts))
        loss = (bpr_l2_from_parts(p[:5], self.reg)
                + self.ssl_reg * (p[5] + self.alpha * p[6]))
        if clusters is not None:
            loss = loss + self.proto_reg * (
                info_nce_from_parts(p[7:9])
                + info_nce_from_parts(p[9:11])) * self.batch_size
        return loss

    def forward_tables(self):
        return self.node_tables(self.propagate()[0])

    # --------------------------------------------------------------- e-step
    def e_step(self):
        """k-means of the user and the item ego tables (whole on every
        rank)."""
        with torch.no_grad():
            tables = [self.full_table(n) for n in ("user_emb", "item_emb")]
        uc, u2c = kmeans(tables[0].detach(), self.k, generator=self.generator)
        ic, i2c = kmeans(tables[1].detach(), self.k, generator=self.generator)
        self.clusters = (uc, u2c, ic, i2c)

    def epoch_hook(self, epoch: int):
        self._proto_on = epoch >= WARMUP_EPOCHS
        if self._proto_on:
            self.e_step()
