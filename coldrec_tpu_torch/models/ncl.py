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
from ..ops.losses import _normalize, bpr_loss, l2_reg_loss
from ..ops.spmm import spmm
from .lightgcn import GraphTrainer

WARMUP_EPOCHS = 20  # NCL.py:103,116


def _ssl_one_side(context, initial, initial_all, idx, w, temp):
    c = _normalize(context[idx])
    i = _normalize(initial[idx])
    all_n = _normalize(initial_all)
    pos = torch.exp((c * i).sum(dim=1) / temp)
    ttl = torch.exp(c @ all_n.T / temp).sum(dim=1)
    return (-torch.log(pos / ttl) * w).sum()


class NCLTrainer(GraphTrainer):
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
    def layer_embs(self):
        m = self.model
        ego = torch.cat([m.user_emb, m.item_emb], dim=0)
        embs = [ego]
        for _ in range(self.n_layers):
            ego = spmm(self.graph, ego)
            embs.append(ego)
        mean = sum(embs) / (self.n_layers + 1)
        nu = self.data.user_num
        return mean[:nu], mean[nu:], embs

    def ssl_layer_loss(self, embs, batch):
        nu = self.data.user_num
        initial = embs[0]
        context = embs[self.hyper_layers * 2]
        w = batch["weight"]
        lu = _ssl_one_side(context[:nu], initial[:nu], initial[:nu],
                           batch["user"], w, self.ssl_temp)
        li = _ssl_one_side(context[nu:], initial[nu:], initial[nu:],
                           batch["pos_item"], w, self.ssl_temp)
        return self.ssl_reg * (lu + self.alpha * li)

    def proto_loss(self, embs, batch, clusters):
        uc, u2c, ic, i2c = clusters
        nu = self.data.user_num
        initial_u, initial_i = embs[0][:nu], embs[0][nu:]
        w = batch["weight"]
        # InfoNCE(emb[idx], centroid[cluster[idx]]) * batch_size
        # (NCL.py:61-64); pad rows left out of the mean and of the in-batch
        # negative columns
        neg_inf = torch.finfo(torch.float32).min

        def one(v, c):
            logits = (_normalize(v) @ _normalize(c).T) / self.ssl_temp
            logits = torch.where(w[None, :] > 0, logits,
                                 torch.full_like(logits, neg_inf))
            lp = torch.diagonal(logits) - torch.logsumexp(logits, dim=1)
            return -torch.where(w > 0, lp, torch.zeros_like(lp)).sum() / (
                w.sum().clamp_min(1.0))

        loss_u = one(initial_u[batch["user"]], uc[u2c[batch["user"]]])
        loss_i = one(initial_i[batch["pos_item"]],
                     ic[i2c[batch["pos_item"]]])
        return self.proto_reg * (loss_u + loss_i) * self.batch_size

    def loss(self, batch: Dict[str, torch.Tensor],
             clusters: Optional[tuple] = None) -> torch.Tensor:
        """BPR + L2 + layer SSL, + ProtoNCE on ``clusters`` or, while the
        proto term is on, on the e-step's."""
        ut, it, embs = self.layer_embs()
        u, pos, neg, w = self.rows(batch, ut, it)
        loss = (bpr_loss(u, pos, neg, w)
                + l2_reg_loss(self.reg, u, pos, neg, weight=w)
                + self.ssl_layer_loss(embs, batch))
        if clusters is None and self._proto_on:
            clusters = self.clusters
        if clusters is not None:
            loss = loss + self.proto_loss(embs, batch, clusters)
        return loss

    def forward_tables(self):
        ut, it, _ = self.layer_embs()
        return ut, it

    # --------------------------------------------------------------- e-step
    def e_step(self):
        """k-means of the user and the item ego tables."""
        m = self.model
        uc, u2c = kmeans(m.user_emb.detach(), self.k,
                         generator=self.generator)
        ic, i2c = kmeans(m.item_emb.detach(), self.k,
                         generator=self.generator)
        self.clusters = (uc, u2c, ic, i2c)

    def epoch_hook(self, epoch: int):
        self._proto_on = epoch >= WARMUP_EPOCHS
        if self._proto_on:
            self.e_step()
