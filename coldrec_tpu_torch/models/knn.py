"""KNN cold-start baseline (the port's copy of ``coldrec_tpu/models/knn.py``;
reference: model/KNN.py).

Trains its own MF or LightGCN encoder (``--backbone``, KNN.py:12-15) with
BPR + L2; a cold row is the mean of its ``--knn_num`` warm neighbours' rows,
the neighbours found once by exact inner-product search over the content
(faiss IndexFlatIP -> ``ops/knn.py``, KNN.py:63-77; on the card the
retrieval kernel at the content's width).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops.knn import knn_inner_product
from ..ops.losses import bpr_loss, l2_reg_loss
from .cold_base import ColdStartModelBase
from .lightgcn import GraphTables, lightgcn_propagate


class KNNTrainer(ColdStartModelBase):
    """``init_params`` (the JAX trainer's ``params`` as numpy) replaces the
    seeded tables."""

    def __init__(self, config, init_params: Optional[Dict] = None):
        super().__init__(config)
        self.use_gcn = self.args.backbone != "MF"
        if self.use_gcn:
            self.graph = self.build_graph()
            self.n_layers = int(self.args.layers)
        self.knn_num = int(self.args.knn_num)
        self.model = self.init_module(
            GraphTables, init_params, user_num=self.data.user_num,
            item_num=self.data.item_num, emb_size=self.emb_size)
        self.neighbor_ids = self._ids(self.precompute_neighbors())
        self.setup_optimizer()

    def precompute_neighbors(self) -> np.ndarray:
        """(n_cold, knn_num) mapped warm ids nearest in content space
        (KNN.py:63-77)."""
        if self.args.cold_object == "item":
            content = self.data.item_content
            cold = self.data.mapped_cold_item_idx
            warm = self.data.mapped_warm_item_idx
        else:
            content = self.data.user_content
            cold = self.data.mapped_cold_user_idx
            warm = self.data.mapped_warm_user_idx
        _, idx = knn_inner_product(content[cold], content[warm],
                                   self.knn_num, device=self.device)
        return warm[idx]

    def encoder_tables(self):
        m = self.model
        if self.use_gcn:
            return lightgcn_propagate(self.graph, m.user_emb, m.item_emb,
                                      self.n_layers)
        return m.user_emb, m.item_emb

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        ut, it = self.encoder_tables()
        u = ut[batch["user"]]
        pos = it[batch["pos_item"]]
        neg = it[batch["neg_item"]]
        w = batch["weight"]
        return bpr_loss(u, pos, neg, w) + l2_reg_loss(self.reg, u, pos, neg,
                                                      weight=w)

    def forward_tables(self):
        ut, it = self.encoder_tables()
        table = it if self.args.cold_object == "item" else ut
        gen = table[self.neighbor_ids].mean(dim=1)
        return self.patch_cold_rows(ut, it, gen)
