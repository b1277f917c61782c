"""LightGCN warm backbone (the port's copy of
``coldrec_tpu/models/lightgcn.py``; reference: model/LightGCN.py).

L rounds of normalized-adjacency propagation ``E_{k+1} = Â E_k`` over the
(U+I)-node bipartite graph, final embedding = mean over layers 0..L
(LightGCN.py:86-96), BPR + L2 on the propagated rows, as the additive
partial sums of ``ops/losses.bpr_l2_parts`` (summed over the data axis of
a mesh before the loss). The SpMM is the ELL + COO apply of
``ops/spmm.py`` with its symmetric backward. Under ``--mesh DxM`` with
M > 1 the graph is a ``parallel.ops.MeshGraph``: layer 0 is assembled from
the gathered tables, each rank propagates its block of node rows, and the
batch's rows are looked up from those blocks by the exchange lookup.
``GraphTables`` holds the two embedding tables of LightGCN, SimGCL,
XSimGCL and NCL.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..ops.losses import bpr_l2_from_parts, bpr_l2_parts
from ..ops.spmm import spmm
from ..parallel.ops import MeshGraph, gather_rows, sharded_lookup
from .common import JaxCarried, xavier_uniform
from .warm_base import WarmBackboneTrainer


def lightgcn_propagate(graph, user_emb: torch.Tensor, item_emb: torch.Tensor,
                       n_layers: int, include_ego: bool = True):
    """Returns (user_table, item_table) averaged over propagation layers."""
    ego = torch.cat([user_emb, item_emb], dim=0)
    acc = ego if include_ego else torch.zeros_like(ego)
    count = 1 if include_ego else 0
    for _ in range(n_layers):
        ego = spmm(graph, ego)
        acc = acc + ego
        count += 1
    mean = acc / count
    n_users = user_emb.shape[0]
    return mean[:n_users], mean[n_users:]


class GraphTables(JaxCarried, nn.Module):
    """The xavier-initialized (user_num, d) and (item_num, d) ego tables
    (the JAX ``params`` ``user_emb`` / ``item_emb``)."""

    def __init__(self, user_num: int, item_num: int, emb_size: int = 64,
                 seed: int = 2024, device="cuda"):
        super().__init__()
        gen = torch.Generator().manual_seed(int(seed))
        self.user_emb = nn.Parameter(xavier_uniform((user_num, emb_size),
                                                    gen))
        self.item_emb = nn.Parameter(xavier_uniform((item_num, emb_size),
                                                    gen))
        self.to(resolve_device(device))

    def jax_slots(self) -> list:
        return [(("params", "user_emb"), self.user_emb, False),
                (("params", "item_emb"), self.item_emb, False)]

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        u, d = params["user_emb"].shape
        return {"user_num": u, "item_num": params["item_emb"].shape[0],
                "emb_size": d}


class GraphTrainer(WarmBackboneTrainer):
    """A graph backbone: ``--layers`` rounds over the normalized adjacency
    (``self.graph``) of the ego tables ``self.model`` (``module`` built by
    ``init_module``; ``init_params`` = the JAX trainer's ``params``)."""

    module = GraphTables

    def __init__(self, config, init_params: Optional[Dict] = None):
        super().__init__(config)
        self.n_layers = int(self.args.layers)
        self.check_flags()
        self.graph = self.build_graph()
        self.model = self.init_module(
            self.module, init_params, user_num=self.data.user_num,
            item_num=self.data.item_num, emb_size=self.emb_size,
            **self.module_kw())
        self.setup_optimizer()

    def check_flags(self):
        """Raise on a flag combination the model refuses."""

    def module_kw(self) -> dict:
        return {}

    def rows(self, batch, user_table, item_table):
        return (user_table[batch["user"]], item_table[batch["pos_item"]],
                item_table[batch["neg_item"]], batch["weight"])


class LightGCNTrainer(GraphTrainer):
    mesh_support = "sharded"

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if isinstance(self.graph, MeshGraph):
            # one exchange for the three id sets (node ids)
            n_users = self.data.user_num
            ids = torch.cat([batch["user"].long(),
                             batch["pos_item"].long() + n_users,
                             batch["neg_item"].long() + n_users])
            rows = sharded_lookup(self.mesh, self.propagate_block(), ids,
                                  "exchange")
            u, pos, neg = rows.chunk(3)
            w = batch["weight"]
        else:
            u, pos, neg, w = self.rows(batch, *self.forward_tables())
        parts = bpr_l2_parts(u, pos, neg, w)
        return bpr_l2_from_parts(self.reduce_parts(parts), self.reg)

    def propagate_block(self) -> torch.Tensor:
        """This rank's node-row block of the layer mean, on the mesh graph:
        layer 0 from the full tables (their gradients summed over the model
        group, as each rank uses only its own block of them)."""
        g, m = self.graph, self.model
        if self.sharded >= {"user_emb", "item_emb"}:
            # one gather for both tables: rank r's block holds its user
            # rows, then its item rows
            n_user_rows, d = m.user_emb.shape
            both = gather_rows(self.mesh, torch.cat([m.user_emb, m.item_emb]),
                               replicated=False).view(self.mesh.n_model, -1, d)
            ego = torch.cat([both[:, :n_user_rows].reshape(-1, d),
                             both[:, n_user_rows:].reshape(-1, d)])
        else:
            ego = torch.cat([self.full_table(name, replicated=False)
                             for name in ("user_emb", "item_emb")])
        x = g.block(ego)
        acc = x
        for _ in range(self.n_layers):
            x = g(x)
            acc = acc + x
        return acc / (self.n_layers + 1)

    def forward_tables(self):
        if isinstance(self.graph, MeshGraph):
            full = self.graph.full(self.propagate_block())
            n_users = self.data.user_num
            return full[:n_users], full[n_users:]
        m = self.model
        return lightgcn_propagate(self.graph, m.user_emb, m.item_emb,
                                  self.n_layers)
