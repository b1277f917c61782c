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
XSimGCL and NCL; ``GraphTrainer`` the propagation, the node-row lookup and
the eval tables that all five graph backbones share (NGCF through its own
layer hook).
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
    ``init_module``; ``init_params`` = the JAX trainer's ``params``).

    The propagation runs on one device's whole node table or, under a model
    axis > 1, on this rank's node-row block of the :class:`MeshGraph`
    (``propagate``, with a per-layer ``hook``); the batch's rows come from
    the layers by node id (``node_rows``: one exchange lookup on the mesh
    graph), the eval tables from ``node_tables``."""

    module = GraphTables
    mesh_support = "sharded"

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

    @property
    def on_mesh(self) -> bool:
        """Whether the propagation runs on node-row blocks (a model axis
        > 1)."""
        return isinstance(self.graph, MeshGraph)

    def ego(self, replicated: bool = False) -> torch.Tensor:
        """Layer 0: the (U+I, d) node table of the ego tables, whole on this
        rank. ``replicated=False``: this rank uses only its own node block
        of it (the propagation), so its gradient is summed over the model
        group; ``True``: every rank of the group computes the same thing
        from it (NCL's negatives)."""
        m = self.model
        if self.sharded >= {"user_emb", "item_emb"}:
            # one gather for both tables: rank r's block holds its user
            # rows, then its item rows
            n_user_rows, d = m.user_emb.shape
            both = gather_rows(self.mesh, torch.cat([m.user_emb, m.item_emb]),
                               replicated).view(self.mesh.n_model, -1, d)
            return torch.cat([both[:, :n_user_rows].reshape(-1, d),
                              both[:, n_user_rows:].reshape(-1, d)])
        return torch.cat([self.full_table(name, replicated)
                          for name in ("user_emb", "item_emb")])

    def propagate(self, hook=None, first: int = 0,
                  ego: Optional[torch.Tensor] = None):
        """(mean of layers ``first``..L, [layers 0..L]) of the node tables:
        whole, or this rank's node-row block of each on the mesh graph.
        Layer k + 1 is ``hook(k, side, prev)`` of ``side`` = Â ``prev``
        (``side`` itself without a hook); layer 0 is ``ego`` (default
        :meth:`ego`). The mean is summed layer by layer as each is made
        (``first`` 0 or 1)."""
        x = self.ego() if ego is None else ego
        if self.on_mesh:
            x = self.graph.block(x)
        out = [x]
        acc = x if first == 0 else torch.zeros_like(x)
        for k in range(self.n_layers):
            side = self.graph(x) if self.on_mesh else spmm(self.graph, x)
            x = side if hook is None else hook(k, side, x)
            acc = acc + x
            out.append(x)
        return acc / (self.n_layers + 1 - first), out

    def node_rows(self, tables: list, groups: list) -> list:
        """For each node table of ``tables``, its rows of each ``(side,
        ids)`` of ``groups`` (side "user" or "item"), replicated over the
        model group: on the mesh graph one exchange lookup of the tables
        side by side, else the user or item part of each table indexed."""
        n_users = self.data.user_num
        if not self.on_mesh:
            out = []
            for t in tables:
                part = {"user": t[:n_users], "item": t[n_users:]}
                out.append([part[side][ids.long()] for side, ids in groups])
            return out
        node_ids = torch.cat([ids.long() + (n_users if side == "item" else 0)
                              for side, ids in groups])
        rows = sharded_lookup(self.mesh, torch.cat(tables, dim=1), node_ids,
                              "exchange")
        sizes = [ids.shape[0] for _, ids in groups]
        return [list(part.split(sizes))
                for part in rows.split([t.shape[1] for t in tables], dim=1)]

    def node_tables(self, node: torch.Tensor):
        """(user, item) tables of a node table (gathered whole from the
        blocks on the mesh graph)."""
        if self.on_mesh:
            node = self.graph.full(node)
        n_users = self.data.user_num
        return node[:n_users], node[n_users:]

    @staticmethod
    def batch_groups(batch: Dict[str, torch.Tensor]) -> list:
        """The (side, ids) groups of the batch's users, positives and
        negatives."""
        return [("user", batch["user"]), ("item", batch["pos_item"]),
                ("item", batch["neg_item"])]


class LightGCNTrainer(GraphTrainer):
    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        mean, _ = self.propagate()
        u, pos, neg = self.node_rows([mean], self.batch_groups(batch))[0]
        parts = bpr_l2_parts(u, pos, neg, batch["weight"])
        return bpr_l2_from_parts(self.reduce_parts(parts), self.reg)

    def forward_tables(self):
        return self.node_tables(self.propagate()[0])
