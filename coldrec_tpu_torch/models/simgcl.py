"""SimGCL warm backbone (the port's copy of ``coldrec_tpu/models/simgcl.py``;
reference: model/SimGCL.py).

LightGCN propagation with per-layer uniform noise ``sign(e) *
normalize(U(0,1)) * eps`` when perturbed (SimGCL.py:101-113); CL loss =
InfoNCE between two independently perturbed views on the unique batch
users / items (53-60). The layer mean is over layers 1..L — layer 0 is
EXCLUDED, unlike LightGCN (SimGCL.py:110-111), so a node with no edge (a
cold item) gets an all-zero clean row. L2 applies to user + pos only
(SimGCL.py:29). The noise comes from the trainer's device generator, or is
injected (``noise_pair=``, as the JAX ``loss_fn`` takes it).

On a mesh the loss is the one-rank loss of the global batch, as the JAX
package's GSPMD program computes it: each layer's noise is drawn as the
whole (U+I, d) plane on every rank (``plane_rand``: the generator stream
of one rank, draw for draw) and each rank keeps its node block; the
InfoNCE's anchors are this rank's data block of the global batch's unique
ids, its columns all of them (``info_nce_parts``), and BPR, L2 and both
InfoNCE terms are additive parts summed over the data axis.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.losses import (
    _normalize, bpr_l2_from_parts, bpr_l2_parts, info_nce_from_parts,
    info_nce_parts, unique_padded,
)
from .lightgcn import GraphTrainer


def perturb(ego: torch.Tensor, eps: float, noise: torch.Tensor):
    """ego + sign(ego) * normalize(noise) * eps, ``noise`` a U(0,1) draw of
    ego's shape."""
    return ego + torch.sign(ego) * _normalize(noise) * eps


class ContrastiveTrainer(GraphTrainer):
    """The CL flags, the perturbed propagation and the InfoNCE of the
    unique batch users and items."""

    global_keys = ("user", "pos_item", "weight")

    def __init__(self, config, init_params: Optional[Dict] = None):
        self.eps = float(config.args.eps)
        self.cl_rate = float(config.args.cl_rate)
        self.tau = float(config.args.tau)
        super().__init__(config, init_params)

    def perturbed(self, noise: Optional[torch.Tensor] = None):
        """The layer hook adding the noise: layer k's U(0,1) plane is
        ``noise[k]`` (an (L, U+I, d) stack) or a fresh draw of the whole
        plane; on the mesh graph this rank's node block of it."""
        block = self.graph.block if self.on_mesh else None
        n_nodes = self.data.user_num + self.data.item_num

        def hook(k, side, prev):
            if noise is not None:
                u = noise[k] if block is None else block(noise[k])
            else:
                u = self.plane_rand((n_nodes, side.shape[1]), side.dtype,
                                    block)
            return perturb(side, self.eps, u)

        return hook

    def cl_groups(self, batch: Dict[str, torch.Tensor]):
        """The InfoNCE's id groups over the global batch's unique users and
        items: (anchors: this rank's data block of each, columns: all of
        each, [(row mask, column mask, offset)] for users and items)."""
        w = self.global_rows(batch, "weight")
        bs = w.shape[0]
        uu, um = unique_padded(self.global_rows(batch, "user"), w, bs,
                               self.data.user_num)
        iu, im = unique_padded(self.global_rows(batch, "pos_item"), w, bs,
                               self.data.item_num)
        anchors = [("user", self.data_block(uu)),
                   ("item", self.data_block(iu))]
        columns = [("user", uu), ("item", iu)]
        masks = [(self.data_block(mask), mask, self.data_offset(bs))
                 for mask in (um, im)]
        return anchors, columns, masks

    def combine(self, batch, rows, anchors, columns, masks):
        """The loss from the batch's (u, pos, neg) rows and the two sides'
        anchor and column view rows (``masks`` of :meth:`cl_groups`): BPR +
        L2 (u, pos) + cl_rate * InfoNCE, its parts summed over the data
        axis."""
        u, pos, neg = rows
        parts = [bpr_l2_parts(u, pos, neg, batch["weight"], l2_neg=False)]
        parts += [info_nce_parts(a, c, off, rv, cv, self.tau)
                  for a, c, (rv, cv, off) in zip(anchors, columns, masks)]
        p = self.reduce_parts(torch.cat(parts))
        cl = info_nce_from_parts(p[4:6]) + info_nce_from_parts(p[6:8])
        return bpr_l2_from_parts(p[:4], self.reg) + self.cl_rate * cl


class SimGCLTrainer(ContrastiveTrainer):
    def loss(self, batch: Dict[str, torch.Tensor],
             noise_pair=None) -> torch.Tensor:
        anchors, columns, masks = self.cl_groups(batch)
        clean, _ = self.propagate(first=1)
        rows = self.node_rows([clean], self.batch_groups(batch))[0]
        views = [self.propagate(self.perturbed(
            None if noise_pair is None else noise_pair[v]), 1)[0]
            for v in range(2)]
        a = self.node_rows([views[0]], anchors)[0]
        c = self.node_rows([views[1]], columns)[0]
        return self.combine(batch, rows, a, c, masks)

    def forward_tables(self):
        return self.node_tables(self.propagate(first=1)[0])
