"""XSimGCL warm backbone (the port's copy of
``coldrec_tpu/models/xsimgcl.py``; reference: model/XSimGCL.py).

A single perturbed forward returns both the final (mean over layers 1..L)
embeddings and a snapshot at layer l_cl; CL is InfoNCE between the two
(XSimGCL.py:106-124, 58-63): one perturbed forward a step, not SimGCL's
three. Requires 1 <= l_cl <= layers (XSimGCL.py:14-18). The noise comes
from the trainer's device generator, or is injected (``noise=``). On a
mesh, as SimGCL (``simgcl.py``): the whole noise plane drawn on every
rank, the InfoNCE's anchors this rank's data block of the global batch's
unique ids, its columns all of them; the batch and InfoNCE rows come from
one exchange lookup of the mean and snapshot blocks side by side.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .simgcl import ContrastiveTrainer


class XSimGCLTrainer(ContrastiveTrainer):
    def check_flags(self):
        self.layer_cl = int(self.args.l_cl)
        if not (1 <= self.layer_cl <= self.n_layers):
            raise ValueError(
                "XSimGCL requires 1 <= l_cl <= layers; "
                f"got l_cl={self.layer_cl}, layers={self.n_layers}.")

    def forward(self, perturbed: bool, noise=None):
        """(mean, snapshot) node tables (node blocks on the mesh graph);
        clean unless ``perturbed``. ``noise``, an (L, U+I, d) stack of
        U(0,1) draws, overrides the generator (XSimGCL.py:112-114)."""
        hook = self.perturbed(noise) if perturbed else None
        mean, layers = self.propagate(hook, 1)
        return mean, layers[self.layer_cl]

    def loss(self, batch: Dict[str, torch.Tensor],
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        anchors, columns, masks = self.cl_groups(batch)
        mean, snap = self.forward(True, noise)
        groups = self.batch_groups(batch)
        rows = self.node_rows([mean, snap], groups + anchors + columns)
        mean_rows, snap_rows = rows[0], rows[1][len(groups) + 2:]
        return self.combine(batch, mean_rows[:3], mean_rows[3:5], snap_rows,
                            masks)

    def forward_tables(self):
        return self.node_tables(self.forward(False)[0])
