"""DropoutNet cold-start re-encoder (the port's copy of
``coldrec_tpu/models/dropoutnet.py``; reference: model/DropoutNet.py).

DeepCF two-tower (Linear -> BatchNorm(momentum .01, eps .001) -> tanh blocks,
DropoutNet.py:222-236) over [backbone emb ∥ content] for the cold-object
side and plain backbone emb for the other; training target = the backbone
pair scores of pos and neg pairs (MSE). The backbone tables are trainable
parameters (the reference registers them in its ParameterDict,
DropoutNet.py:13,96-100), with gradients through the tower inputs and the
undetached targets. Input dropout zeroes ``int(n * n_dropout)`` cold-side
embedding rows of each pass, n the padded batch (DropoutNet.py:110-121; as
in the JAX package). The rows are drawn from the trainer's generator on its
device, unless the loss is handed the masks (a test hands it the JAX
package's). BatchNorm statistics are weighted by the batch's real / pad
weights, and each tower's running statistics are updated twice a step (the
pos pass, then the neg pass). Eval re-encodes ALL users+items through the
towers in eval mode (running statistics). Linear init: truncated normal std
0.01, zero bias (DropoutNet.py:138-152).

On ``--mesh DxM`` (the JAX package runs the same loss as one program over
the global batch): the bus tables are row-sharded over the model axis and
read through the trainer's lookups; the loss is the parts (sum of se w,
sum of w) summed over the data group; the BatchNorm statistics are the
global batch's (``MaskedBatchNorm1d.group``); and every rank draws the two
permutations of the global batch from its generator, in the same state on
every rank, and keeps its own block of the masks. A ``1xM`` run is thus
bit-equal to one rank in deterministic mode.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from .cold_base import ColdStartModelBase
from .common import (
    JaxCarried, MaskedBatchNorm1d, linear_params_tn, linear_slots,
    table_param,
)

BN_MOMENTUM = 0.01
BN_EPS = 0.001


class Tower(nn.Module):
    """[Linear -> BatchNorm -> tanh] per hidden width, then a Linear."""

    def __init__(self, dims: Sequence[int], generator: torch.Generator):
        super().__init__()
        self.lins = nn.ModuleList(
            linear_params_tn(dims[i], dims[i + 1], generator)
            for i in range(len(dims) - 2))
        self.bns = nn.ModuleList(MaskedBatchNorm1d(d, BN_MOMENTUM, BN_EPS)
                                 for d in dims[1:-1])
        self.out = linear_params_tn(dims[-2], dims[-1], generator)

    def forward(self, x, weight: Optional[torch.Tensor] = None):
        for lin, bn in zip(self.lins, self.bns):
            x = torch.tanh(bn(lin(x), weight))
        return self.out(x)

    def slots(self, name: str, state_name: str) -> list:
        out = []
        for i, (lin, bn) in enumerate(zip(self.lins, self.bns)):
            out += linear_slots(lin, ("params", name, "blocks", i, "lin"))
            out += bn.slots(("params", name, "blocks", i, "bn"),
                            ("state", state_name, i))
        return out + linear_slots(self.out, ("params", name, "out"))

    @staticmethod
    def dims(tower: dict) -> list:
        ws = [b["lin"]["w"] for b in tower["blocks"]] + [tower["out"]["w"]]
        return [np.shape(ws[0])[0]] + [np.shape(w)[1] for w in ws]


class DropoutNet(JaxCarried, nn.Module):
    """The two towers and the (fine-tuned) backbone tables."""

    def __init__(self, u_dims, v_dims, user_emb, item_emb, seed: int = 2024,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        self.u_tower = Tower(u_dims, gen)
        self.v_tower = Tower(v_dims, gen)
        self.user_emb = table_param(user_emb)
        self.item_emb = table_param(item_emb)
        self.to(dev)

    def jax_slots(self) -> list:
        return ([(("params", "user_emb"), self.user_emb, False),
                 (("params", "item_emb"), self.item_emb, False)]
                + self.u_tower.slots("u_tower", "u")
                + self.v_tower.slots("v_tower", "v"))

    @staticmethod
    def jax_shapes(params: dict) -> dict:
        return {"u_dims": Tower.dims(params["u_tower"]),
                "v_dims": Tower.dims(params["v_tower"]),
                "user_emb": params["user_emb"],
                "item_emb": params["item_emb"]}


class DropoutNetTrainer(ColdStartModelBase):
    """``init_params`` / ``init_state`` (the JAX trainer's ``params`` and
    ``net_state`` as numpy) replace the seeded towers and the bus tables."""

    fused_ok = False  # BatchNorm state: stateful in the JAX package
    mesh_support = "sharded"

    def __init__(self, config, init_params: Optional[Dict] = None,
                 init_state: Optional[Dict] = None):
        super().__init__(config)
        backbone = self.load_backbone()
        self.content = self.cold_side_content
        d = self.emb_size
        h1 = int(self.args.dropoutnet_hidden1)
        h2 = int(self.args.dropoutnet_hidden2)
        self.n_dropout = float(self.args.n_dropout)
        cold_in = d + self.content_dim
        if self.args.cold_object == "item":
            u_dims, v_dims = [d, h1, h2, d], [cold_in, h1, h2, d]
        else:
            u_dims, v_dims = [cold_in, h1, h2, d], [d, h1, h2, d]
        self.model = self.init_module(
            DropoutNet, init_params, init_state, u_dims=u_dims,
            v_dims=v_dims, user_emb=backbone["user_emb"],
            item_emb=backbone["item_emb"])
        self.setup_optimizer()

    def draw_masks(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The pos and neg passes' row masks over a batch of ``n`` rows: 0
        on ``int(n * n_dropout)`` rows drawn without replacement, 1
        elsewhere."""
        n_zero = int(n * self.n_dropout)
        masks = []
        for _ in range(2):
            perm = torch.randperm(n, generator=self.generator,
                                  device=self.device)
            mask = torch.ones(n, device=self.device)
            mask[perm[:n_zero]] = 0.0
            masks.append(mask)
        return masks[0], masks[1]

    def _pair_scores(self, ue, ie, uid, iid, mask, weight):
        m = self.model
        if self.args.cold_object == "item":
            u_in = ue
            v_in = torch.cat([ie * mask[:, None], self.content[iid]], dim=1)
        else:
            u_in = torch.cat([ue * mask[:, None], self.content[uid]], dim=1)
            v_in = ie
        u_out = m.u_tower(u_in, weight)
        v_out = m.v_tower(v_in, weight)
        return (u_out * v_out).sum(dim=1)

    def loss(self, batch: Dict[str, torch.Tensor],
             masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> torch.Tensor:
        """The MSE of the towers' pair scores against the tables'. ``masks``
        (else drawn): the global batch's two row masks; this rank keeps its
        block of each."""
        if masks is None:
            masks = self.draw_masks(batch["user"].shape[0] * self.n_data)
        masks = tuple(self.data_block(m) for m in masks)
        u = self.lookup("user_emb", batch["user"])
        pos = self.lookup("item_emb", batch["pos_item"])
        neg = self.lookup("item_emb", batch["neg_item"])
        pos_target = (u * pos).sum(dim=1)
        neg_target = (u * neg).sum(dim=1)
        w = batch["weight"]
        pos_pred = self._pair_scores(u, pos, batch["user"], batch["pos_item"],
                                     masks[0], w)
        neg_pred = self._pair_scores(u, neg, batch["user"], batch["neg_item"],
                                     masks[1], w)
        se = (pos_pred - pos_target) ** 2 * w + (neg_pred - neg_target) ** 2 * w
        parts = self.reduce_parts(torch.stack([se.sum(), w.sum()]))
        return parts[0] / (2 * parts[1]).clamp_min(1.0)

    def forward_tables(self):
        m = self.model
        ue, ie = self.full_table("user_emb"), self.full_table("item_emb")
        if self.args.cold_object == "item":
            u_in = ue
            v_in = torch.cat([ie, self.content[: ie.shape[0]]], dim=1)
        else:
            u_in = torch.cat([ue, self.content[: ue.shape[0]]], dim=1)
            v_in = ie
        return m.u_tower(u_in), m.v_tower(v_in)
