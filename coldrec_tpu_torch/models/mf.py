"""BPR-MF warm backbone (the port's counterpart of
``coldrec_tpu/models/mf.py``; reference: ColdRec model/MF.py).

``MF`` holds the two xavier-initialized embedding tables, their score
function and the BPR + L2 loss of a batch, written as additive partial
sums (``loss_parts``) and the loss made of them, so that a batch split over
the data axis of a mesh sums its parts before the loss; ``MFTrainer``
trains it with Adam in the shared warm-backbone loop and writes the best
tables to the embedding bus (MF.py:44-46). Under ``--mesh DxM`` the tables
whose height divides M are row-sharded and looked up through
``parallel.ops.sharded_lookup`` (``WarmBackboneTrainer.lookup``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.losses import bpr_l2_from_parts, bpr_l2_parts
from .common import xavier_uniform
from .warm_base import WarmBackboneTrainer


class MF(nn.Module):
    """Two xavier-initialized embedding tables; score = U V^T."""

    def __init__(
        self,
        user_num: int,
        item_num: int,
        emb_size: int = 64,
        seed: int = 2024,
        device="cuda",
    ):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        self.user_emb = nn.Parameter(
            xavier_uniform((user_num, emb_size), gen, dev)
        )
        self.item_emb = nn.Parameter(
            xavier_uniform((item_num, emb_size), gen, dev)
        )

    @classmethod
    def from_jax_params(
        cls, params: Dict[str, np.ndarray], device="cuda"
    ) -> "MF":
        """MF holding exactly the JAX package's ``MF.params`` tables (numpy
        arrays, e.g. ``{k: np.asarray(v) for k, v in jax_mf.params.items()}``):
        the weight carrier between the two packages."""
        ue = np.asarray(params["user_emb"], np.float32)
        ie = np.asarray(params["item_emb"], np.float32)
        m = cls(ue.shape[0], ie.shape[0], ue.shape[1], device=device)
        with torch.no_grad():
            m.user_emb.copy_(torch.tensor(ue))
            m.item_emb.copy_(torch.tensor(ie))
        return m

    def forward_tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eval-ready (user_emb, item_emb) tables."""
        return self.user_emb, self.item_emb

    def loss_parts(self, batch: Dict[str, torch.Tensor],
                   lookup=None) -> torch.Tensor:
        """``bpr_l2_parts`` of a padded batch {user, pos_item, neg_item,
        weight}; ``lookup(name, ids)`` gathers a table's rows (default: plain
        indexing of this module's tables)."""
        if lookup is None:
            def lookup(name, ids):
                return getattr(self, name)[ids]
        return bpr_l2_parts(lookup("user_emb", batch["user"]),
                            lookup("item_emb", batch["pos_item"]),
                            lookup("item_emb", batch["neg_item"]),
                            batch["weight"])

    def loss(self, batch: Dict[str, torch.Tensor], reg: float) -> torch.Tensor:
        """BPR + L2 of a padded batch {user, pos_item, neg_item, weight}."""
        return bpr_l2_from_parts(self.loss_parts(batch), reg)


class MFTrainer(WarmBackboneTrainer):
    """MF trained with BPR + L2 and Adam. ``init_params`` (numpy tables
    keyed ``user_emb`` / ``item_emb``, e.g. the JAX package's ``MF.params``)
    replaces the seeded initial tables."""

    mesh_support = "sharded"

    def __init__(self, config, init_params: Optional[Dict] = None):
        super().__init__(config)
        if init_params is None:
            self.model = MF(self.data.user_num, self.data.item_num,
                            self.emb_size, seed=self.seed, device=self.device)
        else:
            shapes = {k: np.shape(init_params[k])
                      for k in ("user_emb", "item_emb")}
            want = {"user_emb": (self.data.user_num, self.emb_size),
                    "item_emb": (self.data.item_num, self.emb_size)}
            if shapes != want:
                raise ValueError(f"init_params shapes {shapes} != {want}")
            self.model = MF.from_jax_params(init_params, device=self.device)
        self.setup_optimizer()

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        parts = self.model.loss_parts(batch, self.lookup)
        return bpr_l2_from_parts(self.reduce_parts(parts), self.reg)

    def forward_tables(self):
        return self.full_table("user_emb"), self.full_table("item_emb")
