"""Shared machinery of the cold-start models (the port's copy of
``coldrec_tpu/models/cold_base.py``).

The reference's cold-start models share three patterns (SURVEY §2.3):

  (a) "generator" models map content -> embedding space and overwrite the
      cold rows of the item/user table at eval time (GAR.py:44-49,
      DeepMusic.py:42-47, ...);
  (b) "re-encoder" models re-encode all users+items through a content-aware
      tower (DropoutNet.py:126-135, Heater.py:127-136);
  (c) "joint" models train their own tables with content paths inline.

This base extends the shared epoch loop with: backbone tables read from the
embedding bus onto the trainer's device, the cold-object side's content
matrix as a device tensor, the cold / warm ids, and the cold-row patch that
every generator uses.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..runtime.checkpoints import load_embeddings
from .warm_base import WarmBackboneTrainer


class ColdStartModelBase(WarmBackboneTrainer):
    def load_backbone(
        self, model: str = None, required=("user_emb", "item_emb")
    ) -> Dict[str, torch.Tensor]:
        """The backbone's tables from the bus, on the trainer's device (e.g.
        DeepMusic.py:107-114). A missing bus raises ``FileNotFoundError``
        naming the npz."""
        tensors = load_embeddings(
            self.args.emb_dir,
            self.dataset_name,
            self.args.cold_object,
            model or self.args.backbone,
            required=required,
        )
        return {k: torch.as_tensor(np.asarray(v, np.float32),
                                   device=self.device)
                for k, v in tensors.items()}

    # ------------------------------------------------------------- content
    @functools.cached_property
    def cold_side_content(self) -> torch.Tensor:
        """(N, c) content matrix of the cold-object side (mapped order; N
        may exceed the entity count: ``ColdStartDataset`` pads the remap)."""
        if self.args.cold_object == "item":
            content = self.data.item_content
        else:
            content = self.data.user_content
        if content is None:
            raise ValueError(
                f"{self.model_name} requires {self.args.cold_object} content"
            )
        return torch.as_tensor(content, dtype=torch.float32,
                               device=self.device)

    @property
    def content_dim(self) -> int:
        return int(self.cold_side_content.shape[1])

    def _ids(self, ids: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    @functools.cached_property
    def cold_idx(self) -> torch.Tensor:
        """Mapped ids of the cold-side entities."""
        if self.args.cold_object == "item":
            return self._ids(self.data.mapped_cold_item_idx)
        return self._ids(self.data.mapped_cold_user_idx)

    @functools.cached_property
    def warm_idx(self) -> torch.Tensor:
        if self.args.cold_object == "item":
            return self._ids(self.data.mapped_warm_item_idx)
        return self._ids(self.data.mapped_warm_user_idx)

    # ------------------------------------------------------------ patching
    def patch_cold_rows(
        self,
        user_emb: torch.Tensor,
        item_emb: torch.Tensor,
        generated: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The tables with the cold rows of the cold-object side replaced by
        ``generated`` (a new tensor; the shared generator eval prologue,
        e.g. GAR.py:44-49)."""
        if self.args.cold_object == "item":
            return user_emb, item_emb.index_put((self.cold_idx,), generated)
        return user_emb.index_put((self.cold_idx,), generated), item_emb

    def require_item_cold(self):
        """Guard for item-only models (e.g. CLCRec.py:12-13, ALDI.py:28-31)."""
        if self.args.cold_object != "item":
            raise ValueError(
                f"{self.model_name} only supports item cold-start "
                f"(got cold_object={self.args.cold_object})"
            )
