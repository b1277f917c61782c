"""Online retrieval serving over trained embedding tables.

The port's counterpart of ``coldrec_tpu/runtime/serving.py`` (single-device
branch). :class:`RetrievalServer` loads one npz checkpoint-bus artifact (the
tables every model's ``save_emb`` writes — checkpoints.py), keeps them on the
device, and answers exclusion-masked top-k queries through the retrieval
kernel (ops/cuda/retrieval.py), the same path as evaluation, so served lists
are id-exact against the offline protocol, lowest-index tie rule included.

Users whose rated list does not fit the kernel's candidate stream
(k + R > 1024) go through the exact ``masked_topk`` path. The JAX package
also sent item spaces under 256 items there when off the TPU; on CUDA every
supported case goes through the kernel.

With a ``mesh`` (``parallel/mesh.py``), the item table is padded to a
multiple of the model axis with excluded pad rows and each rank keeps its
row block; queries go through ``parallel.ops.sharded_retrieval_topk`` (the
kernel over each rank's block, the candidates and ghosts all-gathered and
merged) and every rank of the group calls ``topk`` with the same users.
Ids at or past the real item count map to the pad id ``n_items``.

Plain-python host API: inputs are mapped user ids (or raw ids when the
server is built with the dataset), outputs are numpy arrays.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cuda.retrieval import CANDIDATES, retrieval_topk
from ..parallel.ops import pad_rows, shard_rows, sharded_retrieval_topk
from .eval import exact_scores, mask_bias_vector, masked_topk


class RetrievalServer:
    """Masked top-k retrieval over fixed (user_emb, item_emb) tables.

    Parameters
    ----------
    user_emb, item_emb : (U, d) / (I, d) float arrays or tensors.
    dataset : optional ColdStartDataset. When given, queries may use RAW
        user ids, results may be returned as RAW item ids, and
        ``exclude_rated=True`` masks each user's training interactions
        (the reference eval protocol's rated mask, BaseRecommender.py:175-177).
    exclude_items : optional int array of mapped item ids globally removed
        from the candidate pool (BaseRecommender.py:130-143).
    device : where the tables live and the kernel runs.
    mesh : optional :class:`~coldrec_tpu_torch.parallel.mesh.Mesh`; shards
        the item table over its model axis.
    """

    def __init__(
        self,
        user_emb,
        item_emb,
        dataset=None,
        exclude_items: Optional[np.ndarray] = None,
        device="cuda",
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.data = dataset
        self.mesh = mesh
        self.user_emb = torch.as_tensor(
            user_emb, dtype=torch.float32, device=self.device
        )
        self.n_users, self.d = self.user_emb.shape
        self.n_items = int(item_emb.shape[0])
        bias = mask_bias_vector(self.n_items, exclude_items)
        if mesh is not None:
            items = pad_rows(torch.as_tensor(item_emb, dtype=torch.float32)
                             .cpu().numpy(), mesh.n_model)
            # pad rows are excluded so they can never be recommended
            bias_p = np.ones(items.shape[0], dtype=bool)
            bias_p[: self.n_items] = bias
            item_emb, bias = (shard_rows(mesh, items),
                              shard_rows(mesh, bias_p))
        self.item_emb = torch.as_tensor(
            item_emb, dtype=torch.float32, device=self.device
        )
        self.bias = torch.as_tensor(bias, device=self.device)

    @classmethod
    def from_checkpoint(
        cls,
        emb_dir: str,
        dataset_name: str,
        cold_object: str,
        model: str,
        dataset=None,
        exclude_items: Optional[np.ndarray] = None,
        device="cuda",
        mesh=None,
    ) -> "RetrievalServer":
        """Build from the npz checkpoint bus."""
        from .checkpoints import load_embeddings

        t = load_embeddings(emb_dir, dataset_name, cold_object, model)
        return cls(
            t["user_emb"], t["item_emb"],
            dataset=dataset, exclude_items=exclude_items, device=device,
            mesh=mesh,
        )

    def _rated(self, uids: np.ndarray, exclude_rated: bool) -> np.ndarray:
        if exclude_rated and self.data is not None:
            return self.data.rated_padded(uids.astype(np.int32))
        # pad id == n_items: matches no real item
        return np.full((uids.shape[0], 1), self.n_items, np.int32)

    def topk(
        self,
        user_ids,
        k: int,
        exclude_rated: bool = True,
        raw_ids: bool = False,
        bf16: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k (scores, item_ids) for a batch of users.

        ``raw_ids=True`` (requires ``dataset``) maps raw user ids in and raw
        item ids out (the pad id maps to -1). ``bf16=True``: the kernel's
        bf16 mode, the exact top-k of the bf16-rounded scores (heavy-rated
        users still take the exact fp32 sweep, as in the JAX package).
        Under a mesh every rank of the group calls this with the same
        users; there is no bf16 mode and no heavy-rated sweep there, as in
        the JAX package's sharded path (both raise)."""
        uids = np.asarray(user_ids)
        if raw_ids:
            if self.data is None:
                raise ValueError("raw_ids=True requires dataset")
            uids = self.data.map_users(uids)
        uids = uids.astype(np.int64)
        rated = self._rated(uids, exclude_rated)
        k_eff = min(k, self.n_items)
        ue = self.user_emb[torch.as_tensor(uids, device=self.device)]
        if self.mesh is not None:
            if bf16:
                raise ValueError("the sharded sweep has no bf16 mode")
            vals, ids = sharded_retrieval_topk(
                self.mesh, ue, self.item_emb, rated, self.bias, k_eff)
            ids = np.where(ids >= self.n_items, self.n_items, ids)
        elif k_eff + rated.shape[1] <= CANDIDATES:
            vals, ids = retrieval_topk(
                ue, self.item_emb, rated, self.bias, k_eff,
                device=self.device, bf16=bf16,
            )
        else:  # heavy-rated users: exact sweep
            v, i = masked_topk(
                exact_scores(ue, self.item_emb),
                torch.as_tensor(rated, device=self.device), self.bias, k_eff,
            )
            vals, ids = v.cpu().numpy(), i.cpu().numpy()
        if raw_ids:
            id2item = np.concatenate([self.data.id2item, [-1]])
            ids = id2item[ids]
        return vals, ids
