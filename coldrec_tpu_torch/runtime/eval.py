"""Evaluation sweep: masked scoring + top-k retrieval, in PyTorch.

The port's counterpart of ``coldrec_tpu/runtime/eval.py``, which reimplements
the reference's ``_evaluate`` hot loop (ColdRec BaseRecommender.py:153-188):

  * scores for a chunk of users come from a score function (for factored
    models ``U[users] @ I.T`` in exact fp32);
  * training-rated items are masked to -10e8 (BaseRecommender.py:175-177);
  * cross-split candidate items are masked to -10e8 (BaseRecommender.py:179-181);
  * the top max_N items per user are the ranked list.

Tie order. The JAX package is id-exact with the reference's lowest-index rule
because ``lax.top_k`` returns equal values lowest index first. ``torch.topk``
promises no order among ties, so every top-k here goes through
:func:`stable_topk`, which selects and orders by (-value, index).

The kernel path (:meth:`EvalSweep.run_kernel`) sends the same sweep through
the hand-written retrieval kernel (``ops/cuda/retrieval.py``). Under a
process group the plain sweep's user chunks are split round robin over the
processes and their lists merged (the JAX package's ``_run_multiprocess``);
the kernel path sweeps every user on every rank, as ``run_pallas`` does.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.distributed import (
    allgather_host, is_multiprocess, partition_chunks,
)

MASK_VALUE = -10e8  # exact reference constant (BaseRecommender.py:177-180)


def exact_scores(users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """(B, d) x (I, d) -> (B, I) scores as exact fp32 products.

    TF32 is switched off for the product (it keeps about three decimal
    digits), as the id-exact contract with the JAX package needs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return users @ items.T


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k with ``lax.top_k``'s order: values descending, equal
    values lowest index first. Returns (values, int64 indices).

    ``torch.topk`` finds the k largest values; only where a tie crosses the
    cut (an entry left out equals the k-th value: the (k+1)-th largest
    does) can it have kept the wrong tied entries, and there the boundary
    rule takes every entry above the k-th value plus the lowest-index
    entries equal to it."""
    if k == 0:
        return torch.topk(x, 0, dim=1)
    cut = k < x.shape[1]  # some entry is left out
    vals, idx = torch.topk(x, k + cut, dim=1)
    crossed = vals[:, k] == vals[:, k - 1] if cut else None
    vals, idx = vals[:, :k], idx[:, :k]
    theta = vals[:, k - 1: k]
    if cut and bool(crossed.any()):
        rows = crossed.nonzero().squeeze(1)
        xr, th = x[rows], theta[rows]
        eq = xr == th
        need = k - (xr > th).sum(dim=1, keepdim=True)
        take = (xr > th) | (eq & (eq.cumsum(dim=1) <= need))
        sel = take.nonzero()[:, 1].view(-1, k)  # row-major: ascending ids
        idx[rows] = sel
        vals[rows] = xr.gather(1, sel)
    # ascending index first, then a stable sort by value descending
    idx, perm = idx.sort(dim=1)
    vals = vals.gather(1, perm)
    vals, perm = vals.sort(dim=1, descending=True, stable=True)
    return vals, idx.gather(1, perm)


def masked_topk(
    scores: torch.Tensor,  # (B, I)
    rated_pad: torch.Tensor,  # (B, R) item ids, pad = I
    excluded: torch.Tensor,  # (I,) bool: True = masked out of the candidate pool
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Overfetch-then-mask: take the top (k + R) candidates with only the
    dense candidate mask applied, then reject rated items among that small
    set. Exact: at most R rated items can occupy top slots, so the top
    (k + R) unmasked candidates always contain the masked top k."""
    b, n_items = scores.shape
    rated_pad = rated_pad.long()
    r = rated_pad.shape[1]
    masked = scores.masked_fill(excluded[None, :], MASK_VALUE)
    if (k + r) * r > n_items:
        # Heavy-rated regime: the (B, k+R, R) overfetch cube would outgrow
        # a direct scatter of the rated ids into a widened (B, I+1) mask
        # plane (pad id = I lands in the dummy column, reference
        # BaseRecommender.py:175-177), so take the plane.
        plane = torch.zeros((b, n_items + 1), dtype=torch.bool,
                            device=scores.device)
        plane.scatter_(1, rated_pad, True)
        masked = masked.masked_fill(plane[:, :n_items], MASK_VALUE)
        return _hierarchical_topk(masked, min(k, n_items))
    fetch = min(k + r, n_items)
    cand_vals, cand_idx = _hierarchical_topk(masked, fetch)  # (B, k+R)
    is_rated = (cand_idx[:, :, None] == rated_pad[:, None, :]).any(dim=-1)
    cand_vals = cand_vals.masked_fill(is_rated, MASK_VALUE)
    # lax.top_k over the candidates: lowest position first among ties
    vals, pos = cand_vals.sort(dim=1, descending=True, stable=True)
    vals, pos = vals[:, :k], pos[:, :k]
    return vals, cand_idx.gather(1, pos)


def _hierarchical_topk(masked: torch.Tensor, k: int):
    """The JAX package's two-stage top-k (segment-local top-k, then a
    re-rank of the segment winners) exists because one 270k-wide
    ``lax.top_k`` timed out the remote TPU compiler; its result is the flat
    top-k in (-value, index) order, which :func:`stable_topk` computes in
    one pass on any width."""
    return stable_topk(masked, k)


def mask_bias_vector(
    item_num: int, candidate_mask: Optional[np.ndarray]
) -> np.ndarray:
    """Boolean exclusion vector over the item space."""
    bias = np.zeros(item_num, dtype=bool)
    if candidate_mask is not None and candidate_mask.size:
        bias[candidate_mask] = True
    return bias


class EvalSweep:
    """Precomputed per-(split, setting) eval state + the chunked sweep."""

    def __init__(self, data, cold_object: str, batch_size: int, max_n: int,
                 device="cuda"):
        self.device = resolve_device(device)
        self.data = data
        self.cold_object = cold_object
        # cap the user-chunk width so the (B, I) score plane and its masking
        # intermediates stay bounded at book-crossing-scale item counts
        # (~2^28 fp32 elements per plane; a few planes are live at once)
        budget = max(64, (1 << 28) // max(int(data.item_num), 1))
        self.batch_size = min(int(batch_size), budget)
        self.max_n = int(max_n)
        self._cache: Dict[Tuple[str, str], dict] = {}

    def _prepare(self, split_name: str, data_type: str) -> dict:
        key = (split_name, data_type)
        if key in self._cache:
            return self._cache[key]
        es = self.data.eval_splits[split_name]
        users = es.users.astype(np.int32)
        n = users.shape[0]
        bs = self.batch_size
        n_chunks = max(1, -(-n // bs))
        padded_users = np.zeros(n_chunks * bs, dtype=np.int32)
        padded_users[:n] = users
        rated = self.data.rated_padded(padded_users)
        bias = mask_bias_vector(
            self.data.item_num,
            self.data.candidate_mask(self.cold_object, data_type),
        )
        rated = rated.reshape(n_chunks, bs, -1)
        # Per-chunk rated width, rounded up to a power of two; kept on the
        # host and uploaded one chunk at a time (the full upload tracks the
        # most prolific user and reached ~9 GB at the XING statistics).
        counts = (rated != self.data.item_num).sum(axis=2).max(axis=1)
        widths = [
            min(int(1 << max(int(c) - 1, 0).bit_length()) if c else 1,
                rated.shape[2])
            for c in counts
        ]
        state = {
            "split": es,
            "n_users": n,
            "user_chunks": padded_users.reshape(n_chunks, bs),
            "rated_chunks": rated,
            "rated_widths": widths,
            "bias": torch.as_tensor(bias, device=self.device),
        }
        self._cache[key] = state
        return state

    def _rated_chunk(self, st, c: int) -> torch.Tensor:
        """This chunk's rated ids, width-trimmed to its bucket."""
        return torch.as_tensor(
            st["rated_chunks"][c][:, : st["rated_widths"][c]],
            device=self.device,
        )

    def run(
        self,
        split_name: str,
        data_type: str,
        score_fn: Callable[[np.ndarray], torch.Tensor],
    ) -> np.ndarray:
        """Return (n_users, max_n) ranked recommended item ids (mapped),
        scoring each chunk with ``score_fn(user_ids) -> (bs, I)`` on the
        sweep's device. Under a process group each process scores its
        round-robin share of the chunks and one all-gather merges the
        lists."""
        st = self._prepare(split_name, data_type)
        if is_multiprocess():
            return self._run_multiprocess(st, score_fn)
        outs = []
        for c in range(st["user_chunks"].shape[0]):
            scores = score_fn(st["user_chunks"][c])
            _, idx = masked_topk(
                scores, self._rated_chunk(st, c), st["bias"], self.max_n
            )
            outs.append(idx)
        rec = torch.cat(outs, dim=0)[: st["n_users"]]
        return rec.cpu().numpy()

    def _run_multiprocess(self, st, score_fn) -> np.ndarray:
        n_chunks = st["user_chunks"].shape[0]
        mine, pc, _ = partition_chunks(n_chunks)
        slots = -(-n_chunks // pc)  # equal per-process slot count
        bs = st["user_chunks"].shape[1]
        local = np.zeros((slots, bs, self.max_n), np.int64)
        for slot, c in enumerate(mine):
            scores = score_fn(st["user_chunks"][c])
            _, idx = masked_topk(
                scores, self._rated_chunk(st, c), st["bias"], self.max_n
            )
            local[slot] = idx.cpu().numpy()
        gathered = allgather_host(local)  # (pc, slots, bs, max_n)
        rec = np.concatenate(
            [gathered[c % pc, c // pc] for c in range(n_chunks)], axis=0
        )
        return rec[: st["n_users"]]

    def kernel_supported(self, split_name: str, data_type: str) -> bool:
        """The kernel emits SLOTS*LANES candidates per user; the
        overfetch-then-reject scheme is exact only while k + rated_width
        fits in that stream."""
        from ..ops.cuda.retrieval import CANDIDATES

        st = self._prepare(split_name, data_type)
        return self.max_n + max(st["rated_widths"]) <= CANDIDATES

    def run_kernel(
        self,
        split_name: str,
        data_type: str,
        user_emb: torch.Tensor,
        item_emb: torch.Tensor,
        bf16: bool = False,
    ) -> np.ndarray:
        """Same sweep through the retrieval kernel (on the CPU: its plain
        version); ``bf16`` takes the kernel's bf16 mode."""
        from ..ops.cuda.retrieval import retrieval_topk

        st = self._prepare(split_name, data_type)
        users = st["user_chunks"].reshape(-1)[: st["n_users"]]
        width = max(st["rated_widths"])
        rated = st["rated_chunks"][:, :, :width].reshape(-1, width)[
            : st["n_users"]
        ]
        ue = user_emb[torch.as_tensor(users, device=user_emb.device).long()]
        _, ids = retrieval_topk(
            ue, item_emb, rated, st["bias"], self.max_n, device=self.device,
            bf16=bf16,
        )
        return ids
