"""Fused retrieval: the hand-written CUDA sweep, its plain version, and the
host logic that turns its candidates into exact top-k lists.

The port's counterpart of ``coldrec_tpu/ops/pallas/retrieval.py``. The
kernel (``coldrec_tpu_torch/csrc/retrieval.cu``) replaces the Pallas
``_fused_kernel``: it scores every user against every item in fp32, applies
the candidate-exclusion byte, and keeps for each user and lane class
(item id mod 128) the sorted top-SLOTS (value, id) plus a "ghost", the
largest value it discarded. It never writes the (B, I) score plane.

Output contract (the same layout as the TPU kernel, so ``_resolve``,
``EvalSweep.kernel_supported`` and the serving guard keep their meaning):
``cand_v``/``cand_i`` are (B, SLOTS*LANES) with column ``s*LANES + c``
holding slot ``s`` of lane class ``c``; ``ghost`` is (B, LANES). Every item
that is not among a user's candidates scores <= that user's max ghost. The
CUDA kernel keeps each class's exact top-SLOTS (ties: lowest id first), a
tighter candidate set than the TPU kernel's block-local top-2; the final
lists are the same after the exactness flags and the fallback.

Exactness (as in the JAX package): with theta the k-th best candidate after
rated items are rejected, a row whose max ghost is below theta, and where no
tie crosses the cut, holds the exact top-k; every other row is recomputed by
the exact ``masked_topk`` path in bounded chunks.

``fused_sweep`` launches the kernel for CUDA tensors and counts each launch
in ``fused_sweep.launches``; for CPU tensors it computes the plain version
``fused_sweep_reference``. It never falls back from a CUDA tensor.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...runtime.eval import exact_scores, masked_topk
from .build import launch

NEG = -10e8  # reference mask value (BaseRecommender.py:177-180)
INIT_NEG = -4e9  # below NEG: masked items still rank above "nothing seen"
LANES = 128  # one lane class per item_id mod 128
SLOTS = 8  # sorted top-SLOTS kept per lane class
CANDIDATES = SLOTS * LANES
USER_CHUNK = 2048  # users per kernel launch in retrieval_topk
REFERENCE_CHUNK = 256  # users per score plane in fused_sweep_reference
FALLBACK_CHUNK = 4096  # rows per exact-fallback chunk (bounds the score plane)


def _check_sweep_inputs(users, items_t, excl, name="fused_sweep"):
    if users.dtype == torch.bfloat16 or items_t.dtype == torch.bfloat16:
        raise NotImplementedError("bf16 retrieval is not in the port yet")
    if users.dtype != torch.float32 or items_t.dtype != torch.float32:
        raise TypeError(
            f"{name} takes float32 tables, got {users.dtype}/{items_t.dtype}"
        )
    if excl.dtype != torch.int8:
        raise TypeError(f"excl must be int8, got {excl.dtype}")
    if users.dim() != 2 or items_t.dim() != 2 or excl.dim() != 1:
        raise ValueError("users (B, d), items_t (d, I_pad), excl (I_pad,)")
    d, i_pad = items_t.shape
    if users.shape[1] != d:
        raise ValueError(f"users width {users.shape[1]} != items_t rows {d}")
    if i_pad % LANES or excl.shape[0] != i_pad:
        raise ValueError(
            f"I_pad={i_pad} must be a multiple of {LANES} and match excl "
            f"({excl.shape[0]})"
        )
    if not (users.device == items_t.device == excl.device):
        raise ValueError("users, items_t and excl must be on one device")
    if not (users.is_contiguous() and items_t.is_contiguous()
            and excl.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")


def empty_candidates(b: int, device):
    """Uninitialised (cand_v, cand_i, ghost) outputs for ``b`` users."""
    return (
        torch.empty((b, CANDIDATES), dtype=torch.float32, device=device),
        torch.empty((b, CANDIDATES), dtype=torch.int32, device=device),
        torch.empty((b, LANES), dtype=torch.float32, device=device),
    )


def fused_sweep(
    users: torch.Tensor,  # (B, d) f32
    items_t: torch.Tensor,  # (d, I_pad) f32, pre-transposed item table
    excl: torch.Tensor,  # (I_pad,) int8, nonzero = candidate-excluded
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cand_v (B, 1024) f32, cand_i (B, 1024) i32, ghost (B, 128) f32)."""
    _check_sweep_inputs(users, items_t, excl)
    if users.device.type == "cpu":
        return fused_sweep_reference(users, items_t, excl)
    if users.device.type != "cuda":
        raise ValueError(f"no retrieval kernel for device {users.device}")
    b, d = users.shape
    i_pad = items_t.shape[1]
    cand_v, cand_i, ghost = empty_candidates(b, users.device)
    launch("coldrec_fused_sweep", users.device,
           users.data_ptr(), items_t.data_ptr(), excl.data_ptr(),
           cand_v.data_ptr(), cand_i.data_ptr(), ghost.data_ptr(),
           b, d, i_pad)
    fused_sweep.launches += 1
    return cand_v, cand_i, ghost


fused_sweep.launches = 0


def fused_sweep_reference(
    users: torch.Tensor,
    items_t: torch.Tensor,
    excl: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's contract, in user chunks:
    score (exact fp32), mask, view as (B, I_pad/128, 128) lane classes, a
    stable descending sort per class (ties: lowest id first), the top
    SLOTS as candidates and the next value as the ghost."""
    b = users.shape[0]
    groups = items_t.shape[1] // LANES
    dev = users.device
    cand_v = torch.full((b, SLOTS, LANES), INIT_NEG, dtype=torch.float32,
                        device=dev)
    cand_i = torch.zeros((b, SLOTS, LANES), dtype=torch.int32, device=dev)
    ghost = torch.full((b, LANES), INIT_NEG, dtype=torch.float32, device=dev)
    lane = torch.arange(LANES, dtype=torch.int64, device=dev)
    top = min(SLOTS, groups)
    excluded = excl.bool()[None, :]
    for s in range(0, b, REFERENCE_CHUNK):
        e = min(b, s + REFERENCE_CHUNK)
        z = exact_scores(users[s:e], items_t.T).masked_fill(excluded, NEG)
        v, g = z.view(e - s, groups, LANES).sort(
            dim=1, descending=True, stable=True
        )
        cand_v[s:e, :top] = v[:, :top]
        cand_i[s:e, :top] = (g[:, :top] * LANES + lane).to(torch.int32)
        if groups > SLOTS:
            ghost[s:e] = v[:, SLOTS]
    return cand_v.view(b, CANDIDATES), cand_i.view(b, CANDIDATES), ghost


def _resolve(cand_v, cand_i, ghost, rated, k: int):
    """Reject rated candidates, take the top-k, and flag rows whose result
    the candidates cannot certify.

    Membership is a broadcast equality reduce over (B, SLOTS*128, R). The
    selection is a stable sort (lowest candidate position first among ties,
    as the JAX package's masked argmax passes). A row is flagged when its
    max ghost reaches theta, or when more candidates tie with theta than
    the selection kept; both flags are permutation-invariant, and the
    (-value, id) order is applied on the host (``_torch_tie_order``)."""
    is_rated = (cand_i[:, :, None] == rated[:, None, :]).any(dim=-1)
    cand_v = cand_v.masked_fill(is_rated, INIT_NEG)
    vals, pos = cand_v.sort(dim=1, descending=True, stable=True)
    vals, pos = vals[:, :k], pos[:, :k]
    ids = cand_i.gather(1, pos)
    theta = vals[:, k - 1: k]
    n_eq_total = (cand_v == theta).sum(dim=1)
    n_eq_kept = (vals == theta).sum(dim=1)
    suspicious = (ghost.max(dim=1).values >= theta[:, 0]) | (
        n_eq_total > n_eq_kept
    )
    return vals, ids, suspicious


def _torch_tie_order(vals: np.ndarray, ids: np.ndarray):
    """Host-side (-value, id) reorder of each row — torch.topk's tie rule on
    the reference's CPU path. vals arrive descending, so this only permutes
    within equal-value runs."""
    order = np.lexsort((ids, -vals), axis=-1)
    return (
        np.take_along_axis(vals, order, axis=1),
        np.take_along_axis(ids, order, axis=1),
    )


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def apply_exact_fallback(vals, ids, sus, exact_chunk_fn, chunk=FALLBACK_CHUNK):
    """Recompute flagged rows via ``exact_chunk_fn(rows_pad)`` in fixed-size
    chunks, scattering results back into (vals, ids) in place.

    Chunking bounds memory when a degenerate score distribution flags every
    row at once (one 4096-row chunk at 270,170 items is a 4.4 GB plane).
    Padding policy (as in the JAX package): row counts below ``chunk`` round
    up to a multiple of 8, larger counts to whole chunks."""
    rows = np.flatnonzero(sus)
    if rows.size == 0:
        return
    n_pad = _round_up(rows.size, 8 if rows.size < chunk else chunk)
    rows_pad = np.zeros(n_pad, np.int64)
    rows_pad[: rows.size] = rows
    fvs, fis = [], []
    for s in range(0, n_pad, chunk):
        fv, fi = exact_chunk_fn(rows_pad[s: s + chunk])
        fvs.append(np.asarray(fv))
        fis.append(np.asarray(fi))
    vals[rows] = np.concatenate(fvs)[: rows.size]
    ids[rows] = np.concatenate(fis)[: rows.size]


def _exact_rows(users_rows, items, rated_rows, excluded, k: int):
    """Exact masked top-k for fallback rows (fp32 products, TF32 off)."""
    v, i = masked_topk(exact_scores(users_rows, items), rated_rows, excluded, k)
    return v.cpu().numpy(), i.cpu().numpy()


def pad_items(item_emb: torch.Tensor, excluded: torch.Tensor):
    """The kernel's item operands: the (d, I_pad) transposed table, padded
    to a multiple of 128 items with zeros, and the (I_pad,) int8 exclusion
    row, whose pad entries are set so a pad item can never be a result."""
    n_items, d = item_emb.shape
    i_pad = _round_up(n_items, LANES)
    items_t = torch.zeros((d, i_pad), dtype=torch.float32,
                          device=item_emb.device)
    items_t[:, :n_items] = item_emb.T
    excl_row = torch.ones(i_pad, dtype=torch.int8, device=item_emb.device)
    excl_row[:n_items] = excluded.to(torch.int8)
    return items_t, excl_row


def retrieval_topk(
    user_emb,  # (U, d)
    item_emb,  # (I, d)
    rated_pad,  # (U, R) padded rated ids (pad = I)
    excluded,  # (I,) bool
    k: int,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Full masked top-k sweep; returns numpy (vals (U, k), ids (U, k)),
    exact and in (-value, id) order. Takes numpy arrays or tensors; tensors
    already on ``device`` are used in place."""
    dev = resolve_device(device)
    ue = torch.as_tensor(user_emb, dtype=torch.float32, device=dev)
    ie = torch.as_tensor(item_emb, dtype=torch.float32, device=dev)
    rated = torch.as_tensor(rated_pad, device=dev).long()
    excl = torch.as_tensor(excluded, device=dev).bool()
    n_users = ue.shape[0]
    if k + rated.shape[1] > CANDIDATES:
        raise ValueError(
            f"k + rated width = {k + rated.shape[1]} exceeds the kernel's "
            f"{CANDIDATES} candidates; use masked_topk"
        )
    if n_users == 0:
        return np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
    items_t, excl_row = pad_items(ie, excl)
    vals_l, ids_l, sus_l = [], [], []
    for s in range(0, n_users, USER_CHUNK):
        e = min(n_users, s + USER_CHUNK)
        cv, ci, gh = fused_sweep(ue[s:e].contiguous(), items_t, excl_row)
        v, i, sus = _resolve(cv, ci, gh, rated[s:e], k)
        vals_l.append(v.cpu().numpy())
        ids_l.append(i.cpu().numpy())
        sus_l.append(sus.cpu().numpy())
    vals, ids = _torch_tie_order(
        np.concatenate(vals_l), np.concatenate(ids_l)
    )

    def exact_chunk(rows_pad):
        rows_d = torch.as_tensor(rows_pad, device=dev)
        return _exact_rows(ue[rows_d], ie, rated[rows_d], excl, k)

    apply_exact_fallback(vals, ids, np.concatenate(sus_l), exact_chunk)
    return vals, ids
