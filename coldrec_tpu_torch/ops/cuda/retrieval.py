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

A score that is NaN never enters a slot (the TPU kernel's strict
compares drop it the same way), and it turns its lane class's ghost into
NaN for good, as the TPU kernel's ``jnp.maximum`` does. ``_resolve`` then
never flags the row on its ghost (``NaN >= theta`` is false), as in the
JAX package. A score at or below ``INIT_NEG`` enters neither. Unfilled
slots hold (``INIT_NEG``, 0).

The kernel splits the item range into parts on 128-item boundaries, as
many as fill the card's SMs for the batch (``sweep_parts``), and a second
kernel merges the parts' slots (``merge_parts``): per (user, class) the
sorted top-SLOTS of the union, and as ghost the max of the parts' ghosts
and of the values the merge drops.

bf16 mode (the JAX package's ``bf16=True``, ``--eval_backend
pallas_bf16``): ``fused_sweep`` takes bfloat16 tables (``items_t`` and
``excl`` 16-byte aligned) and launches the bf16 kernel, which multiplies
them on the tensor cores (bf16 operands, fp32 accumulators: products exact,
sums in the tensor cores' order, as the TPU's matrix unit sums them);
``retrieval_topk(bf16=True)`` rounds the tables to bf16 on the device and
scores its exact fallback on the same rounded operands, so the lists are
the exact top-k of the bf16-rounded scores.

``fused_sweep`` and ``merge_parts`` launch their kernels for CUDA tensors
and count each launch (``fused_sweep.launches`` for fp32 tables and
``fused_sweep.launches_bf16`` for bf16 ones, once per sweep;
``merge_parts.launches``); for CPU tensors they compute the plain versions
``fused_sweep_reference`` (on bf16 tables: widened to fp32, which is
exact) and ``merge_parts_reference``. They never fall back from a CUDA
tensor.
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...runtime.eval import exact_scores, masked_topk
from .build import launch, sweep_parts

NEG = -10e8  # reference mask value (BaseRecommender.py:177-180)
INIT_NEG = -4e9  # below NEG: masked items still rank above "nothing seen"
LANES = 128  # one lane class per item_id mod 128
SLOTS = 8  # sorted top-SLOTS kept per lane class
CANDIDATES = SLOTS * LANES
USER_CHUNK = 2048  # users per kernel launch in retrieval_topk
REFERENCE_CHUNK = 256  # users per score plane in fused_sweep_reference
FALLBACK_CHUNK = 4096  # rows per exact-fallback chunk (bounds the score plane)


def _check_sweep_inputs(users, items_t, excl, name="fused_sweep",
                        dtypes=(torch.float32,)):
    if users.dtype not in dtypes or items_t.dtype != users.dtype:
        kinds = " or ".join(str(t).split(".")[-1] for t in dtypes)
        raise TypeError(
            f"{name} takes {kinds} tables of one type, got "
            f"{users.dtype}/{items_t.dtype}"
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
    users: torch.Tensor,  # (B, d) f32 or bf16
    items_t: torch.Tensor,  # (d, I_pad), pre-transposed item table, as users
    excl: torch.Tensor,  # (I_pad,) int8, nonzero = candidate-excluded
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cand_v (B, 1024) f32, cand_i (B, 1024) i32, ghost (B, 128) f32)."""
    _check_sweep_inputs(users, items_t, excl,
                        dtypes=(torch.float32, torch.bfloat16))
    if users.device.type == "cpu":
        return fused_sweep_reference(users.float(), items_t.float(), excl)
    if users.device.type != "cuda":
        raise ValueError(f"no retrieval kernel for device {users.device}")
    bf16 = users.dtype == torch.bfloat16
    if bf16 and (items_t.data_ptr() % 16 or excl.data_ptr() % 16):
        raise ValueError(
            "the bf16 sweep takes 16-byte aligned items_t and excl")
    name = "coldrec_fused_sweep_bf16" if bf16 else "coldrec_fused_sweep"
    b, d = users.shape
    i_pad = items_t.shape[1]
    parts = sweep_parts(f"{name}_parts", users.device, b, d, i_pad)
    # one part writes the result; more write (parts, B, ...) scratch
    out = tuple(t.view(parts, b, t.shape[1]) if parts > 1 else t
                for t in empty_candidates(parts * b, users.device))
    launch(name, users.device,
           users.data_ptr(), items_t.data_ptr(), excl.data_ptr(),
           *(t.data_ptr() for t in out), b, d, i_pad, parts)
    if bf16:
        fused_sweep.launches_bf16 += 1
    else:
        fused_sweep.launches += 1
    return out if parts == 1 else merge_parts(*out)


fused_sweep.launches = 0
fused_sweep.launches_bf16 = 0


def fused_sweep_reference(
    users: torch.Tensor,
    items_t: torch.Tensor,
    excl: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's contract, in user chunks:
    score (exact fp32), mask, view as (B, I_pad/128, 128) lane classes, a
    stable descending sort per class (ties: lowest id first), the top
    SLOTS as candidates and the next value as the ghost. NaN scores sort
    last as -inf and fill no slot, but a class holding one (after the
    exclusion mask: an excluded NaN item scores NEG) gets a NaN ghost, with
    any number of item groups; values at or below INIT_NEG fill no slot
    and no ghost, as in the kernel."""
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
        nan = z.isnan()
        nan_class = nan.view(e - s, groups, LANES).any(dim=1)
        z = z.masked_fill(nan, -float("inf"))
        v, g = z.view(e - s, groups, LANES).sort(
            dim=1, descending=True, stable=True
        )
        keep = v[:, :top] > INIT_NEG
        cand_v[s:e, :top] = torch.where(keep, v[:, :top], INIT_NEG)
        cand_i[s:e, :top] = torch.where(
            keep, g[:, :top] * LANES + lane, 0).to(torch.int32)
        if groups > SLOTS:
            ghost[s:e] = v[:, SLOTS].clamp_min(INIT_NEG)
        ghost[s:e].masked_fill_(nan_class, float("nan"))
    return cand_v.view(b, CANDIDATES), cand_i.view(b, CANDIDATES), ghost


def part_bounds(groups: int, parts: int):
    """The kernel's split of ``groups`` item groups into ``parts`` ranges:
    part p covers groups [bounds[p], bounds[p + 1])."""
    return [groups * p // parts for p in range(parts + 1)]


def sweep_parts_reference(users, items_t, excl, parts: int):
    """Plain per-part sweeps, stacked as the kernel's scratch: each part
    of ``part_bounds`` swept by ``fused_sweep_reference`` with its ids
    made global (unfilled slots keep id 0)."""
    bounds = part_bounds(items_t.shape[1] // LANES, parts)
    outs = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        cols = slice(lo * LANES, hi * LANES)
        cv, ci, gh = fused_sweep_reference(
            users, items_t[:, cols].contiguous(), excl[cols])
        outs.append((cv, torch.where(cv > INIT_NEG, ci + lo * LANES, ci), gh))
    return tuple(torch.stack(t) for t in zip(*outs))


def _check_parts(part_v, part_i, part_g):
    if part_v.dim() != 3 or part_v.shape[2] != CANDIDATES:
        raise ValueError("part_v must be (parts, B, 1024)")
    p, b, _ = part_v.shape
    if part_i.shape != part_v.shape or tuple(part_g.shape) != (p, b, LANES):
        raise ValueError("part_i (parts, B, 1024), part_g (parts, B, 128)")
    if (part_v.dtype, part_i.dtype, part_g.dtype) != (
            torch.float32, torch.int32, torch.float32):
        raise TypeError("merge_parts takes f32 values, i32 ids, f32 ghosts")
    if not (part_v.device == part_i.device == part_g.device):
        raise ValueError("the parts must be on one device")
    if not (part_v.is_contiguous() and part_i.is_contiguous()
            and part_g.is_contiguous()):
        raise ValueError("merge_parts takes contiguous tensors")


def merge_parts(part_v, part_i, part_g):
    """Fold per-part sweeps ((parts, B, 1024) x2, (parts, B, 128), the
    parts in increasing item order) into one (cand_v, cand_i, ghost)."""
    _check_parts(part_v, part_i, part_g)
    dev = part_v.device
    if dev.type == "cpu":
        return merge_parts_reference(part_v, part_i, part_g)
    if dev.type != "cuda":
        raise ValueError(f"no merge kernel for device {dev}")
    parts, b, _ = part_v.shape
    out = empty_candidates(b, dev)
    launch("coldrec_merge_parts", dev, part_v.data_ptr(), part_i.data_ptr(),
           part_g.data_ptr(), *(t.data_ptr() for t in out), b, parts)
    merge_parts.launches += 1
    return out


merge_parts.launches = 0


def merge_parts_reference(part_v, part_i, part_g):
    """Plain version of the merge: per (user, class) a stable descending
    sort of the parts' slots in part order (a later part's ids are larger,
    so ties keep the lowest id), the top SLOTS (unfilled: (INIT_NEG, 0)),
    and the max of the parts' ghosts and of the best value left out (NaN
    where a part's ghost is NaN: ``amax`` and ``maximum`` propagate it)."""
    parts, b, _ = part_v.shape
    v = part_v.view(parts, b, SLOTS, LANES).transpose(0, 1).reshape(
        b, parts * SLOTS, LANES)
    i = part_i.view(parts, b, SLOTS, LANES).transpose(0, 1).reshape(
        b, parts * SLOTS, LANES)
    sv, order = v.sort(dim=1, descending=True, stable=True)
    si = i.gather(1, order)
    keep = sv[:, :SLOTS] > INIT_NEG
    cand_v = torch.where(keep, sv[:, :SLOTS], INIT_NEG)
    cand_i = torch.where(keep, si[:, :SLOTS], 0).to(torch.int32)
    ghost = part_g.amax(dim=0)
    if parts > 1:
        ghost = torch.maximum(ghost, sv[:, SLOTS])
    return (cand_v.reshape(b, CANDIDATES).contiguous(),
            cand_i.reshape(b, CANDIDATES).contiguous(), ghost)


def _resolve(cand_v, cand_i, ghost, rated, k: int):
    """Reject rated candidates, take the top-k, and flag rows whose result
    the candidates cannot certify.

    Membership is a broadcast equality reduce over (B, SLOTS*128, R). The
    selection is a stable sort (lowest candidate position first among ties,
    as the JAX package's masked argmax passes). A row is flagged when its
    max ghost reaches theta (never where a ghost is NaN: ``max``
    propagates it and ``NaN >= theta`` is false, as in the JAX package), or
    when more candidates tie with theta than the selection kept; both
    flags are permutation-invariant, and the (-value, id) order is applied
    on the host (``_torch_tie_order``)."""
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
    up to a multiple of 8, larger counts to whole chunks. The rows and the
    host seconds spent add up in ``apply_exact_fallback.rows`` / ``.seconds``
    (e.g. SimGCL's all-tie cold rows)."""
    rows = np.flatnonzero(sus)
    if rows.size == 0:
        return
    t = time.perf_counter()
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
    apply_exact_fallback.rows += int(rows.size)
    apply_exact_fallback.seconds += time.perf_counter() - t


apply_exact_fallback.rows = 0
apply_exact_fallback.seconds = 0.0


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to bfloat16 (to nearest even) and widened back."""
    return x.to(torch.bfloat16).float()


def _exact_rows(users_rows, items, rated_rows, excluded, k: int,
                bf16: bool = False):
    """Exact masked top-k for fallback rows (fp32 products, TF32 off);
    with ``bf16`` on operands rounded to bf16 first, as the kernel's."""
    if bf16:
        users_rows, items = bf16_round(users_rows), bf16_round(items)
    v, i = masked_topk(exact_scores(users_rows, items), rated_rows, excluded, k)
    return v.cpu().numpy(), i.cpu().numpy()


def pad_items(item_emb: torch.Tensor, excluded: torch.Tensor):
    """The kernel's item operands: the (d, I_pad) transposed table (of
    ``item_emb``'s type), padded to a multiple of 128 items with zeros, and
    the (I_pad,) int8 exclusion row, whose pad entries are set so a pad
    item can never be a result."""
    n_items, d = item_emb.shape
    i_pad = _round_up(n_items, LANES)
    items_t = torch.zeros((d, i_pad), dtype=item_emb.dtype,
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
    bf16: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full masked top-k sweep; returns numpy (vals (U, k), ids (U, k)),
    exact and in (-value, id) order. Takes numpy arrays or tensors; tensors
    already on ``device`` are used in place. ``bf16=True``: the exact top-k
    of the scores of the bf16-rounded tables (fp32 sums), through the
    kernel's bf16 instance."""
    dev = resolve_device(device)
    ue = torch.as_tensor(user_emb, dtype=torch.float32, device=dev)
    ie = torch.as_tensor(item_emb, dtype=torch.float32, device=dev)
    rated = torch.as_tensor(rated_pad, device=dev).long()
    excl = torch.as_tensor(excluded, device=dev).bool()
    if k + rated.shape[1] > CANDIDATES:
        raise ValueError(
            f"k + rated width = {k + rated.shape[1]} exceeds the kernel's "
            f"{CANDIDATES} candidates; use masked_topk"
        )
    kind = torch.bfloat16 if bf16 else torch.float32
    items_t, excl_row = pad_items(ie.to(kind), excl)
    return sweep_topk(ue, ie, items_t, excl_row, rated, excl, k, bf16)


def sweep_topk(ue, ie, items_t, excl_row, rated, excl, k: int,
               bf16: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """The sweep of ``retrieval_topk`` against item operands already
    prepared by :func:`pad_items` (of ``ie`` in the sweep's type), so that
    a caller sweeping many user sets against one table pads and transposes
    it once. ``ue``/``ie`` are fp32 tensors on one device, ``rated`` (U, R)
    int64 and ``excl`` (I,) bool beside them; returns numpy (vals (U, k),
    ids (U, k)), exact and in (-value, id) order."""
    n_users = ue.shape[0]
    if n_users == 0:
        return np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
    uk = ue.to(items_t.dtype)
    vals_l, ids_l, sus_l = [], [], []
    for s in range(0, n_users, USER_CHUNK):
        e = min(n_users, s + USER_CHUNK)
        cv, ci, gh = fused_sweep(uk[s:e].contiguous(), items_t, excl_row)
        v, i, sus = _resolve(cv, ci, gh, rated[s:e], k)
        vals_l.append(v.cpu().numpy())
        ids_l.append(i.cpu().numpy())
        sus_l.append(sus.cpu().numpy())
    vals, ids = _torch_tie_order(
        np.concatenate(vals_l), np.concatenate(ids_l)
    )

    def exact_chunk(rows_pad):
        rows_d = torch.as_tensor(rows_pad, device=ue.device)
        return _exact_rows(ue[rows_d], ie, rated[rows_d], excl, k, bf16)

    apply_exact_fallback(vals, ids, np.concatenate(sus_l), exact_chunk)
    return vals, ids
