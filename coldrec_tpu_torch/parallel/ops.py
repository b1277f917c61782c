"""Sharded building blocks: embedding lookup, SpMM, retrieval top-k merge.

The port's counterpart of ``coldrec_tpu/parallel/ops.py``. The JAX package
writes these as ``shard_map`` programs and lets XLA transpose the
collectives; here each rank runs its own part in eager PyTorch, the
collectives go through :mod:`.distributed`, and every collective that
carries a gradient is a ``torch.autograd.Function`` whose backward is
written from what is replicated downstream:

  * :class:`AllReduceIdentity`: a sum over a group whose every rank goes on
    to compute the same thing (the exchange lookup, the loss parts over
    the data axis). The backward is the identity: each rank already holds
    the whole gradient of the replicated result (an all-reduce there would
    give the group size times the gradient).
  * :class:`AllGatherRows`: row blocks gathered into the full table. With
    ``replicated=True`` (every rank computes the same thing from it) the
    backward is this rank's block of the gradient; with ``False`` (each
    rank uses its own part of it, e.g. the SpMM whose output rows stay
    sharded) the backward sums the gradient over the group, then takes
    this rank's block (gloo has no ``reduce_scatter``: all-reduce, then a
    slice).
  * :class:`CopyToGroup`: a replicated tensor entering a row-sharded
    computation: the identity forward, the sum over the group backward.

The kernel on this module's path is the ported ``fused_sweep``
(``ops/cuda/retrieval.py``), launched by :func:`sharded_retrieval_topk` on
each rank's item block; the lookups, the SpMM and the shard merges are plain
torch, as they are plain XLA in the JAX package. A tensor ``local`` below is
this rank's row block of a table row-sharded over the model axis: block
``m`` holds rows ``[m * rps, (m + 1) * rps)``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.cuda.retrieval import (
    CANDIDATES, USER_CHUNK, _resolve, _torch_tie_order, apply_exact_fallback,
    fused_sweep, pad_items,
)
from ..runtime.eval import MASK_VALUE, exact_scores, stable_topk
from .distributed import all_gather, all_reduce, group_rank, host_block
from .mesh import Mesh


# ------------------------------------------------------------ collectives
class AllReduceIdentity(torch.autograd.Function):
    """Sum over ``group``; backward the identity (the result is replicated
    downstream)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class AllGatherRows(torch.autograd.Function):
    """Row blocks of ``group`` concatenated; see the module docstring for
    the two backwards."""

    @staticmethod
    def forward(ctx, x, group, replicated: bool):
        ctx.group, ctx.replicated, ctx.rows = group, replicated, x.shape[0]
        return all_gather(x, group, dim=0)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.replicated:
            grad = all_reduce(grad.contiguous(), ctx.group)
        start = group_rank(ctx.group) * ctx.rows
        return grad[start:start + ctx.rows], None, None


class CopyToGroup(torch.autograd.Function):
    """The identity forward; the gradient summed over ``group`` backward
    (each rank used its own part of the replicated input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None


class ExchangeLookup(torch.autograd.Function):
    """Rows ``ids`` of the row-sharded table: each rank gathers the ids it
    owns, the others are zeros, and one all-reduce over the model group
    assembles them (replicated). Backward: the gradient of the owned rows
    accumulated into this rank's block by the same ``index_put_`` as the
    backward of plain indexing, over the owned ids in their order, so each
    row's gradient is bit-equal to that of ``table[ids]`` on one rank."""

    @staticmethod
    def forward(ctx, local, ids, shard: int, group):
        rps = local.shape[0]
        loc = ids.long() - shard * rps
        own = (loc >= 0) & (loc < rps)
        rows = local[torch.where(own, loc, torch.zeros_like(loc))]
        rows = rows.masked_fill(~own[:, None], 0.0)
        ctx.save_for_backward(loc, own)
        ctx.shape = local.shape
        return all_reduce(rows, group)

    @staticmethod
    def backward(ctx, grad):
        loc, own = ctx.saved_tensors
        out = grad.new_zeros(ctx.shape)
        out.index_put_((loc[own],), grad[own], accumulate=True)
        return out, None, None, None


# ------------------------------------------------------------ placement
def pad_rows(x: np.ndarray, multiple: int) -> np.ndarray:
    n = x.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return x
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])


def shard_rows(mesh: Mesh, table):
    """This rank's row block of an (N, d) table over the model axis
    (N % n_model == 0 required; pad first with :func:`pad_rows`)."""
    return host_block(table, mesh.n_model, mesh.model_index)


def gather_rows(mesh: Mesh, local: torch.Tensor,
                replicated: bool = True) -> torch.Tensor:
    """The full table from the model axis' row blocks (``local`` itself on
    a model axis of 1), differentiable (:class:`AllGatherRows`)."""
    if mesh.model_group is None:
        return local
    return AllGatherRows.apply(local, mesh.model_group, replicated)


# ------------------------------------------------------------ lookup
def sharded_lookup(mesh: Mesh, local: torch.Tensor, ids: torch.Tensor,
                   mode: str = "auto") -> torch.Tensor:
    """Rows ``ids`` of a table row-sharded over the model axis; ids and
    result replicated over the model group.

    * ``exchange``: each rank gathers the rows it owns (the others zero)
      and one all-reduce assembles the batch: O(B d) bytes a step, flat in
      the table's height.
    * ``gather``: all-gather the table, then index: O(N d) a step.

    ``auto`` takes ``exchange`` where N > n_model * B (the JAX rule)."""
    n_rows = local.shape[0] * mesh.n_model
    if mode == "auto":
        mode = "exchange" if n_rows > mesh.n_model * ids.shape[0] else "gather"
    if mode == "gather":
        return gather_rows(mesh, local)[ids.long()]
    if mode != "exchange":
        raise ValueError(f"lookup mode {mode!r}")
    if mesh.model_group is None:
        return local[ids.long()]
    return ExchangeLookup.apply(local, ids, mesh.model_index,
                                mesh.model_group)


# ------------------------------------------------------------ SpMM
class ShardedGraph:
    """This rank's edges of a graph partitioned by destination-row shard,
    in the host graph's order. The JAX package pads every shard to the
    widest with no-op edges (value 0, row = the shard's first row) for
    XLA's static shapes; here they would all add into that one row (at
    MovieLens-1M shape over 2 shards, 190,678 of them on shard 0's first
    row, each layer and its backward), so there are none."""

    def __init__(self, mesh: Mesh, host_graph, n_rows_padded: int,
                 device="cpu"):
        n_model = mesh.n_model
        if n_rows_padded % n_model:
            raise ValueError(f"{n_rows_padded} rows over {n_model} shards")
        self.mesh = mesh
        self.rows_per_shard = n_rows_padded // n_model
        rows, cols, vals = host_graph.rows, host_graph.cols, host_graph.vals
        own = rows // self.rows_per_shard == mesh.model_index
        self.rows = torch.as_tensor(rows[own], device=device).long()
        self.cols = torch.as_tensor(cols[own], device=device).long()
        self.vals = torch.as_tensor(vals[own], device=device)


def sharded_spmm(graph: ShardedGraph, x_local: torch.Tensor) -> torch.Tensor:
    """This rank's rows of A @ x, with x row-sharded: all-gather x over the
    model axis, then a local gather and segment sum (``index_add``). The
    output rows stay sharded, so the all-gather's backward sums over the
    group."""
    rps = graph.rows_per_shard
    x_full = gather_rows(graph.mesh, x_local, replicated=False)
    local_rows = graph.rows - graph.mesh.model_index * rps
    msg = x_full[graph.cols] * graph.vals[:, None]
    out = x_local.new_zeros((rps, x_local.shape[1]))
    return out.index_add(0, local_rows, msg)


class MeshGraph:
    """The normalized-adjacency operator over node-row blocks (the
    counterpart of ``make_mesh_graph``): the (n_nodes) node space padded to
    a multiple of the model axis, rank ``m`` owning rows ``[m * rps, (m +
    1) * rps)``. Pad rows have no edges, so they stay zero."""

    def __init__(self, mesh: Mesh, host_graph, n_nodes: int, device="cpu"):
        n_model = mesh.n_model
        self.mesh = mesh
        self.n_nodes = n_nodes
        self.n_pad_total = n_nodes + ((-n_nodes) % n_model)
        self.graph = ShardedGraph(mesh, host_graph, self.n_pad_total, device)
        self.rows_per_shard = self.graph.rows_per_shard

    def block(self, x_full: torch.Tensor) -> torch.Tensor:
        """This rank's row block of a full (n_nodes, d) node table."""
        pad = self.n_pad_total - self.n_nodes
        if pad:
            x_full = torch.cat([x_full, x_full.new_zeros((pad,
                                                          x_full.shape[1]))])
        start = self.mesh.model_index * self.rows_per_shard
        return x_full[start:start + self.rows_per_shard]

    def __call__(self, x_block: torch.Tensor) -> torch.Tensor:
        return sharded_spmm(self.graph, x_block)

    def full(self, x_block: torch.Tensor) -> torch.Tensor:
        """The (n_nodes, d) table from every rank's block (replicated)."""
        return gather_rows(self.mesh, x_block)[: self.n_nodes]


# ------------------------------------------------------------ retrieval
def sharded_masked_topk(
    mesh: Mesh,
    user_emb: torch.Tensor,  # (B, d) replicated
    item_local: torch.Tensor,  # (I / n_model, d), this rank's rows
    excl_local: torch.Tensor,  # (I / n_model,) bool
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Item-axis-sharded retrieval: local score + top-k per shard, the k
    candidates all-gathered, a global re-rank (lowest index among ties).
    Returns replicated (vals, ids)."""
    items_per = item_local.shape[0]
    scores = exact_scores(user_emb, item_local).masked_fill(
        excl_local[None, :], MASK_VALUE)
    lv, li = stable_topk(scores, min(k, items_per))
    li = li + mesh.model_index * items_per
    av = all_gather(lv, mesh.model_group, dim=1)
    ai = all_gather(li, mesh.model_group, dim=1)
    gv, gpos = av.sort(dim=1, descending=True, stable=True)
    gv, gpos = gv[:, :k], gpos[:, :k]
    return gv, ai.gather(1, gpos)


def sharded_retrieval_topk(
    mesh: Mesh,
    user_emb: torch.Tensor,  # (B, d) replicated, fp32
    item_local: torch.Tensor,  # (I / n_model, d), this rank's rows, fp32
    rated_pad: np.ndarray,  # (B, R) global item ids, pad >= I
    excl_local: torch.Tensor,  # (I / n_model,) bool
    k: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Item-axis-sharded retrieval through the retrieval kernel.

    Each rank sweeps its own item rows with ``fused_sweep`` (the kernel on
    the card, its plain version on the CPU) in ``USER_CHUNK`` pieces: the
    block padded to 128 lanes, pad columns excluded. Local candidate ids
    become global; a pad column maps to the global pad id ``n_items``,
    never to ``local + shard * items_per``, which would alias it into the
    next shard's real ids. Values, ids and ghosts are all-gathered along
    dim 1 over the model group and ``_resolve`` rejects rated items among
    them; the survivors' top-k is exact by the per-shard ghost argument,
    and flagged rows are recomputed by :func:`_sharded_exact_rows`.
    Returns numpy (vals, ids) in (-value, id) order, on every rank."""
    n_users = user_emb.shape[0]
    items_per = item_local.shape[0]
    n_items = items_per * mesh.n_model
    if k + rated_pad.shape[1] > CANDIDATES:
        raise ValueError(f"k + rated width {k + rated_pad.shape[1]} exceeds "
                         f"the kernel's {CANDIDATES} candidates")
    dev = item_local.device
    items_t, excl_row = pad_items(item_local, excl_local)
    offset = mesh.model_index * items_per
    rated = torch.as_tensor(np.asarray(rated_pad), device=dev).long()
    vals_l, ids_l, sus_l = [], [], []
    for s in range(0, n_users, USER_CHUNK):
        e = min(n_users, s + USER_CHUNK)
        cv, ci, gh = fused_sweep(user_emb[s:e].contiguous(), items_t,
                                 excl_row)
        ci = torch.where(ci < items_per, ci + offset,
                         torch.full_like(ci, n_items))
        av = all_gather(cv, mesh.model_group, dim=1)
        ai = all_gather(ci, mesh.model_group, dim=1)
        ag = all_gather(gh, mesh.model_group, dim=1)
        v, i, sus = _resolve(av, ai, ag, rated[s:e], k)
        vals_l.append(v.cpu().numpy())
        ids_l.append(i.cpu().numpy())
        sus_l.append(sus.cpu().numpy())
    if not vals_l:
        return np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
    vals, ids = _torch_tie_order(np.concatenate(vals_l),
                                 np.concatenate(ids_l))

    def exact_chunk(rows_pad):
        rows_d = torch.as_tensor(rows_pad, device=dev)
        return _sharded_exact_rows(mesh, user_emb[rows_d], item_local,
                                   rated[rows_d], excl_local, k)

    apply_exact_fallback(vals, ids, np.concatenate(sus_l), exact_chunk)
    return vals, ids


def _sharded_exact_rows(mesh: Mesh, users_rows, item_local, rated_rows,
                        excl_local, k: int):
    """Exact fallback for flagged rows: a per-shard overfetch of top
    (k + R) with the candidate mask only, all-gathered; rated items set to
    the reference mask value so that fillers tie as in ``masked_topk``;
    a stable re-rank. Exact because at most R rated items can outrank a
    masked top-k element inside its shard."""
    items_per = item_local.shape[0]
    fetch = min(k + rated_rows.shape[1], items_per)
    scores = exact_scores(users_rows, item_local).masked_fill(
        excl_local[None, :], MASK_VALUE)
    lv, li = stable_topk(scores, fetch)
    li = li + mesh.model_index * items_per
    av = all_gather(lv, mesh.model_group, dim=1)
    ai = all_gather(li, mesh.model_group, dim=1)
    is_rated = (ai[:, :, None] == rated_rows[:, None, :]).any(dim=-1)
    av = av.masked_fill(is_rated, MASK_VALUE)
    vals, pos = av.sort(dim=1, descending=True, stable=True)
    vals, pos = vals[:, :k], pos[:, :k]
    return vals.cpu().numpy(), ai.gather(1, pos).cpu().numpy()
