"""Sparse matrix times dense (SpMM) for graph propagation (the port's copy of
``coldrec_tpu/ops/spmm.py``; reference: the ``torch.sparse.mm`` COO SpMM of
the LightGCN family, LightGCN.py:90, NGCF.py:95, SimGCL.py:105, ...).

The adjacency comes from the builder as flat row / col / val arrays sorted
by row (:class:`coldrec_tpu_torch.data.builder.SparseGraphHost`). The
symmetric propagation matrices of the graph backbones go to the hybrid
layout of :class:`EllGraph`: every row padded to a fixed width K (the
95th-percentile degree, rounded up to 8) for a weighted sum of gathered
rows with no scatter, and the edges beyond K in a row-sorted COO tail
summed into their rows. :func:`make_sym_spmm` wraps it in a
``torch.autograd.Function`` whose backward is the same apply on the
incoming gradient (A = A^T), so autograd never differentiates the gather
and nothing of size (N, K, d) is saved for the backward.

The JAX package computes this with XLA (gather + einsum + sorted
``segment_sum``), not a Pallas kernel, so the port's is plain torch: the
ELL part is one ``embedding_bag`` (N bags of K weighted rows), the tail
one ``index_add_`` (atomics on the card: its sums differ from run to run
in the last bits). ``chip_smoke.py`` times them beside the forms they
replaced: on an H100 at book-crossing shape (362k nodes, K = 16, 324k
tail edges, the heaviest row 48k of them) the ELL part takes 0.82 ms, the
(N, K, d) gather + batched product 4.2 ms; the tail 0.82 ms, a
``torch.segment_reduce`` over its sorted rows (a fixed order) 5.2 ms
(PERF.md).

The JAX package's ``sym_spmm_arrays`` / ``ell_arrays`` pass the graph as jit
arguments to stay under its remote compiler's request limit; PyTorch has no
such limit, so the port has no counterpart of them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

class SparseGraph(NamedTuple):
    """Device-resident COO graph, rows sorted ascending."""

    rows: torch.Tensor  # (nnz,) int64
    cols: torch.Tensor  # (nnz,) int64
    vals: torch.Tensor  # (nnz,) float32
    n_rows: int

    @classmethod
    def from_host(cls, host, device="cuda") -> "SparseGraph":
        dev = resolve_device(device)
        return cls(
            rows=torch.as_tensor(host.rows, device=dev).long(),
            cols=torch.as_tensor(host.cols, device=dev).long(),
            vals=torch.as_tensor(host.vals, device=dev),
            n_rows=int(host.shape[0]),
        )


class EllGraph(NamedTuple):
    """Hybrid ELL + COO-tail layout of a symmetric propagation matrix.

    ``ell_cols`` / ``ell_vals`` hold each row's first K edges (pad col 0,
    pad val 0); the rest lie in the row-sorted tail."""

    ell_cols: torch.Tensor  # (N, K) int64
    ell_vals: torch.Tensor  # (N, K) float32
    tail_rows: torch.Tensor  # (T,) int64, sorted
    tail_cols: torch.Tensor  # (T,) int64
    tail_vals: torch.Tensor  # (T,) float32
    n_rows: int


def ell_arrays_host(host, k_percentile: float = 95.0):
    """The numpy arrays of the ELL + tail split of a row-sorted host COO
    graph: (ell_cols, ell_vals, tail_rows, tail_cols, tail_vals), bit for
    bit the JAX package's ``build_ell``."""
    n = int(host.shape[0])
    deg = np.bincount(host.rows, minlength=n)
    k = int(np.percentile(deg, k_percentile)) if deg.size else 1
    k = max(8, ((k + 7) // 8) * 8)
    ell_cols = np.zeros((n, k), np.int32)
    ell_vals = np.zeros((n, k), np.float32)
    # each edge's place within its row (rows are sorted)
    starts = np.cumsum(deg) - deg
    within = np.arange(host.rows.shape[0]) - np.repeat(starts, deg)
    in_ell = within < k
    r_ell = host.rows[in_ell]
    ell_cols[r_ell, within[in_ell]] = host.cols[in_ell]
    ell_vals[r_ell, within[in_ell]] = host.vals[in_ell]
    tail = ~in_ell
    return (ell_cols, ell_vals, host.rows[tail], host.cols[tail],
            host.vals[tail])


def build_ell(host, k_percentile: float = 95.0, device="cuda") -> EllGraph:
    """Partition a row-sorted host COO graph into ELL + tail on ``device``."""
    dev = resolve_device(device)
    n = int(host.shape[0])
    cols, vals, t_rows, t_cols, t_vals = ell_arrays_host(host, k_percentile)
    return EllGraph(
        ell_cols=torch.as_tensor(cols, device=dev).long(),
        ell_vals=torch.as_tensor(vals, device=dev),
        tail_rows=torch.as_tensor(t_rows, device=dev).long(),
        tail_cols=torch.as_tensor(t_cols, device=dev).long(),
        tail_vals=torch.as_tensor(t_vals, device=dev),
        n_rows=n,
    )


def _row_sums(rows, cols, vals, n_rows, x):
    """sum over edges e of vals[e] * x[cols[e]] into row rows[e]; the
    gather is an ``index_select``, whose backward (where autograd takes
    it: CGRC's G') is an ``index_add_``, not the sort of ``x[cols]``'s."""
    data = x.index_select(0, cols) * vals[:, None]
    return x.new_zeros((n_rows, x.shape[1])).index_add_(0, rows, data)


def ell_part(graph: EllGraph, x: torch.Tensor) -> torch.Tensor:
    """sum_k vals[n, k] * x[cols[n, k]]: one ``embedding_bag`` of N bags of
    K weighted rows (each summed in a fixed order; nothing of size
    (N, K, d) is written)."""
    return F.embedding_bag(graph.ell_cols, x, mode="sum",
                           per_sample_weights=graph.ell_vals)


def tail_part(graph: EllGraph, x: torch.Tensor) -> torch.Tensor:
    """The tail's edges summed into their rows, (N, d)."""
    return _row_sums(graph.tail_rows, graph.tail_cols, graph.tail_vals,
                     graph.n_rows, x)


def ell_apply(graph: EllGraph, x: torch.Tensor) -> torch.Tensor:
    """A @ x in the ELL + tail layout."""
    out = ell_part(graph, x)
    if graph.tail_rows.shape[0]:
        out = out + tail_part(graph, x)
    return out


def coo_apply(graph: SparseGraph, x: torch.Tensor) -> torch.Tensor:
    """A @ x of a row-sorted COO graph: gather, scale, sum into the rows."""
    return _row_sums(graph.rows, graph.cols, graph.vals, graph.n_rows, x)


def reweighted_sym_graph(rows: torch.Tensor, cols: torch.Tensor,
                         keep: torch.Tensor, n_rows: int) -> SparseGraph:
    """D^-1/2 (A * keep) D^-1/2 as a COO :class:`SparseGraph` over a static
    edge list (``rows``, ``cols``) whose edges carry 0/1 weights ``keep``,
    the degrees recomputed from the kept edges by a segment sum: CGRC's G'
    with the edges of its simulated cold items dropped, with no layout
    rebuilt per step (the JAX package's ``CGRC._masked_graph_vals``)."""
    deg = keep.new_zeros(n_rows).index_add_(0, rows, keep)
    d_inv = torch.where(deg > 0, deg.pow(-0.5), torch.zeros_like(deg))
    return SparseGraph(rows=rows, cols=cols,
                       vals=d_inv[rows] * d_inv[cols] * keep, n_rows=n_rows)


def spmm(graph, x: torch.Tensor) -> torch.Tensor:
    """A @ x. Dispatches on representation: a callable (the
    :func:`make_sym_spmm` operator), an :class:`EllGraph`, or a row-sorted
    COO :class:`SparseGraph`."""
    if callable(graph):
        return graph(x)
    if isinstance(graph, EllGraph):
        return ell_apply(graph, x)
    return coo_apply(graph, x)


class _SymSpmm(torch.autograd.Function):
    """A @ x for a symmetric A: the backward is A @ g (A^T = A)."""

    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph = graph
        return ell_apply(graph, x)

    @staticmethod
    def backward(ctx, g):
        return ell_apply(ctx.graph, g.contiguous()), None


class SymSpmm:
    """The operator f(x) = A @ x of a symmetric A, differentiable in x
    through :class:`_SymSpmm`; ``graph`` is its :class:`EllGraph`."""

    def __init__(self, graph: EllGraph):
        self.graph = graph

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _SymSpmm.apply(x, self.graph)


def make_sym_spmm(host_or_ell, device="cuda") -> SymSpmm:
    """f(x) = A @ x for a SYMMETRIC A given as a host COO graph (built into
    ELL + tail on ``device``) or an :class:`EllGraph`."""
    graph = (host_or_ell if isinstance(host_or_ell, EllGraph)
             else build_ell(host_or_ell, device=device))
    return SymSpmm(graph)


def spmm_ref(host, x: np.ndarray) -> np.ndarray:
    """scipy oracle for tests."""
    import scipy.sparse as sp

    mat = sp.coo_matrix((host.vals, (host.rows, host.cols)), shape=host.shape)
    return np.asarray(mat @ x)
