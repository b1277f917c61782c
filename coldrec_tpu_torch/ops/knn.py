"""Exact inner-product k-nearest-neighbour search (the port's copy of
``coldrec_tpu/ops/knn.py``; reference: faiss.IndexFlatIP in KNN.py:67-73).

For each query row, the top-k rows of ``values`` by inner product, values
descending and equal values lowest index first (``lax.top_k``'s rule). Used
by the KNN cold-start model (content neighbours) and AGNN's cosine-kNN
graph.

Two routes compute the same function:

  * kernel: the retrieval sweep (``ops/cuda/retrieval.py``) unmasked, with
    an all-false exclusion row and one pad-id "rated" column that rejects
    nothing (the JAX package's ``_knn_via_retrieval``). The value table is
    padded and transposed once per call (``pad_items``) and every chunk of
    ``chunk`` queries is swept against it. Rows whose candidates cannot
    certify the top-k (ties across the cut, e.g. an all-zero query row) go
    to the exact fallback, as in evaluation.
  * plain: exact fp32 scores (TF32 off) and ``stable_topk`` per chunk of
    ``chunk`` queries (the JAX package's ``_topk_chunk`` +
    ``_hierarchical_topk``).

The route follows the JAX package's size rule: the kernel where the values
have at least 512 rows and k + 1 fits the kernel's 1024 candidates, on the
card; the plain route otherwise, and always on the CPU. The JAX package
also sends every sweep with d > 128 to its plain route, because its TPU
kernel double-buffers a (d, block) item window against a 16 MB VMEM budget.
The CUDA kernel takes any d (the user tile is held or staged in dynamic
shared memory, ``csrc/sweep_tile.cuh``), so here wide content tables
(book-crossing's 416 item and 2,312 user columns) go through the kernel:
the route differs, the function it computes does not. Each call sends a
``knn_route`` event (route, Q, V, d, k) to the event log.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..runtime.eval import exact_scores, stable_topk
from ..utils.logging import event_log
from .cuda.retrieval import CANDIDATES, pad_items, sweep_topk

MIN_KERNEL_VALUES = 512  # the JAX package's smallest value set for its kernel


def knn_route(n_values: int, k: int, device) -> str:
    """``"kernel"`` or ``"plain"`` for a sweep of ``n_values`` rows."""
    if (resolve_device(device).type == "cuda"
            and n_values >= MIN_KERNEL_VALUES and k + 1 <= CANDIDATES):
        return "kernel"
    return "plain"


def _as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def knn_via_kernel(queries, values, k: int, chunk: int = 4096,
                   device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """The kernel route: (scores (Q, k) float32, ids (Q, k) int32). On a
    CPU device the sweep is the kernel's plain version."""
    dev = resolve_device(device)
    q = _as_tensor(queries, dev)
    v = _as_tensor(values, dev)
    n_values = v.shape[0]
    excl = torch.zeros(n_values, dtype=torch.bool, device=dev)
    items_t, excl_row = pad_items(v, excl)
    rated = torch.full((min(chunk, q.shape[0]), 1), n_values,
                       dtype=torch.int64, device=dev)
    out_s, out_i = [], []
    for start in range(0, q.shape[0], chunk):
        qc = q[start: start + chunk]
        s, i = sweep_topk(qc, v, items_t, excl_row, rated[: qc.shape[0]],
                          excl, k)
        out_s.append(s)
        out_i.append(i.astype(np.int32))
    return _stack(out_s, out_i, k)


def knn_plain(queries, values, k: int, chunk: int = 4096,
              device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """The plain route: exact fp32 scores and ``stable_topk`` per chunk."""
    dev = resolve_device(device)
    q = _as_tensor(queries, dev)
    v = _as_tensor(values, dev)
    out_s, out_i = [], []
    for start in range(0, q.shape[0], chunk):
        s, i = stable_topk(exact_scores(q[start: start + chunk], v), k)
        out_s.append(s.cpu().numpy())
        out_i.append(i.cpu().numpy().astype(np.int32))
    return _stack(out_s, out_i, k)


def _stack(out_s, out_i, k):
    if not out_s:
        return np.zeros((0, k), np.float32), np.zeros((0, k), np.int32)
    return np.concatenate(out_s), np.concatenate(out_i)


def knn_inner_product(queries, values, k: int, chunk: int = 4096,
                      device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """(scores (Q, k), ids (Q, k)) of the top-k ``values`` rows by inner
    product for each query row, as numpy. Exact, like faiss IndexFlatIP."""
    n_values, d = np.shape(values)
    route = knn_route(n_values, k, device)
    event_log().emit("knn_route", route=route, queries=int(len(queries)),
                     values=int(n_values), d=int(d), k=int(k))
    fn = knn_via_kernel if route == "kernel" else knn_plain
    return fn(queries, values, k, chunk, device)


def knn_cosine(queries, values, k: int, chunk: int = 4096,
               device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Top-k by cosine similarity (row-normalized inner product); a zero
    row stays zero (norm floored at 1e-12), so its scores all tie."""
    qn = queries / np.maximum(
        np.linalg.norm(queries, axis=1, keepdims=True), 1e-12
    )
    vn = values / np.maximum(
        np.linalg.norm(values, axis=1, keepdims=True), 1e-12
    )
    return knn_inner_product(qn, vn, k, chunk, device)
