"""Card timing shared by the bench entry (``coldrec_tpu_torch.bench``) and
``chip_smoke.py``: the CUDA-event timer, the least time one H100 could take
for a sweep, and the timed sweeps (fp32 and bf16) and SpMM apply at one
shape.

On a card every time is CUDA events around a run of calls after a warm-up
call; on the CPU it is the host clock, which times the host's plain
versions and is never a device figure.

The peaks are NVIDIA's published dense rates of one H100 SXM at its full
700 W limit: 67 TFLOP/s in fp32 outside the tensor cores, 989 TFLOP/s in
bf16 on the tensor cores, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

import time
import warnings
from typing import List

import numpy as np
import torch

from ..ops import spmm as spmm_mod
from ..ops.cuda.retrieval import (
    CANDIDATES, LANES, fused_sweep, fused_sweep_reference, pad_items,
)
from ..runtime.eval import exact_scores

FP32_PEAK_FLOPS = 67e12  # fp32 outside the tensor cores
BF16_PEAK_FLOPS = 989e12  # bf16 on the tensor cores, dense
HBM_BYTES_S = 3.35e12  # HBM3
SPMM_RTOL = 1e-5  # each SpMM form against torch.sparse.mm, of the largest value


def run_ms(fn, iters: int, device, repeats: int = 3) -> List[float]:
    """Mean milliseconds per call of ``iters`` calls in a row, for each of
    ``repeats`` runs after one warm-up call: CUDA events on a card, the
    host clock on the CPU."""
    device = torch.device(device)
    fn()
    out = []
    for _ in range(repeats):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            out.append((time.perf_counter() - t0) * 1e3 / iters)
    return out


def time_ms(fn, iters: int, device, repeats: int = 3) -> float:
    """Best of :func:`run_ms`'s runs."""
    return min(run_ms(fn, iters, device, repeats))


def sweep_bound(flops, bytes_moved):
    """(ms, "operations" or "bytes"): fp32 operations at 67 TFLOP/s (outside
    the tensor cores) against bytes at 3.35 TB/s, the larger."""
    t_ops = flops / FP32_PEAK_FLOPS * 1e3
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def sweep_tables(device, n_users, n_items, d, seed, kind=torch.float32):
    """N(0,1) users and items (rounded to ``kind``) with a quarter of the
    items excluded, and the kernel's item operands."""
    rng = np.random.default_rng(seed)
    users = torch.as_tensor(
        rng.standard_normal((n_users, d), dtype=np.float32),
        device=device).to(kind)
    items = torch.as_tensor(
        rng.standard_normal((n_items, d), dtype=np.float32),
        device=device).to(kind)
    excl = torch.zeros(n_items, dtype=torch.bool, device=device)
    excl[torch.as_tensor(rng.choice(n_items, n_items // 4, replace=False),
                         device=device)] = True
    items_t, excl_row = pad_items(items, excl)
    return users, items, items_t, excl_row


def sweep_bytes(n_users, d, i_pad, elem):
    """Bytes one sweep must move: the users and the item operand read once
    (``elem`` bytes a value), the exclusion row, the candidates and ghosts
    written once."""
    return (n_users * d * elem + d * i_pad * elem + i_pad
            + n_users * CANDIDATES * 8 + n_users * LANES * 4)


def time_sweep(device, n_users=2048, n_items=270_170, d=64, k=20, r=32,
               seed=0, reps=20):
    """CUDA-event milliseconds of one fp32 sweep, its plain version's and a
    library yardstick's (TF32-off matmul + ``topk(k + r)``), plus the
    bound."""
    device = torch.device(device)
    users, items, items_t, excl_row = sweep_tables(device, n_users, n_items,
                                                   d, seed)

    def timed(fn, n):
        return time_ms(fn, n, device, repeats=1)

    ms = timed(lambda: fused_sweep(users, items_t, excl_row), reps)
    plain_ms = timed(
        lambda: fused_sweep_reference(users, items_t, excl_row), 3)
    lib_ms = timed(
        lambda: torch.topk(exact_scores(users, items), k + r, dim=1), 5)
    flops = 2.0 * n_users * n_items * d
    bytes_moved = sweep_bytes(n_users, d, items_t.shape[1], 4)
    bound, by = sweep_bound(flops, bytes_moved)
    return {
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "bound_ms": bound, "bound_by": by, "flops": flops,
        "bytes": bytes_moved,
    }


def bf16_library(device):
    """(name, fn): one library call scoring bf16 tables, ``fn(users,
    items) -> scores``: ``torch.mm`` with fp32 output where this torch
    offers ``out_dtype`` on ``device``, else with bf16 output."""
    a = torch.zeros((2, 2), dtype=torch.bfloat16, device=device)
    try:
        torch.mm(a, a, out_dtype=torch.float32)
        return ("bf16 mm, fp32 output",
                lambda u, i: torch.mm(u, i.T, out_dtype=torch.float32))
    except (TypeError, RuntimeError):
        return "bf16 mm, bf16 output", lambda u, i: torch.mm(u, i.T)


def bf16_bound(flops, bytes_moved):
    """(ms, "operations" or "bytes"): operations at the tensor cores' bf16
    rate (989 TFLOP/s) against bytes at 3.35 TB/s, the larger."""
    t_tc = flops / BF16_PEAK_FLOPS * 1e3
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    return max(t_tc, t_bytes), ("operations" if t_tc >= t_bytes
                                else "bytes")


def time_sweep_bf16(device, n_users=2048, n_items=270_170, d=64, k=20,
                    r=32, seed=0, reps=20):
    """The bf16 sweep at one shape (the tables of ``time_sweep``, rounded):
    CUDA-event ms of the kernel, its plain version's and a library
    yardstick's (a bf16 matmul + ``torch.topk``), beside two bounds: the
    CUDA cores' fp32 FMA rate (67 TFLOP/s) and the tensor cores' bf16 rate
    (989 TFLOP/s) against bf16 bytes (what a tensor-core sweep could
    reach)."""
    device = torch.device(device)
    users, items, items_t, excl_row = sweep_tables(
        device, n_users, n_items, d, seed, torch.bfloat16)

    def timed(fn, n):
        return time_ms(fn, n, device, repeats=1)

    ms = timed(lambda: fused_sweep(users, items_t, excl_row), reps)
    plain_ms = timed(lambda: fused_sweep_reference(
        users.float(), items_t.float(), excl_row), 3)
    library, score = bf16_library(device)
    lib_ms = timed(lambda: torch.topk(score(users, items), k + r, dim=1), 5)
    flops = 2.0 * n_users * n_items * d
    bytes_moved = sweep_bytes(n_users, d, items_t.shape[1], 2)
    bound, by = bf16_bound(flops, bytes_moved)
    return {
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "library": library, "bound_ms": bound, "bound_by": by,
        "fp32_fma_bound_ms": sweep_bound(flops, bytes_moved)[0],
        "flops": flops, "bytes": bytes_moved,
    }


def time_spmm(device, host, d=64, reps=10, seed=0) -> dict:
    """One apply of the symmetric SpMM of the host COO graph ``host`` (a
    normalized adjacency): its ELL part (``embedding_bag``) and its tail
    (``index_add_``), each beside the form it replaced (the (N, K, d)
    gather + ``bmm``; ``segment_reduce`` over the sorted tail), the apply,
    forward + backward, and ``torch.sparse.mm`` on the same CSR matrix (a
    yardstick), in CUDA-event ms after a warm-up (host clock on the CPU),
    beside its byte bound: the ELL reads N*K*(4+4) bytes of indices and
    values and N*K*d*4 of gathered rows and writes N*d*4, the tail reads
    T*(4+4+4) + T*d*4 and writes its rows, at 3.35 TB/s. Every form is held
    against the yardstick (``SPMM_RTOL`` of the largest value)."""
    device = torch.device(device)
    graph = spmm_mod.build_ell(host, device=device)
    op = spmm_mod.SymSpmm(graph)
    n = host.shape[0]
    k = graph.ell_cols.shape[1]
    t = graph.tail_rows.shape[0]
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=gen).to(device)
    g = torch.randn((n, d), generator=gen).to(device)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(host.rows, minlength=n), out=indptr[1:])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # CSR support "in beta state"
        csr = torch.sparse_csr_tensor(
            torch.as_tensor(indptr, device=device),
            torch.as_tensor(host.cols.astype(np.int64), device=device),
            torch.as_tensor(host.vals, device=device), size=(n, n),
            check_invariants=False)
    lengths = torch.bincount(graph.tail_rows, minlength=n)

    def ell_gather():
        rows = x[graph.ell_cols]  # (N, K, d)
        return torch.bmm(graph.ell_vals.unsqueeze(1), rows).squeeze(1)

    def tail_segment():
        return torch.segment_reduce(
            x[graph.tail_cols] * graph.tail_vals[:, None], "sum",
            lengths=lengths, axis=0, unsafe=True)

    lib = torch.sparse.mm(csr, x)
    ells = (lambda: spmm_mod.ell_part(graph, x), ell_gather)
    tails = (lambda: spmm_mod.tail_part(graph, x), tail_segment)
    forms = [e() + f() for e in ells for f in tails]
    scale = float(lib.abs().max())
    err = max(float((v - lib).abs().max()) for v in forms)
    if err > SPMM_RTOL * scale:
        raise AssertionError(f"SpMM vs torch.sparse.mm: {err} (scale "
                             f"{scale})")
    first = op(x)
    xr = x.clone().requires_grad_(True)

    def fwd_bwd():
        op(xr).backward(g)

    def ms(fn):
        return time_ms(fn, reps, device)

    out = {
        "ell_ms": ms(ells[0]),
        "ell_gather_ms": ms(ell_gather),
        "tail_ms": ms(tails[0]),
        "tail_segment_ms": ms(tail_segment),
        "apply_ms": ms(lambda: op(x)),
        "fwd_bwd_ms": ms(fwd_bwd),
        "library_ms": ms(lambda: torch.sparse.mm(csr, x)),
    }
    tail_rows = int(np.unique(graph.tail_rows.cpu().numpy()).shape[0])
    ell_bytes = n * k * (4 + 4) + n * k * d * 4 + n * d * 4
    tail_bytes = t * (4 + 4 + 4) + t * d * 4 + tail_rows * d * 4
    # every byte read or written once: x, the edges' columns and values,
    # the output (torch.sparse.mm comes under the gather bound above: the
    # rows it gathers come from L2 more than once)
    once_bytes = n * d * 4 + host.nnz * (4 + 4) + n * d * 4
    out.update(
        n=n, k=k, tail=t,
        bound_ms=(ell_bytes + tail_bytes) / HBM_BYTES_S * 1e3,
        once_bound_ms=once_bytes / HBM_BYTES_S * 1e3,
        ell_bound_ms=ell_bytes / HBM_BYTES_S * 1e3,
        tail_bound_ms=tail_bytes / HBM_BYTES_S * 1e3,
        max_abs_err=err, scale=scale,
        repeatable=bool(torch.equal(op(x), first)))
    return out
