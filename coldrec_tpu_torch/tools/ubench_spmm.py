"""The ELL SpMM's forms beside ``torch.sparse.mm`` and the byte bound, on
the card.

    python -m coldrec_tpu_torch.tools.ubench_spmm [--slabs ml,bc]
        [--n N --k K] [--d 64] [--iters 10] [--device cuda]

One tool for the JAX package's ``tools/ubench_spmm.py`` and
``tools/exp_spmm_layouts.py``. Each slab is an ELL matrix of ``make_ell``
(the JAX tool's, bit for bit: power-law row degrees capped at K, random
columns, weights 1/degree, pad entries column 0 weight 0): ``ml``, 9,728
rows x K=56 (MovieLens-like), and ``bc``, 346,112 rows x K=24
(book-crossing-like), times x, N(0,1) rows of width d from seed 2 (``--n``
and ``--k`` give one slab of that size instead). It times with CUDA events
(best of 3 runs of ``--iters`` calls after a warm-up):

  * ``ell_apply``: the port's apply (``ops/spmm.py``: one
    ``embedding_bag`` of N bags of K weighted rows);
  * ``A_einsum``: ``einsum("nk,nkd->nd")`` over the (N, K, d) gather;
  * ``B_unrolled``: the sum over k of K weighted (N, d) gathers;
  * ``C_loop_k``: a loop over k adding each weighted gather into one (N, d)
    accumulator, the columns stored (K, N);
  * ``D_mul_sum``: the (N, K, d) gather times the weights, summed over K;
  * ``sparse_mm``: ``torch.sparse.mm`` on the same matrix as CSR (its
    non-zero entries), the yardstick each form is held against
    (``SPMM_RTOL`` of its largest value);

each beside the byte bound of ``utils/timing.py::time_spmm`` (the slab's
columns and weights, each entry's gathered row and the output, at 3.35
TB/s) and the bound with each input read once. ``--device cpu`` runs them
on the CPU by the host clock, which is never a device time.
"""
from __future__ import annotations

import argparse
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops import spmm as spmm_mod
from ..utils.timing import (
    HBM_BYTES_S, SPMM_RTOL, clock_name, device_name, ell_bytes, time_ms,
)

SLABS = {"ml": (9_728, 56), "bc": (346_112, 24)}


def make_ell(n, k, seed):
    """The JAX tool's slab: (cols (n, k) int32, vals (n, k) float32)."""
    rng = np.random.default_rng(seed)
    # power-law-ish degrees truncated at k (ELL slab only)
    deg = np.minimum(rng.zipf(1.7, n) + 4, k)
    cols = np.zeros((n, k), np.int32)
    vals = np.zeros((n, k), np.float32)
    for start in range(0, n, 65536):
        stop = min(start + 65536, n)
        block = stop - start
        c = rng.integers(0, n, (block, k), dtype=np.int32)
        mask = np.arange(k)[None, :] < deg[start:stop, None]
        cols[start:stop] = np.where(mask, c, 0)
        vals[start:stop] = np.where(
            mask, 1.0 / np.maximum(deg[start:stop, None], 1), 0.0
        ).astype(np.float32)
    return cols, vals


def forms(cols: torch.Tensor, vals: torch.Tensor, n: int) -> dict:
    """{name: fn(x) -> A @ x} for the slab (cols int64 (N, K) and vals
    (N, K) on one device)."""
    k = cols.shape[1]
    graph = spmm_mod.EllGraph(
        ell_cols=cols, ell_vals=vals,
        tail_rows=cols.new_zeros(0), tail_cols=cols.new_zeros(0),
        tail_vals=vals.new_zeros(0), n_rows=n)
    cols_t, vals_t = cols.T.contiguous(), vals.T.contiguous()
    mask = (vals != 0).cpu().numpy()
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(mask.sum(axis=1), out=indptr[1:])
    dev = cols.device
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # CSR support "in beta state"
        csr = torch.sparse_csr_tensor(
            torch.as_tensor(indptr, device=dev),
            cols[torch.as_tensor(mask, device=dev)],
            vals[torch.as_tensor(mask, device=dev)], size=(n, n),
            check_invariants=False)

    def unrolled(x):
        out = vals[:, 0, None] * x[cols[:, 0]]
        for j in range(1, k):
            out = out + vals[:, j, None] * x[cols[:, j]]
        return out

    def loop_k(x):
        acc = torch.zeros_like(x)
        for j in range(k):
            acc.add_(x.index_select(0, cols_t[j]) * vals_t[j, :, None])
        return acc

    return {
        "ell_apply": lambda x: spmm_mod.ell_apply(graph, x),
        "A_einsum": lambda x: torch.einsum("nk,nkd->nd", vals, x[cols]),
        "B_unrolled": unrolled,
        "C_loop_k": loop_k,
        "D_mul_sum": lambda x: (vals[:, :, None] * x[cols]).sum(dim=1),
        "sparse_mm": lambda x: torch.sparse.mm(csr, x),
    }


def run_slab(device, name, n, k, d=64, iters=10) -> dict:
    """Every form of one slab: ms, max abs difference from
    ``torch.sparse.mm``, the bounds."""
    device = resolve_device(device)
    cols_h, vals_h = make_ell(n, k, seed=1)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (n, d)).astype(np.float32), device=device)
    cols = torch.as_tensor(cols_h, device=device).long()
    vals = torch.as_tensor(vals_h, device=device)
    fns = forms(cols, vals, n)
    ref = fns["sparse_mm"](x)
    scale = float(ref.abs().max())
    nnz = int((vals_h != 0).sum())
    gather = ell_bytes(n, k, d) / HBM_BYTES_S * 1e3
    once = (n * k * (4 + 4) + 2 * n * d * 4) / HBM_BYTES_S * 1e3
    res = {"n": n, "k": k, "d": d, "nnz": nnz, "bound_ms": gather,
           "once_bound_ms": once, "scale": scale, "forms": {}}
    print(f"slab {name}: n={n} k={k} d={d} nnz={nnz}; bound {gather:.4f} ms "
          f"(gathered rows), {once:.4f} ms (each input read once)",
          flush=True)
    for form, fn in fns.items():
        err = float((fn(x) - ref).abs().max())
        if err > SPMM_RTOL * scale:
            raise AssertionError(f"slab {name} {form} vs torch.sparse.mm: "
                                 f"{err} (scale {scale})")
        ms = time_ms(lambda: fn(x), iters, device)
        res["forms"][form] = {"ms": ms, "max_abs_err": err,
                              "of_bound": gather / ms}
        print(f"  {form:<10s} {ms:9.4f} ms  {gather / ms:6.3f} of the "
              f"bound  max abs diff {err:.2e}", flush=True)
    return res


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--slabs", default="ml,bc")
    p.add_argument("--n", type=int, default=0)
    p.add_argument("--k", type=int, default=0)
    p.add_argument("--d", type=int, default=64)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    slabs = ({"custom": (a.n, a.k)} if a.n else
             {s: SLABS[s] for s in a.slabs.split(",") if s})
    print(f"device={device_name(device)} clock={clock_name(device)}",
          flush=True)
    return {s: run_slab(device, s, n, k, a.d, a.iters)
            for s, (n, k) in slabs.items()}


if __name__ == "__main__":
    main()
