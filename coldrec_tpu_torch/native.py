"""ctypes bindings of the port's host C++: the negative sampler and FSGNN's
PPR push.

``csrc/host_sampler.cpp`` is the port's copy of the JAX package's native
sampler (its RNG, ``contains`` and ``sample_negatives``) and of its
forward-push PPR (``ppr_push_topk``). It is built with the host C++ compiler
at first use into ``coldrec_tpu_torch/_build/`` (ignored by git), under a
file name keyed by a hash of the source and the command, and moved into
place atomically, so concurrent first uses need no lock. A missing
compiler or a failed build raises: the numpy sampler draws other
negatives, and the dense PPR is hours on the host at book-crossing shape
and gives another graph, so nothing falls back quietly.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE = PACKAGE_DIR / "csrc" / "host_sampler.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
# the JAX package's native/Makefile flags without -march=native: a library
# built for one host's CPU may be copied to another's (the sampler is
# integer-only; the PPR's doubles take no fused multiply-add without it)
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
BUILD_TIMEOUT_S = 120


def compile_command(out: Path) -> List[str]:
    """The host C++ compiler's command that builds the host library into
    ``out``."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise FileNotFoundError(
            "no host C++ compiler (g++ or c++) on PATH to build the negative "
            "sampler and the PPR push")
    return [cxx, *CXX_FLAGS, "-o", str(out), str(SOURCE)]


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    cmd = compile_command(Path("out"))
    h.update(" ".join([os.path.basename(cmd[0])] + cmd[1:]).encode())
    return BUILD_DIR / f"libcoldrec_host_sampler_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the host library into its keyed file unless it exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = compile_command(tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(
                f"host sampler build failed with exit code {proc.returncode}:"
                f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The built sampler and PPR push with their argtypes set."""
    lib = ctypes.CDLL(str(build()))
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.sample_negatives.argtypes = [
        i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
        i64p, ctypes.c_int64, ctypes.c_uint64, i64p,
    ]
    lib.sample_negatives.restype = None
    lib.ppr_push_topk.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i32p, i64p, i32p,
        ctypes.c_double, ctypes.c_double, ctypes.c_int32, i32p,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.ppr_push_topk.restype = None
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def sample_negatives_native(
    indptr: np.ndarray,  # (n_users + 1,) training CSR by user
    items_sorted: np.ndarray,  # sorted item ids of each user's row
    users: np.ndarray,  # (n,) mapped user ids
    n_candidates: int,
    seed: int,
    pool: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(n,) int64 items drawn uniformly from [0, n_candidates) (or from
    ``pool``), each not rated by its user in training; the same draws as
    the JAX package's ``native.sample_negatives_native`` for one seed."""
    lib = load_library()
    users = np.ascontiguousarray(users, np.int64)
    indptr = np.ascontiguousarray(indptr, np.int64)
    items_sorted = np.ascontiguousarray(items_sorted, np.int64)
    n_rows = indptr.shape[0] - 1
    if users.size and (users.min() < 0 or users.max() >= n_rows):
        raise ValueError(f"user ids must lie in [0, {n_rows})")
    out = np.empty(users.shape[0], np.int64)
    if pool is not None:
        pool = np.ascontiguousarray(pool, np.int64)
        if pool.size == 0:
            raise ValueError("the candidate pool is empty")
        pool_ptr, pool_n = _ptr(pool), pool.shape[0]
    else:
        if n_candidates <= 0:
            raise ValueError(f"n_candidates must be positive, got "
                             f"{n_candidates}")
        pool_ptr, pool_n = _ptr(out), 0  # unused
    lib.sample_negatives(
        _ptr(indptr), _ptr(items_sorted), _ptr(users),
        users.shape[0], n_candidates, pool_ptr, pool_n,
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF), _ptr(out),
    )
    return out


def ppr_push_topk_native(
    indptr: np.ndarray,  # (n + 1,) graph CSR (users then items, self-loops)
    indices: np.ndarray,  # (nnz,) column ids
    nu: int,
    obs_indptr: np.ndarray,  # (nu + 1,) each user's observed items, CSR
    obs_items: np.ndarray,  # sorted item ids (0-based among items) per user
    alpha: float,
    eps: float,
    topk: int,
):
    """Forward-push approximate PPR from every user and each user's top-k
    unobserved items (threaded C++): (items (nu, topk) int32, pad -1;
    scores (nu, topk) float32, pad 0), the JAX package's
    ``native.ppr_push_topk_native`` for the same inputs."""
    lib = load_library()
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    obs_indptr = np.ascontiguousarray(obs_indptr, np.int64)
    obs_items = np.ascontiguousarray(obs_items, np.int32)
    n = indptr.shape[0] - 1
    if not 0 <= nu <= n or obs_indptr.shape[0] != nu + 1:
        raise ValueError(f"{nu} users do not fit a graph of {n} nodes and "
                         f"{obs_indptr.shape[0] - 1} observed rows")
    if indices.size and (indices.min() < 0 or indices.max() >= n):
        raise ValueError(f"column ids must lie in [0, {n})")
    if topk <= 0:
        raise ValueError(f"topk must be positive, got {topk}")
    out_items = np.empty((nu, topk), np.int32)
    out_vals = np.empty((nu, topk), np.float32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.ppr_push_topk(
        n, nu, _ptr(indptr), indices.ctypes.data_as(i32),
        _ptr(obs_indptr), obs_items.ctypes.data_as(i32),
        ctypes.c_double(alpha), ctypes.c_double(eps), ctypes.c_int32(topk),
        out_items.ctypes.data_as(i32),
        out_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out_items, out_vals
