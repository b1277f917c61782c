"""Build the port's CUDA sources with nvcc and bind them with ctypes.

One shared library with a plain C interface (no PyTorch headers, no
``torch.utils.cpp_extension``, no ninja): on an H100 host each source
builds in seconds, where a source including PyTorch's headers takes
minutes. The build runs once per process at first use, into
``coldrec_tpu_torch/_build/`` (ignored by git), under a file name keyed by
a hash of the sources, the headers and the flags, so a stale library is
never loaded. Every source compiles in its own ``nvcc``, all started
together, and one more ``nvcc`` links the objects; the finished library is
moved into place atomically, so no lock file is needed.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("retrieval.cu", "exp_retrieval_kernels.cu", "exp_multiacc.cu",
           "exp_blockskip.cu")
HEADERS = ("sweep_common.cuh", "sweep_tile.cuh", "mma_tile.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)
NVCC_TIMEOUT_S = 300


class CudaLaunchError(RuntimeError):
    """A CUDA error returned by one of the library's entry points: the
    launch was refused or the card is in an error state. Callers that
    recover from ordinary failures (``param_search``'s failed trials) let
    this one through."""


@dataclass
class BuildResult:
    path: Path
    seconds: float  # nvcc wall time; 0.0 when the library was already built
    ptxas: str  # nvcc's -Xptxas -v report ("" when already built)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise FileNotFoundError(
            "nvcc not found on PATH or in /usr/local/cuda/bin; the CUDA "
            "kernels build only on a host with the CUDA toolkit"
        )
    return nvcc


def find_cuobjdump() -> Optional[str]:
    tool = shutil.which("cuobjdump")
    if tool is None and os.path.exists("/usr/local/cuda/bin/cuobjdump"):
        tool = "/usr/local/cuda/bin/cuobjdump"
    return tool


def mma_counts(sass: str, kernel: str) -> Dict[str, int]:
    """For each function of a ``cuobjdump -sass`` listing whose (mangled)
    name contains ``kernel``: its tensor-core instructions (HMMA, HGMMA)."""
    out = {}
    for part in re.split(r"\n\s*Function : ", "\n" + sass)[1:]:
        name, _, body = part.partition("\n")
        if kernel in name:
            out[name.strip()] = len(re.findall(r"\bH(?:G)?MMA\.", body))
    return out


def function_names(symbols: str, kernel: str) -> list:
    """The (mangled) names of the functions in a ``cuobjdump -symbols``
    listing that contain ``kernel``, sorted, each once."""
    return sorted({line.split()[-1] for line in symbols.splitlines()
                   if "STT_FUNC" in line and kernel in line.split()[-1]})


def _cuobjdump(tool: str, *args: str) -> str:
    r = subprocess.run([tool, *args], capture_output=True, text=True,
                       timeout=NVCC_TIMEOUT_S)
    if r.returncode:
        raise RuntimeError(f"cuobjdump {' '.join(args[:-1])} failed "
                           f"({r.returncode}): {r.stderr}")
    return r.stdout


def sass_mma_counts(path: Path, kernel: str) -> Optional[Dict[str, int]]:
    """``mma_counts`` of the library at ``path`` (None without
    cuobjdump). Only the functions whose names contain ``kernel`` are
    disassembled, found first among the library's ELF symbols."""
    tool = find_cuobjdump()
    if tool is None:
        return None
    names = function_names(_cuobjdump(tool, "-symbols", str(path)), kernel)
    if not names:
        return {}
    return mma_counts(_cuobjdump(tool, "-sass", "-fun", ",".join(names),
                                 str(path)), kernel)


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcoldrec_tpu_torch_kernels_{h.hexdigest()[:16]}.so"


def _failed(cmd, rc, output) -> RuntimeError:
    return RuntimeError(
        f"nvcc failed with exit code {rc}:\n{' '.join(cmd)}\n{output}")


def build() -> BuildResult:
    """Compile the sources into the keyed library unless it exists."""
    out = library_path()
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    work.mkdir()
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = []
    try:
        for name in SOURCES:
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o",
                   str(work / f"{Path(name).stem}.o"), str(CSRC_DIR / name)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        reports, failures = [], []
        for cmd, proc in procs:
            output, _ = proc.communicate(
                timeout=max(1.0, NVCC_TIMEOUT_S - (time.perf_counter() - t0)))
            if proc.returncode != 0:
                failures.append(_failed(cmd, proc.returncode, output))
            reports.append(output.strip())
        if failures:  # every source's errors, not the first one's alone
            raise RuntimeError("\n".join(str(f) for f in failures))
        tmp = work / out.name
        cmd = [nvcc, "-shared", "-o", str(tmp),
               *(str(work / f"{Path(n).stem}.o") for n in SOURCES)]
        link = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
        if link.returncode != 0:
            raise _failed(cmd, link.returncode, link.stdout + link.stderr)
        os.replace(tmp, out)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return BuildResult(out, time.perf_counter() - t0, "\n".join(reports))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set every entry point's argtypes and restype on a loaded library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    signatures = {
        # pointers, then ints, then the stream
        "coldrec_fused_sweep": [vp] * 6 + [ci] * 4 + [vp],
        "coldrec_fused_sweep_bf16": [vp] * 6 + [ci] * 4 + [vp],
        "coldrec_merge_parts": [vp] * 6 + [ci] * 2 + [vp],
        "coldrec_dot_sweep": [vp] * 4 + [ci] * 5 + [vp],
        "coldrec_stream_sweep": [vp] * 6 + [ci] * 4 + [vp],
        "coldrec_multiacc_sweep": [vp] * 6 + [ci] * 5 + [vp],
        "coldrec_skip_sweep": [vp] * 7 + [ci] * 9 + [vp],
        # (d, cta_tile, cluster) -> resident clusters
        "coldrec_skip_max_clusters": [ci] * 3,
    }
    # the item ranges a sweep is split into: (n_users, d, i_pad) -> parts
    for name in ("coldrec_fused_sweep_parts", "coldrec_fused_sweep_bf16_parts",
                 "coldrec_dot_sweep_parts"):
        signatures[name] = [ci] * 3
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ci
    lib.coldrec_error_string.argtypes = [ci]
    lib.coldrec_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The built library with every function's argtypes and restype set."""
    return bind(ctypes.CDLL(str(build().path)))


def sweep_parts(name: str, device: torch.device, n_users: int, d: int,
                i_pad: int) -> int:
    """The number of item ranges the library's ``name`` (a
    ``*_sweep_parts`` function) splits a sweep of ``n_users`` into on
    ``device``: enough blocks to fill every SM."""
    lib = load_library()
    with torch.cuda.device(device):
        parts = getattr(lib, name)(n_users, d, i_pad)
    if parts < 1:
        raise CudaLaunchError(f"{name} failed: a CUDA error on {device}")
    return parts


def launch(name: str, device: torch.device, *args) -> None:
    """Call the library's entry point ``name`` on ``device``'s current
    stream (appended as the last argument) and raise if the launch returned
    a CUDA error: a refused launch never runs, and no later synchronise
    reports it."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err:
        raise CudaLaunchError(
            f"{name} launch failed: CUDA error {err} "
            f"({lib.coldrec_error_string(err).decode()})"
        )
