"""Tile shapes of the retrieval sweep and of its dot ceiling, on the card.

The port's tuning tool for ``csrc/sweep_tile.cuh``. It builds the kernel
library once per pair of shapes, with the ``using Sweep = Shape<...>``
(``retrieval.cu``) and ``using DotTile = tile::Shape<...>``
(``exp_retrieval_kernels.cu``) lines replaced and every other line as
committed, holds each build's ``fused_sweep`` and ``dot_sweep`` bit for bit
to their plain versions on integer tables, and times them with CUDA events
on N(0,1) tables: ``fused_sweep`` at ``--users`` and at 512 users (25% of
the items excluded), ``dot_sweep`` on the (d, I) table. Each row also
prints the kernels' registers and spill bytes from ``nvcc -Xptxas -v``.

Usage:
    python -m coldrec_tpu_torch.tools.tile_shapes [--fused S ...] [--dot S ...]
        [--users 2048] [--items 270170] [--dim 64] [--iters 10]

A shape S is TU,RU,RI,LI,GS,DC,STAGES (``sweep_tile.cuh::Shape``). The
i-th ``--fused`` shape is built with the i-th ``--dot`` shape (the shorter
list repeats its last entry); the first pair defaults to the committed
shapes. Builds go to ``coldrec_tpu_torch/_build/shapes/``.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple
from unittest import mock

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cuda import build as kbuild
from ..ops.cuda import retrieval as ret
from . import exp_retrieval_kernels as erk

SHAPE_LINES = {
    "retrieval.cu": re.compile(r"using Sweep = Shape<[^>]*>;"),
    "exp_retrieval_kernels.cu": re.compile(
        r"using DotTile = tile::Shape<[^>]*>;"),
}
SERVE_USERS = 512


def committed_shapes() -> Tuple[str, str]:
    """(fused, dot) shapes as the sources hold them, "TU,RU,...,STAGES"."""
    out = []
    for name, pat in SHAPE_LINES.items():
        m = pat.search((kbuild.CSRC_DIR / name).read_text())
        if m is None:
            raise ValueError(f"{name}: no shape line")
        out.append(m.group(0).split("<")[1].split(">")[0].replace(" ", ""))
    return out[0], out[1]


def shape_sources(fused: str, dot: str) -> Dict[str, str]:
    """The sources of one build: the shape lines replaced."""
    texts = {name: (kbuild.CSRC_DIR / name).read_text()
             for name in kbuild.SOURCES + kbuild.HEADERS}
    for name, shape in (("retrieval.cu", fused),
                        ("exp_retrieval_kernels.cu", dot)):
        if len(shape.split(",")) != 7:
            raise ValueError(f"shape {shape!r}: TU,RU,RI,LI,GS,DC,STAGES")
        prefix = "using Sweep = Shape<" if name == "retrieval.cu" else \
            "using DotTile = tile::Shape<"
        texts[name], n = SHAPE_LINES[name].subn(
            f"{prefix}{shape.replace(',', ', ')}>;", texts[name])
        if n != 1:
            raise ValueError(f"{name}: no shape line")
    return texts


def build_shapes(pairs: Sequence[Tuple[str, str]]):
    """One library per (fused, dot) pair, built in parallel: [(path, nvcc
    report)]."""
    nvcc = kbuild.find_nvcc()
    root = kbuild.BUILD_DIR / "shapes"
    shutil.rmtree(root, ignore_errors=True)
    procs = []
    for i, (fused, dot) in enumerate(pairs):
        work = root / f"s{i}"
        work.mkdir(parents=True)
        for name, text in shape_sources(fused, dot).items():
            (work / name).write_text(text)
        cmd = [nvcc, *kbuild.NVCC_FLAGS, "-shared", "-o",
               str(work / "lib.so"),
               *(str(work / name) for name in kbuild.SOURCES)]
        procs.append((work, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    out = []
    for work, cmd, proc in procs:
        report, _ = proc.communicate(timeout=kbuild.NVCC_TIMEOUT_S)
        if proc.returncode:
            raise kbuild._failed(cmd, proc.returncode, report)
        out.append((work / "lib.so", report))
    return out


def registers(report: str, kernel: str) -> str:
    """"regs/spill bytes" of each instance of ``kernel`` in an nvcc
    -Xptxas -v report."""
    found = re.findall(
        rf"Compiling entry function '\w*{kernel}\w*'.*?\n.*?\n\s+\d+ bytes "
        r"stack frame, (\d+) bytes spill stores.*?\n.*?Used (\d+) registers",
        report)
    return " ".join(f"{r}/{s}" for s, r in found)


def _int_tables(device, n_users, n_items, d, seed=0):
    rng = np.random.default_rng(seed)
    users = torch.as_tensor(rng.integers(-64, 65, (n_users, d)).astype(
        np.float32), device=device)
    items = torch.as_tensor(rng.integers(-64, 65, (n_items, d)).astype(
        np.float32), device=device)
    excl = torch.as_tensor(rng.random(n_items) < 0.25, device=device)
    return users, items, excl


def _normal_tables(device, n_users, n_items, d, seed=1):
    rng = np.random.default_rng(seed)
    users = torch.as_tensor(rng.standard_normal((n_users, d),
                                                dtype=np.float32),
                            device=device)
    items = torch.as_tensor(rng.standard_normal((n_items, d),
                                                dtype=np.float32),
                            device=device)
    excl = torch.as_tensor(rng.random(n_items) < 0.25, device=device)
    return users, items, excl


def run(pairs: Sequence[Tuple[str, str]], n_users=2048, n_items=270_170,
        d=64, iters=10, device="cuda") -> List[dict]:
    """Build, check and time every pair; one dict per pair."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"tile_shapes times kernels on a card, not on "
                           f"{device}")
    libs = build_shapes(pairs)
    ui, ii, ei = _int_tables(device, n_users, n_items, d)
    it_i, ex_i = ret.pad_items(ii, ei)
    ref = ret.fused_sweep_reference(ui, it_i, ex_i)
    dref = erk.dot_sweep_reference(ui, it_i, True)
    un, inn, en = _normal_tables(device, n_users, n_items, d)
    it_n, ex_n = ret.pad_items(inn, en)
    serve = un[:SERVE_USERS].contiguous()
    rows = []
    for (fused, dot), (path, report) in zip(pairs, libs):
        lib = kbuild.bind(ctypes.CDLL(str(path)))
        with mock.patch.object(kbuild, "load_library", lambda: lib):
            exact = all(torch.equal(g, r) for g, r in zip(
                ret.fused_sweep(ui, it_i, ex_i), ref)) and torch.equal(
                erk.dot_sweep(ui, it_i, True), dref)
            row = {
                "fused": fused, "dot": dot, "exact": exact,
                "fused_ms": erk.time_ms(
                    lambda: ret.fused_sweep(un, it_n, ex_n), iters, device),
                "fused_serve_ms": erk.time_ms(
                    lambda: ret.fused_sweep(serve, it_n, ex_n), iters,
                    device),
                "dot_ms": erk.time_ms(
                    lambda: erk.dot_sweep(un, it_n, True), iters, device),
                "fused_regs": registers(report, "fused_sweep_kernel"),
                "dot_regs": registers(report, "dot_sweep_kernel"),
            }
        rows.append(row)
        print(f"fused {fused:>22} dot {dot:>22}: exact {exact}; fused "
              f"{row['fused_ms']:.3f} ms ({n_users} users), "
              f"{row['fused_serve_ms']:.3f} ms ({SERVE_USERS}); dot "
              f"{row['dot_ms']:.3f} ms; regs/spill fused "
              f"[{row['fused_regs']}] dot [{row['dot_regs']}]", flush=True)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--fused", nargs="*", default=None)
    p.add_argument("--dot", nargs="*", default=None)
    p.add_argument("--users", type=int, default=2048)
    p.add_argument("--items", type=int, default=270_170)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    fused0, dot0 = committed_shapes()
    fused = a.fused or [fused0]
    dot = a.dot or [dot0]
    n = max(len(fused), len(dot))
    pairs = [(fused[min(i, len(fused) - 1)], dot[min(i, len(dot) - 1)])
             for i in range(n)]
    return run(pairs, a.users, a.items, a.dim, a.iters, device)


if __name__ == "__main__":
    main()
