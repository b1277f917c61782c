"""The process group: who this rank is, its device, and the raw collectives.

The port's counterpart of ``coldrec_tpu/parallel/distributed.py``. One
module owns all process-group plumbing so the rest of the port stays
topology-agnostic:

  * :func:`init_distributed` opens ``torch.distributed`` (``tcp://`` init)
    when the ``COLDREC_COORDINATOR`` / ``COLDREC_NUM_PROCESSES`` /
    ``COLDREC_PROCESS_ID`` variables (or explicit arguments) configure a
    group; with none of them set it stays single-process. ``main.run``
    calls it before any device use. The backend follows one rule
    (:func:`choose_backend`) and the choice is logged.
  * :func:`rank_device`: a rank asked for ``cuda`` computes on
    ``cuda:(process_id % torch.cuda.device_count())``; several ranks may
    share one card.
  * :func:`all_reduce` / :func:`all_gather` own the raw collectives.
    Under gloo a CUDA tensor is staged through host memory explicitly
    (:func:`host_staging` counts the seconds and bytes); nothing relies on
    gloo accepting CUDA tensors. :func:`run_collective` counts the calls
    and the seconds spent in them (waiting for the other ranks included).
  * :func:`host_block` and :func:`localize`, the counterparts of
    ``host_to_global`` and ``localize``: take this rank's row block of a
    host array; all-gather row blocks into the full table.
  * :func:`partition_chunks` / :func:`allgather_host` split the eval's user
    chunks round robin over the processes and merge their lists.
  * :func:`shutdown_distributed`: a barrier, then ``destroy_process_group``,
    so no rank exits while another still waits on it.
  * :func:`launch_ranks` starts a command as N ranks on this host (the
    variables set, a free port for rank 0) and waits for all of them; the
    first rank to fail stops the others.

A group given as ``None`` stands for an axis of size 1: the collectives
return their input. Every collective here is blocking.
"""
from __future__ import annotations

import datetime
import os
import random
import socket
import subprocess
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this raises (a rank that died leaves
# the others waiting on it)
TIMEOUT_S = 600


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> bool:
    """Open the process group when configured; returns True if a
    multi-process group is active. ``coordinator_address`` is
    ``host:port`` of rank 0; ``device`` the device the ranks were asked
    for (it decides the backend)."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "COLDREC_COORDINATOR")
    if num_processes is None and os.environ.get("COLDREC_NUM_PROCESSES"):
        num_processes = int(os.environ["COLDREC_NUM_PROCESSES"])
    if process_id is None and os.environ.get("COLDREC_PROCESS_ID"):
        process_id = int(os.environ["COLDREC_PROCESS_ID"])
    if not coordinator_address and num_processes is None:
        return False  # single process
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError(
            "a process group needs COLDREC_COORDINATOR (host:port), "
            "COLDREC_NUM_PROCESSES and COLDREC_PROCESS_ID, got "
            f"{coordinator_address!r}, {num_processes}, {process_id}")
    backend, why = choose_backend(device, num_processes)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    print(f"process group: rank {process_id} of {num_processes}, backend "
          f"{backend} ({why}), device {rank_device(device)}", flush=True)
    return True


def choose_backend(device: str, num_processes: int):
    """(backend, reason): gloo on the CPU and where ranks share a card;
    nccl only where each rank owns its own card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    if num_processes > cards:
        return "gloo", f"{num_processes} ranks share {cards} card(s)"
    return "nccl", f"each of {num_processes} ranks owns a card"


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: ``cuda`` without an index becomes
    ``cuda:(rank % device_count)`` in a group; anything else is kept."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        return torch.device("cuda", process_index()
                            % max(torch.cuda.device_count(), 1))
    return dev


def shutdown_distributed() -> None:
    """Barrier, then destroy the group (no-op without one)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


# ------------------------------------------------------------ collectives
def _staged() -> bool:
    return dist.get_backend() == "gloo"


def host_staging(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host, for a gloo collective (a CPU tensor as it is);
    the seconds and bytes of the copies add up in ``host_staging.seconds``
    / ``.bytes``: the copy to the host after the device's earlier work, and
    the enqueue of the copy back (:func:`_unstage`)."""
    if t.device.type == "cpu":
        return t.contiguous()
    if t.device.type == "cuda":  # the copy alone, not the work before it
        torch.cuda.synchronize(t.device)
    start = time.perf_counter()
    host = t.detach().to("cpu").contiguous()
    host_staging.seconds += time.perf_counter() - start
    host_staging.bytes += host.numel() * host.element_size()
    return host


host_staging.seconds = 0.0
host_staging.bytes = 0


def _unstage(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.device.type == "cpu":
        return host
    start = time.perf_counter()
    out = host.to(like.device)
    host_staging.seconds += time.perf_counter() - start
    host_staging.bytes += host.numel() * host.element_size()
    return out


def run_collective(op, *args, **kwargs) -> None:
    """``op(*args, **kwargs)`` (a ``torch.distributed`` collective); its
    seconds add up in ``run_collective.seconds`` and its calls in
    ``.calls`` (under nccl the seconds are the enqueue's)."""
    start = time.perf_counter()
    op(*args, **kwargs)
    run_collective.seconds += time.perf_counter() - start
    run_collective.calls += 1


run_collective.seconds = 0.0
run_collective.calls = 0


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (a new tensor; ``t`` itself where
    the group is ``None``)."""
    if group is None:
        return t
    if _staged():
        buf = host_staging(t).clone()
        run_collective(dist.all_reduce, buf, group=group)
        return _unstage(buf, t)
    buf = t.detach().clone()
    run_collective(dist.all_reduce, buf, group=group)
    return buf


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors (of one shape) concatenated along ``dim``, in
    group-rank order (``t`` itself where the group is ``None``)."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = host_staging(t) if _staged() else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    run_collective(dist.all_gather, parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return _unstage(out, t) if _staged() else out


def group_rank(group) -> int:
    """This rank's index in ``group`` (0 where the group is ``None``)."""
    return 0 if group is None else dist.get_rank(group)


def barrier() -> None:
    if is_multiprocess():
        dist.barrier()


# ------------------------------------------------------------ placement
def host_block(x, n_parts: int, index: int):
    """Row block ``index`` of ``n_parts`` equal blocks of ``x`` (the
    counterpart of ``host_to_global``: each rank keeps its own rows)."""
    n = x.shape[0]
    if n % n_parts:
        raise ValueError(f"{n} rows do not split into {n_parts} blocks")
    rows = n // n_parts
    return x[index * rows:(index + 1) * rows]


def localize(x: torch.Tensor, group) -> torch.Tensor:
    """Row blocks of ``group`` gathered into the full table (no gradient;
    ``x`` where the group is ``None``)."""
    return all_gather(x, group, dim=0)


def partition_chunks(n_chunks: int):
    """Round-robin chunk indices owned by this process: ([pi, pi+pc, ...],
    pc, pi)."""
    pc, pi = process_count(), process_index()
    return list(range(pi, n_chunks, pc)), pc, pi


def allgather_host(local: np.ndarray) -> np.ndarray:
    """One equal-shape host array per process -> (pc, *shape)."""
    if not is_multiprocess():
        return np.asarray(local)[None]
    t = torch.from_numpy(np.ascontiguousarray(local))
    parts: List[torch.Tensor] = [torch.empty_like(t)
                                 for _ in range(process_count())]
    if _staged():
        run_collective(dist.all_gather, parts, t)
        return np.stack([p.numpy() for p in parts])
    dev = rank_device("cuda")
    dparts = [p.to(dev) for p in parts]
    run_collective(dist.all_gather, dparts, t.to(dev))
    return np.stack([p.cpu().numpy() for p in dparts])


# ------------------------------------------------------------ launching
def free_port() -> int:
    """A TCP port on localhost that was free a moment ago, drawn below the
    kernel's ephemeral range: a port the kernel numbers itself (as gloo's
    connections of a group starting beside this one are) could take it
    between this check and the coordinator's bind."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            first = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        first = 32768
    rng = random.Random()
    for _ in range(64):
        port = rng.randrange(max(1024, first - 16384), first)
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
            return port
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(cmd: Sequence[str], n: int, timeout: float = 600,
                 env: Optional[dict] = None, cwd: Optional[str] = None):
    """Run ``cmd`` as ranks 0..n-1 of one process group on localhost;
    returns each rank's (exit code, output). The first rank that exits
    non-zero stops the others (they return -9); the deadline stops all and
    raises ``TimeoutError`` with rank 0's last output. Every rank has
    ended when this returns."""
    port = free_port()
    base = dict(os.environ if env is None else env)
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(n)]
        procs, timed_out = [], False
        try:
            for r in range(n):
                procs.append(subprocess.Popen(
                    list(cmd), cwd=cwd, stdout=logs[r],
                    stderr=subprocess.STDOUT, text=True,
                    env={**base, "COLDREC_COORDINATOR": f"localhost:{port}",
                         "COLDREC_NUM_PROCESSES": str(n),
                         "COLDREC_PROCESS_ID": str(r)}))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs) and not timed_out:
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                timed_out = time.monotonic() > deadline
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            outs = []
            for f in logs:
                f.seek(0)
                outs.append(f.read())
                f.close()
    if timed_out:
        raise TimeoutError(f"{n} ranks of {list(cmd)} passed {timeout} s; "
                           f"rank 0 printed:\n{outs[0][-3000:]}")
    return [(p.returncode, out) for p, out in zip(procs, outs)]
