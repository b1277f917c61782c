#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``coldrec_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed with its seconds:
  1. device   the card's name and power limit (nvidia-smi) and torch's name;
  2. build    nvcc builds the kernels from ``coldrec_tpu_torch/csrc``;
  3. kernel   the retrieval kernel against its plain PyTorch version at
              d=64 on 2048 users x 270,170 items (kernel-bx) and 2048 x
              3,706 items (kernel-ml): the candidate values and ghosts agree
              within ``VALUE_TOL``, every non-candidate scores <= the user's
              max ghost, and the final top-k ids equal the exact plain
              path's on every row whose top-(k+1) scores are separated by
              more than ``GAP_REL``; kernel-ml adds an integer table with
              NaN item rows (bit-equal, NaN at the same places; no NaN in a
              slot, and the ghost NaN exactly in the lane classes of NaN
              items that are not excluded);
  4. kernel-int  integer tables at 2048 and at 512 users x 270,170 items:
              the sweep (split into parts and merged at 512) bit for bit
              equal to its plain version, and the merge kernel equal to its
              plain version on the plain per-part sweeps;
  5. slice    the main path at book-crossing shape: MF tables written to the
              npz bus, served through ``RetrievalServer`` (8 requests of 512
              users, then raw ids) and three-way tested through
              ``EvalSweep.run_kernel``; the same lists through the plain path
              must agree by the rule of phase 3, and both kernels (sweep and
              merge) must have launched (launch counts are zeroed just before
              the main path); then the steps of ``retrieval_topk`` after the
              kernel timed on their own for the overall test setting;
  6. variants the kernel-variant experiments (``coldrec_tpu_torch/tools``):
              first their path, driven through the tools' entry points with
              every launch count zeroed just before and read just after
              (``exp_retrieval_kernels.main`` at the tools' width of 2048
              users x 270,336 items, ``exp_multiacc.check`` and one
              ``exp_blockskip.check_exact`` regime at a small size); then
              every variant kernel held bit for bit against its own plain
              version on integer tables at that width: dot in both layouts,
              stream at block_i 2048 and 8192, multiacc at P = 1, 2, 4, 8,
              skip at tile_u 64 and 256 with floors rv[0] and rv[7], and a
              table on which skips fire (count > 0 and equal); then on an
              integer table with NaN item rows (NaN equal to NaN at the
              same places): dot in both layouts, stream at both block_i,
              multiacc at every P at block_i 8192 and at 384 (3 slices, no
              multiple of P > 1), skip at both tile_u;
  7. timing   CUDA-event times of one sweep of every kernel (2048 users, and
              the 512-user serving request for the sweep and the merge): the
              kernel, its plain version and one library yardstick, beside
              the least time the card could take. The merge is timed alone
              as well (100 launches in one CUDA graph: its device time) at
              512 users x the kernel's parts and 2048 users x 2 parts;
              timing-variants first logs each kernel's registers and spill
              bytes (the build's ``-Xptxas -v``), the skip kernel's
              resident clusters per layout, and every P and tile_u time.

Then it prints the ``{"kernels": [...]}`` line, the nvidia-smi line, and as
the last line ``{"ok": true, "device": {...}}``. Any failure raises, so the
exit code is non-zero and no result line is printed. With no card it exits
non-zero at once. The whole run is held to ``BUDGET_S`` seconds.

The phase functions take a ``device`` argument so that the tests can
rehearse them on the CPU at a tiny size, where the kernel wrapper computes
its plain version.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from coldrec_tpu_torch.models.mf import MF
from coldrec_tpu_torch.ops.cuda import build as kbuild
from coldrec_tpu_torch.ops.cuda import retrieval as ret
from coldrec_tpu_torch.ops.cuda.retrieval import (
    CANDIDATES, INIT_NEG, LANES, SLOTS, USER_CHUNK, fused_sweep,
    fused_sweep_reference, merge_parts, merge_parts_reference, pad_items,
    retrieval_topk, sweep_parts_reference,
)
from coldrec_tpu_torch.runtime.checkpoints import save_embeddings
from coldrec_tpu_torch.runtime.eval import EvalSweep, exact_scores, masked_topk
from coldrec_tpu_torch.runtime.serving import RetrievalServer
from coldrec_tpu_torch.runtime.trainer import SETTING_SPLITS, three_way_test
from coldrec_tpu_torch.tools import exp_blockskip as ebs
from coldrec_tpu_torch.tools import exp_multiacc as ema
from coldrec_tpu_torch.tools import exp_retrieval_kernels as erk
from coldrec_tpu_torch.tools import tile_shapes

BUDGET_S = 600.0  # the whole run, half of the 1200 s it may take at most
D = 64  # MF emb_size (BASELINE default)
K = 20
RATED_WIDTH = 32
# Book-crossing (reference data/README.md:9, BASELINE.md): users, items,
# interactions; MovieLens-1M item count for the narrow kernel shape.
BX = (92_107, 270_170, 1_031_175)
ML_ITEMS = 3_706
# fp32 sums taken in another order (the kernel's FFMA chain vs cuBLAS or the
# CPU's blocked product): at d=64 with N(0,1) inputs the scores reach ~40
# and the reordering error stays below 64 * 2^-24 * 40 ~ 1.5e-4.
VALUE_TOL = 1e-3
GAP_REL = 1e-5  # rows separated by less than this may swap ids at a tie
# The kernel-variant experiments' width (the JAX tools' default): 33 x 8192,
# book-crossing's 270,170 items rounded up to the block.
VAR_ITEMS = 270_336
VAR_BLOCKS = (2048, 8192)  # exp_retrieval_kernels' block_i, the others'
VAR_TILES = (64, 256)  # exp_blockskip's tile_u grid
INT_MAX = 64  # integer tables in [-64, 64]: every d=64 sum is exact in fp32
# NaN item rows of the variants' NaN table, beside random ones: 259 is lane
# class 3 in slice 2 of the first block of 384 items or more (the finite
# candidates of slices 0 and 1 come ahead of it), 650 lies in slice 2 of
# the second 384-item block, which starts at an odd item group, and 1283 is
# a second NaN of class 3.
NAN_ROWS = (259, 650, 1029, 1283)
ODD_BLOCK = 384  # 3 slices a block: no multiple of P > 1
SERVE_USERS = 512  # users per serving request
CLOCKS = "clocks.sm,power.draw"  # logged around the variants' times
WRAPPERS = {
    "fused_sweep": fused_sweep,
    "merge_parts": merge_parts,
    "dot_sweep": erk.dot_sweep,
    "stream_sweep": erk.stream_sweep,
    "multiacc_sweep": ema.multiacc_sweep,
    "skip_sweep": ebs.skip_sweep,
}
VARIANTS = ("dot_sweep", "stream_sweep", "multiacc_sweep", "skip_sweep")
T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def check_budget(name: str) -> None:
    spent = time.perf_counter() - T0
    if spent > BUDGET_S:
        raise TimeoutError(f"{name}: {spent:.1f} s spent, budget {BUDGET_S} s")


def run_phase(name: str, fn, *args, **kwargs):
    t = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"[phase {name}] {time.perf_counter() - t:.2f} s")
    check_budget(name)
    return out


def smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_launches() -> None:
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def launch_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in WRAPPERS.items()}


# ------------------------------------------------------------------ checks
def compare_lists(ue, ie, users, ids_a, ids_b, gap_rel=GAP_REL):
    """Hold two ranked id lists for the same users to each other.

    Rows must be id-equal unless they differ only at near-ties: there the
    exact scores at both lists must agree position by position within
    ``gap_rel`` of the row's top score. Returns (rows, id-equal rows)."""
    ids_a = np.asarray(ids_a)
    ids_b = np.asarray(ids_b)
    if ids_a.shape != ids_b.shape:
        raise AssertionError(f"list shapes {ids_a.shape} != {ids_b.shape}")
    same = (ids_a == ids_b).all(axis=1)
    bad = np.flatnonzero(~same)
    if bad.size:
        dev = ue.device
        u = ue[torch.as_tensor(np.asarray(users)[bad], device=dev).long()]
        sa = (u[:, None, :] * ie[torch.as_tensor(ids_a[bad], device=dev)
                                 .long()]).sum(-1)
        sb = (u[:, None, :] * ie[torch.as_tensor(ids_b[bad], device=dev)
                                 .long()]).sum(-1)
        scale = torch.maximum(sa.abs().amax(1), sb.abs().amax(1))[:, None]
        off = ((sa - sb).abs() > gap_rel * scale + 1e-30).any(dim=1)
        if bool(off.any()):
            r = int(bad[int(off.nonzero()[0, 0])])
            raise AssertionError(
                f"row {r}: lists differ beyond near-ties: "
                f"{ids_a[r][:8]} vs {ids_b[r][:8]}"
            )
    return int(same.shape[0]), int(same.sum())


def kernel_vs_plain(device, n_users, n_items, d=D, k=K, r=RATED_WIDTH,
                    seed=0, chunk=512):
    """Phase 3 at one shape; returns the max abs error and row counts."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    users = torch.as_tensor(
        rng.standard_normal((n_users, d), dtype=np.float32), device=device)
    items = torch.as_tensor(
        rng.standard_normal((n_items, d), dtype=np.float32), device=device)
    excluded = np.zeros(n_items, bool)
    excluded[rng.choice(n_items, n_items // 4, replace=False)] = True
    rated = np.full((n_users, r), n_items, np.int32)
    counts = rng.integers(0, r + 1, n_users)
    for u in range(n_users):
        rated[u, :counts[u]] = rng.choice(n_items, counts[u], replace=False)
    excl_t = torch.as_tensor(excluded, device=device)
    items_t, excl_row = pad_items(items, excl_t)

    cv, ci, gh = fused_sweep(users, items_t, excl_row)
    rv, ri, rg = fused_sweep_reference(users, items_t, excl_row)
    _sync(device)
    err = max(float((cv - rv).abs().max()), float((gh - rg).abs().max()))
    if not err <= VALUE_TOL:
        raise AssertionError(f"kernel vs plain: max abs err {err}")
    id_equal = float((ci == ri).float().mean())

    # the ghost contract against the plain full scores
    worst = -np.inf
    for s in range(0, n_users, chunk):
        e = min(n_users, s + chunk)
        z = exact_scores(users[s:e], items_t.T).masked_fill(
            excl_row.bool()[None, :], -10e8)
        # slots a class with < SLOTS items never filled hold INIT_NEG and
        # id 0; point them at slot 0 of class 0, which always holds a real
        # candidate
        filled = cv[s:e] > INIT_NEG
        cid = torch.where(filled, ci[s:e], ci[s:e, :1]).long()
        at = z.gather(1, cid)
        if not float((at - cv[s:e]).abs()[filled].max()) <= VALUE_TOL:
            raise AssertionError("candidate values are not their scores")
        z.scatter_(1, cid, -float("inf"))
        over = z.max(dim=1).values - gh[s:e].max(dim=1).values
        worst = max(worst, float(over.max()))
    if not worst <= VALUE_TOL:
        raise AssertionError(f"a non-candidate beats the ghost by {worst}")

    vals, ids = retrieval_topk(users, items, rated, excluded, k, device=device)
    plain = []
    rated_t = torch.as_tensor(rated, device=device)
    for s in range(0, n_users, chunk):
        e = min(n_users, s + chunk)
        _, pi = masked_topk(exact_scores(users[s:e], items), rated_t[s:e],
                            excl_t, k)
        plain.append(pi.cpu().numpy())
    rows, equal = compare_lists(users, items, np.arange(n_users), ids,
                                np.concatenate(plain))
    log(f"  kernel {n_users}x{n_items} d={d}: max_abs_err={err:.3e} "
        f"candidate ids equal {id_equal:.6f}, ghost margin {worst:.3e}, "
        f"top-{k} rows id-equal {equal}/{rows} (others near-ties)")
    return {"max_abs_err": err, "rows": rows, "id_equal_rows": equal}


def same(got, ref) -> bool:
    """Bit for bit equal, NaN equal to NaN at the same places
    (``torch.equal`` is False on any NaN)."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        return False
    if not got.is_floating_point():
        return torch.equal(got, ref)
    nan = got.isnan()
    return torch.equal(nan, ref.isnan()) and torch.equal(got[~nan],
                                                         ref[~nan])


def hold_equal(name, got, ref):
    """Raise unless every output equals its plain version bit for bit
    (NaN at the same places); returns the max abs difference over the
    numbers (0.0)."""
    err = 0.0
    for g, r in zip(got, ref):
        diff = (g.double() - r.double()).abs()
        diff = diff[diff == diff]
        worst = float(diff.max()) if diff.numel() else 0.0
        if not same(g, r):
            raise AssertionError(
                f"{name}: kernel differs from its plain version (max abs "
                f"err {worst}, NaN places equal: "
                f"{torch.equal(g.isnan(), r.isnan())})")
        err = max(err, worst)
    return err


def sweep_parts_on(device, n_users, d, i_pad):
    """The item ranges the kernel splits this sweep into (on the CPU, where
    the wrapper computes its plain version, 4 to rehearse the merge)."""
    if device.type != "cuda":
        return 4
    return kbuild.sweep_parts("coldrec_fused_sweep_parts", device, n_users,
                              d, i_pad)


def exact_sweep_check(device, n_users, n_items, d=D, seed=3, nan_items=0):
    """``fused_sweep`` bit for bit against its plain version on integer
    tables (every sum exact, many ties) with 20% of the items excluded and,
    with ``nan_items``, that many NaN item rows (three in one lane class),
    whose lane classes' ghosts must be NaN;
    then the merge kernel against its plain version on the plain per-part
    sweeps, at the kernel's part count for this batch (at least 2)."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    ue = rng.integers(-INT_MAX, INT_MAX + 1, (n_users, d)).astype(np.float32)
    ie = rng.integers(-INT_MAX, INT_MAX + 1, (n_items, d)).astype(np.float32)
    nan_rows = np.zeros(0, np.int64)
    if nan_items:
        nan_rows = np.unique(np.concatenate([
            rng.choice(n_items, nan_items, replace=False), [5, 133, 261]]))
        ie[nan_rows] = np.nan
    excluded = rng.random(n_items) < 0.2
    users = torch.as_tensor(ue, device=device)
    items_t, excl_row = pad_items(torch.as_tensor(ie, device=device),
                                  torch.as_tensor(excluded, device=device))
    got = fused_sweep(users, items_t, excl_row)
    err = hold_equal("fused_sweep", got,
                     fused_sweep_reference(users, items_t, excl_row))
    if bool(got[0].isnan().any()):
        raise AssertionError("a NaN score reached a slot")
    nan_class = torch.zeros(LANES, dtype=torch.bool, device=device)
    live_nan = nan_rows[~excluded[nan_rows]]
    nan_class[torch.as_tensor(live_nan % LANES, device=device)] = True
    if not torch.equal(got[2].isnan(), nan_class.expand_as(got[2])):
        raise AssertionError("the NaN ghosts are not the NaN items' classes")
    # an excluded item scores NEG, NaN or not; any other NaN item is dropped
    filled = got[1][got[0] > INIT_NEG].cpu().numpy()
    if np.isin(filled, nan_rows[~excluded[nan_rows]]).any():
        raise AssertionError("a NaN item is a candidate")
    parts = max(2, sweep_parts_on(device, n_users, d, items_t.shape[1]))
    pv, pi, pg = sweep_parts_reference(users, items_t, excl_row, parts)
    merr = hold_equal("merge_parts", merge_parts(pv, pi, pg),
                      merge_parts_reference(pv, pi, pg))
    _sync(device)
    log(f"  integer table {n_users}x{n_items} d={d}, {len(nan_rows)} NaN "
        f"items ({int(nan_class.sum())} NaN ghost classes): fused_sweep "
        f"bit-equal to its plain version; merge_parts bit-equal at {parts} "
        f"parts")
    return {"fused_sweep": err, "merge_parts": merr}


def kernel_ml(device, n_users=2048, n_items=ML_ITEMS):
    """Phase kernel-ml: the N(0,1) check of phase 3 and the NaN table."""
    out = kernel_vs_plain(device, n_users, n_items)
    exact = exact_sweep_check(device, n_users, n_items, nan_items=200)
    return {"max_abs_err": max(out["max_abs_err"], exact["fused_sweep"]),
            "merge_err": exact["merge_parts"]}


def kernel_int(device, n_items=BX[1], sizes=(2048, SERVE_USERS)):
    """Phase kernel-int: integer tables at the eval chunk and the serving
    shape (where the sweep is split and merged)."""
    errs = [exact_sweep_check(device, n, n_items, seed=4 + n) for n in sizes]
    return {k: max(e[k] for e in errs) for k in errs[0]}


def host_split(device, data, ue, ie, k=K, setting="all"):
    """The steps of ``retrieval_topk`` on one test setting's users, each
    synchronised and timed on its own (host clock): the kernel, ``_resolve``,
    the downloads, the tie order and the exact fallback."""
    sweep = EvalSweep(data, "item", USER_CHUNK, k, device=device)
    split = SETTING_SPLITS[(setting, "test")]
    st = sweep._prepare(split, setting)
    users = st["user_chunks"].reshape(-1)[: st["n_users"]]
    width = max(st["rated_widths"])
    rated = torch.as_tensor(st["rated_chunks"][:, :, :width].reshape(
        -1, width)[: st["n_users"]], device=device).long()
    rows = ue[torch.as_tensor(users, device=device).long()]
    excl = st["bias"].bool()
    secs = dict.fromkeys(("pad", "kernel", "resolve", "download",
                          "tie_order", "fallback"), 0.0)

    def timed(step, fn):
        _sync(device)
        t = time.perf_counter()
        out = fn()
        _sync(device)
        secs[step] += time.perf_counter() - t
        return out

    items_t, excl_row = timed("pad", lambda: pad_items(ie, excl))
    vals_l, ids_l, sus_l = [], [], []
    for s in range(0, rows.shape[0], USER_CHUNK):
        e = min(rows.shape[0], s + USER_CHUNK)
        cv, ci, gh = timed("kernel", lambda: fused_sweep(
            rows[s:e].contiguous(), items_t, excl_row))
        v, i, sus = timed("resolve", lambda: ret._resolve(
            cv, ci, gh, rated[s:e], k))
        v, i, sus = timed("download", lambda: (
            v.cpu().numpy(), i.cpu().numpy(), sus.cpu().numpy()))
        vals_l.append(v)
        ids_l.append(i)
        sus_l.append(sus)
    vals, ids = timed("tie_order", lambda: ret._torch_tie_order(
        np.concatenate(vals_l), np.concatenate(ids_l)))
    sus = np.concatenate(sus_l)

    def exact_chunk(rows_pad):
        r = torch.as_tensor(rows_pad, device=device)
        return ret._exact_rows(rows[r], ie, rated[r], excl, k)

    timed("fallback", lambda: ret.apply_exact_fallback(vals, ids, sus,
                                                       exact_chunk))
    total = sum(secs.values())
    log(f"  host split ({setting} setting, {rows.shape[0]} users, "
        f"{int(sus.sum())} rows to the fallback): " + ", ".join(
            f"{n} {v:.4f} s" for n, v in secs.items())
        + f"; kernel {secs['kernel'] / total:.1%} of {total:.3f} s")
    return secs


def slice_run(device, n_users, n_items, n_inter, d=D, topN=(10, 20),
              n_requests=8, request_size=512, seed=0):
    """Phase 4: the main path (serving + three-way test) and its checks.
    Returns the launches of each kernel counted during the main path."""
    device = torch.device(device)
    t = time.perf_counter()
    data, _ = synthetic_dataset(n_users, n_items, n_inter,
                                cold_object="item", seed=seed)
    log(f"  data {data.user_num} users x {data.item_num} items, "
        f"{data.n_train} train pairs, max rated {data.max_rated} "
        f"({time.perf_counter() - t:.2f} s)")
    mf = MF(data.user_num, data.item_num, emb_size=d, seed=seed,
            device=device)
    ue, ie = (w.detach() for w in mf.forward_tables())
    rng = np.random.default_rng(seed + 1)
    requests = [rng.choice(data.user_num, request_size, replace=False)
                for _ in range(n_requests)]
    with tempfile.TemporaryDirectory() as emb_dir:
        save_embeddings(emb_dir, "bx_synth", "item", "MF",
                        {"user_emb": ue, "item_emb": ie})
        srv = RetrievalServer.from_checkpoint(
            emb_dir, "bx_synth", "item", "MF", dataset=data, device=device)

    reset_launches()
    t = time.perf_counter()
    served = [srv.topk(u, K, exclude_rated=True)[1] for u in requests]
    raw_users = data.id2user[requests[0]]
    _, raw_items = srv.topk(raw_users, K, exclude_rated=True, raw_ids=True)
    _sync(device)
    t_serve = time.perf_counter() - t
    t = time.perf_counter()
    res = three_way_test(data, ue, ie, topN=topN, backend="kernel",
                         device=device)
    _sync(device)
    t_test = time.perf_counter() - t
    launches = {name: launch_counts()[name]
                for name in ("fused_sweep", "merge_parts")}
    log(f"  serving {n_requests}x{request_size} users + 1 raw-id request "
        f"{t_serve:.2f} s ({t_serve / (n_requests + 1):.4f} s per request); "
        f"three-way test {t_test:.2f} s; kernel launches {launches}")
    if device.type == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"the main path left a kernel unlaunched: "
                             f"{launches}")

    # checks: raw ids round-trip, lists vs the plain path, metrics finite
    if not np.array_equal(raw_items, data.id2item[served[0]]):
        raise AssertionError("raw-id request disagrees with the mapped one")
    for u, ids in zip(requests, served):
        if ids.shape != (request_size, K) or (ids >= data.item_num).any():
            raise AssertionError(f"bad served ids, shape {ids.shape}")
        rated = torch.as_tensor(data.rated_padded(u.astype(np.int32)),
                                device=device)
        if K + rated.shape[1] > CANDIDATES:
            raise AssertionError("a served user left the kernel path")
        _, pi = masked_topk(exact_scores(ue[torch.as_tensor(u, device=device)],
                                         ie), rated, srv.bias, K)
        compare_lists(ue, ie, u, ids, pi.cpu().numpy())
    plain = three_way_test(data, ue, ie, topN=topN, backend="plain",
                           device=device, verbose=False)
    for setting, out in res.items():
        es = data.eval_splits[
            {"all": "overall_test", "cold": "cold_test",
             "warm": "warm_test"}[setting]]
        rows, equal = compare_lists(ue, ie, es.users, out["rec"],
                                    plain[setting]["rec"])
        perf = np.asarray(out["performance"], dtype=np.float64)
        if perf.shape != (len(topN), 4) or not np.isfinite(perf).all():
            raise AssertionError(f"{setting}: bad metrics {perf}")
        log(f"  {setting}: {rows} users, lists id-equal to the plain path "
            f"on {equal} (others near-ties)")
    host_split(device, data, ue, ie)
    return launches


def time_sweep(device, n_users=2048, n_items=BX[1], d=D, k=K,
               r=RATED_WIDTH, seed=0, reps=20):
    """Phase 6: CUDA-event milliseconds of one sweep, plus the bound."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    users = torch.as_tensor(
        rng.standard_normal((n_users, d), dtype=np.float32), device=device)
    items = torch.as_tensor(
        rng.standard_normal((n_items, d), dtype=np.float32), device=device)
    excl = torch.zeros(n_items, dtype=torch.bool, device=device)
    excl[torch.as_tensor(rng.choice(n_items, n_items // 4, replace=False),
                         device=device)] = True
    items_t, excl_row = pad_items(items, excl)

    def timed(fn, n):
        return erk.time_ms(fn, n, device, repeats=1)

    ms = timed(lambda: fused_sweep(users, items_t, excl_row), reps)
    plain_ms = timed(
        lambda: fused_sweep_reference(users, items_t, excl_row), 3)
    lib_ms = timed(
        lambda: torch.topk(exact_scores(users, items), k + r, dim=1), 5)
    i_pad = items_t.shape[1]
    flops = 2.0 * n_users * n_items * d
    bytes_moved = (n_users * d * 4 + d * i_pad * 4 + i_pad
                   + n_users * CANDIDATES * 8 + n_users * LANES * 4)
    bound, by = sweep_bound(flops, bytes_moved)
    return {
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "bound_ms": bound, "bound_by": by, "flops": flops,
        "bytes": bytes_moved,
    }


def time_merge(device, n_users=SERVE_USERS, n_items=BX[1], d=D, seed=0,
               reps=20, parts=None, graph_reps=100):
    """The merge at one shape, on the plain per-part sweeps of N(0,1)
    tables at the kernel's part count for this batch (at least 2) or at
    ``parts``: its device time ("ms": ``graph_reps`` launches in one CUDA
    graph), its time per call as the main path pays it ("call_ms": CUDA
    events around ``reps`` calls in a row, the host's checks, allocations
    and ctypes call included), its plain version's, the library
    yardstick's (``torch.topk`` of 8 over each class's parts x 8 values
    plus ``amax`` of the ghosts, in one graph as the kernel: no ids and no
    tie order, so less work) and the bound (bytes: every part read once,
    the result written once)."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    users = torch.as_tensor(
        rng.standard_normal((n_users, d), dtype=np.float32), device=device)
    items = torch.as_tensor(
        rng.standard_normal((n_items, d), dtype=np.float32), device=device)
    items_t, excl_row = pad_items(items, torch.zeros(n_items, dtype=torch.bool,
                                                     device=device))
    if parts is None:
        parts = max(2, sweep_parts_on(device, n_users, d, items_t.shape[1]))
    pv, pi, pg = sweep_parts_reference(users, items_t, excl_row, parts)
    ms = erk.graph_ms(lambda: merge_parts(pv, pi, pg), graph_reps, device)
    call_ms = erk.time_ms(lambda: merge_parts(pv, pi, pg), reps, device,
                          repeats=1)
    plain_ms = erk.time_ms(lambda: merge_parts_reference(pv, pi, pg), 3,
                           device, repeats=1)
    per_class = pv.view(parts, n_users, SLOTS, LANES).permute(
        1, 3, 0, 2).reshape(n_users, LANES, parts * SLOTS)
    lib_ms = erk.graph_ms(
        lambda: (torch.topk(per_class, SLOTS, dim=2), pg.amax(0)),
        graph_reps, device)
    row_bytes = CANDIDATES * 8 + LANES * 4
    bound, by = sweep_bound(0.0, (parts + 1) * n_users * row_bytes)
    log(f"  merge_parts {n_users} users x {parts} parts: kernel {ms:.4f} ms "
        f"device ({graph_reps} in a graph), {call_ms:.4f} ms per call "
        f"({reps} calls in a row); plain {plain_ms:.3f} ms; library "
        f"(topk(8) + amax) {lib_ms:.4f} ms; bound {bound:.4f} ms ({by})")
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
            "parts": parts}


# ----------------------------------------------------- the variant kernels
def int_tables(device, n_users, n_items, d, seed, block_i=None,
               nan_items=0):
    """Integer tables in [-INT_MAX, INT_MAX] on ``device`` with 20% of the
    items excluded: (users, items (I, d), items_t (d, I), excl). With
    ``block_i``: users in [1, INT_MAX] and the items of block j scaled by
    n_blocks - j, so that later blocks are dominated and skips fire (scores
    stay below 2^24, so every sum is still exact). With ``nan_items``: the
    ``NAN_ROWS`` (not excluded) and that many random item rows are NaN (an
    excluded one scores NEG)."""
    rng = np.random.default_rng(seed)
    users = rng.integers(1 if block_i else -INT_MAX, INT_MAX + 1,
                         (n_users, d)).astype(np.float32)
    items = rng.integers(-INT_MAX, INT_MAX + 1,
                         (n_items, d)).astype(np.float32)
    if block_i:
        items *= np.repeat(np.arange(n_items // block_i, 0, -1),
                           block_i).astype(np.float32)[:, None]
    excl = (rng.random(n_items) < 0.2).astype(np.int8)
    if nan_items:
        items[rng.choice(n_items, nan_items, replace=False)] = np.nan
        items[list(NAN_ROWS)] = np.nan
        excl[list(NAN_ROWS)] = 0
    users, items, excl = (torch.as_tensor(a, device=device)
                          for a in (users, items, excl))
    return users, items, items.T.contiguous(), excl


def skip_plain(users, items_t, excl, tile_u, block_i, floor_slot):
    """The skip kernel's plain version on users zero-padded to the tile, as
    ``skip_sweep`` pads them, with the pad rows' outputs dropped."""
    b = users.shape[0]
    pad = users.new_zeros((-(-b // tile_u) * tile_u, users.shape[1]))
    pad[:b] = users
    ref = ebs.skip_sweep_reference(pad, items_t, excl, tile_u, block_i,
                                   floor_slot)
    return tuple(r[:b] for r in ref[:3]) + (ref[3],)


def skip_pair(users, items_t, excl, tile_u, block_i, floor_slot):
    """The skip kernel's outputs and its plain version's."""
    args = (users, items_t, excl, tile_u, block_i, floor_slot)
    return ebs.skip_sweep(*args), skip_plain(*args)


def variants_run(device, n_users=2048, n_items=VAR_ITEMS, d=D,
                 blocks=VAR_BLOCKS, tiles=VAR_TILES, check_users=1024,
                 check_items=24_576, iters=2, seed=0):
    """Phase 5: the experiment path (launches counted), then every variant
    kernel against its plain version. Returns {kernel: {"launches": n,
    "max_abs_err": x}} for the four variant kernels."""
    device = torch.device(device)
    small, big = blocks

    # the experiment path, through the tools' entry points
    rng = np.random.default_rng(seed)
    ue, ie = ebs.make_tables("skew_sorted", check_users, check_items, rng)
    rat = np.full((check_users, ebs.MAX_RATED), check_items, np.int32)
    for u in range(check_users):
        n = rng.integers(ebs.MAX_RATED // 4, ebs.MAX_RATED)
        rat[u, :n] = rng.choice(check_items, n, replace=False)
    reset_launches()
    t = time.perf_counter()
    erk.main(["--users", str(n_users), "--items", str(n_items), "--dim",
              str(d), "--iters", str(iters), "--block_i", str(small),
              "--device", str(device)])
    ema.check(check_users, check_items, tiles[-1], small, device=device)
    stats = ebs.check_exact(ue, ie, rat, tiles[0], big, 0, device)
    _sync(device)
    launches = launch_counts()
    log(f"  experiment path {time.perf_counter() - t:.2f} s, launches "
        f"{launches}; blockskip check (skew_sorted, tile_u {tiles[0]}, "
        f"rv[0]) {stats}")
    if device.type == "cuda":
        missing = [k for k in VARIANTS if launches[k] <= 0]
        if missing:
            raise AssertionError(f"the experiment path launched no {missing}")

    # every kernel bit-equal to its plain version on integer tables
    errs = dict.fromkeys(VARIANTS, 0.0)

    def hold(name, label, got, ref):
        errs[name] = max(errs[name], hold_equal(f"{name} {label}", got, ref))
        log(f"  {name} {label}: bit-equal to its plain version")

    t = time.perf_counter()
    users, items, items_t, excl = int_tables(device, n_users, n_items, d,
                                             seed)
    for transposed, tab in ((False, items), (True, items_t)):
        hold("dot_sweep", f"transposed={transposed}",
             [erk.dot_sweep(users, tab, transposed)],
             [erk.dot_sweep_reference(users, tab, transposed)])
    refs = {}
    for bi in blocks:
        refs[bi] = erk.stream_sweep_reference(users, items_t, excl, bi)
        hold("stream_sweep", f"block_i={bi}",
             erk.stream_sweep(users, items_t, excl, bi), refs[bi])
    for p in ema.P_ACC:
        hold("multiacc_sweep", f"P={p} block_i={big}",
             ema.multiacc_sweep(users, items_t, excl, big, p),
             ema.multiacc_sweep_reference(users, items_t, excl, big, p))
    for tile_u in tiles:
        for floor_slot in (0, SLOTS - 1):
            got, ref = skip_pair(users, items_t, excl, tile_u, big,
                                 floor_slot)
            hold("skip_sweep", f"tile_u={tile_u} floor=rv[{floor_slot}] "
                 f"skips {int(got[3].sum())}", got, ref)
    users, _, items_t, excl = int_tables(device, n_users, n_items, d,
                                         seed + 1, block_i=big)
    for tile_u in tiles:
        got, ref = skip_pair(users, items_t, excl, tile_u, big, 0)
        fired = int(got[3].sum())
        hold("skip_sweep", f"falling table tile_u={tile_u} floor=rv[0] "
             f"skips {fired}", got, ref)
        if fired <= 0:
            raise AssertionError(f"tile_u={tile_u}: no block was skipped on "
                                 "the falling table")

    # the NaN table: each variant keeps NaN as its own JAX tool does
    users, items, items_t, excl = int_tables(device, n_users, n_items, d,
                                             seed + 2, nan_items=40)
    for transposed, tab in ((False, items), (True, items_t)):
        hold("dot_sweep", f"NaN table transposed={transposed}",
             [erk.dot_sweep(users, tab, transposed)],
             [erk.dot_sweep_reference(users, tab, transposed)])
    nan_refs = {}
    for bi in blocks:
        ref = erk.stream_sweep_reference(users, items_t, excl, bi)
        if not bool(ref[2].isnan().any()):
            raise AssertionError("the NaN table gives no NaN ghost")
        nan_refs[bi] = ref
        hold("stream_sweep", f"NaN table block_i={bi} "
             f"({int(ref[2].isnan().sum())} NaN ghosts)",
             erk.stream_sweep(users, items_t, excl, bi), ref)
    for bi in (big, ODD_BLOCK):
        for p in ema.P_ACC:
            if bi == ODD_BLOCK and p == 1:
                continue  # one chain: no block-relative index to get wrong
            ref = ema.multiacc_sweep_reference(users, items_t, excl, bi, p)
            as_stream = bi in nan_refs and all(map(same, ref, nan_refs[bi]))
            hold("multiacc_sweep", f"NaN table P={p} block_i={bi} (equals "
                 f"stream's: {as_stream})",
                 ema.multiacc_sweep(users, items_t, excl, bi, p), ref)
    for tile_u in tiles:
        got, ref = skip_pair(users, items_t, excl, tile_u, big, 0)
        hold("skip_sweep", f"NaN table tile_u={tile_u} floor=rv[0] "
             f"skips {int(got[3].sum())}", got, ref)
    _sync(device)
    log(f"  kernel vs plain {time.perf_counter() - t:.2f} s")
    return {k: {"launches": launches[k], "max_abs_err": errs[k]}
            for k in VARIANTS}


def sweep_bound(flops, bytes_moved):
    """(ms, "operations" or "bytes"): fp32 operations at 67 TFLOP/s (outside
    the tensor cores) against bytes at 3.35 TB/s, the larger."""
    t_ops = flops / 67e12 * 1e3
    t_bytes = bytes_moved / 3.35e12 * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def kernel_registers(ptxas: str) -> None:
    """Log registers / spill-store bytes of every instance of each kernel
    from the build's ``nvcc -Xptxas -v`` report (empty when the library
    was already built)."""
    if not ptxas:
        log("  registers: not reported (library already built)")
        return
    # stream and multiacc are instances of one template, told apart by
    # their chain
    for name, kernel in (
            ("fused_sweep", "fused_sweep_kernel"),
            ("merge_parts", "merge_parts_kernel"),
            ("dot_sweep", "dot_sweep_kernel"),
            ("stream_sweep", r"chain_sweep_kernel\w*StreamChain"),
            ("multiacc_sweep", r"chain_sweep_kernel\w*MaxChain"),
            ("skip_sweep", "skip_sweep_kernel")):
        log(f"  registers/spill bytes {name}: "
            f"{tile_shapes.registers(ptxas, kernel)}")


def time_variants(device, n_users=2048, n_items=VAR_ITEMS, d=D, k=K,
                  r=RATED_WIDTH, blocks=VAR_BLOCKS, tiles=VAR_TILES,
                  p_row=4, reps=10, seed=0, ptxas=""):
    """Phase 6 for the variants: per kernel, ms per sweep (CUDA events;
    the host clock on the CPU), its plain version's, a library yardstick's
    and the bound, on N(0,1) tables with 20% of the items excluded. Before
    the rows: every P and tile_u time, the skip kernel's resident clusters
    per layout, and each kernel's registers and spills."""
    device = torch.device(device)
    kernel_registers(ptxas)
    if device.type == "cuda":
        log(f"  SM clock, power draw before: {smi_line(CLOCKS)}")
        for tile_u in tiles:
            lay = ebs.skip_layout(tile_u, n_users)
            n = ebs.max_active_clusters(device, d, tile_u, n_users)
            log(f"  skip_sweep layout tile_u={tile_u} {lay}: {n} clusters "
                "resident at once")
    small, big = blocks
    rng = np.random.default_rng(seed)
    users = torch.as_tensor(
        rng.standard_normal((n_users, d), dtype=np.float32), device=device)
    items = torch.as_tensor(
        rng.standard_normal((n_items, d), dtype=np.float32), device=device)
    items_t = items.T.contiguous()
    excl = torch.as_tensor((rng.random(n_items) < 0.2).astype(np.int8),
                           device=device)

    def ms(fn, n=reps, repeats=3):
        return erk.time_ms(fn, n, device, repeats=repeats)

    flops = 2.0 * n_users * n_items * d
    tables = n_users * d * 4 + n_items * d * 4
    cands = n_items + n_users * (CANDIDATES * 8 + LANES * 4)
    topk_ms = ms(lambda: torch.topk(exact_scores(users, items), k + r,
                                    dim=1), 3)
    rows = {}

    def row(name, kernel_ms, plain_ms, library_ms, bytes_moved, note):
        bound, by = sweep_bound(flops, bytes_moved)
        rows[name] = {"ms": kernel_ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound,
                      "bound_by": by}
        log(f"  {name} {n_users} x {n_items} d={d} {note}: kernel "
            f"{kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, library "
            f"{library_ms:.3f} ms, bound {bound:.3f} ms ({by})")

    dot_ms = {tr: ms(lambda: erk.dot_sweep(users, tab, tr))
              for tr, tab in ((False, items), (True, items_t))}
    log(f"  dot_sweep items (I, d): {dot_ms[False]:.3f} ms")
    row("dot_sweep", dot_ms[True],
        ms(lambda: erk.dot_sweep_reference(users, items_t, True), 3),
        ms(lambda: exact_scores(users, items).view(
            n_users, -1, LANES).amax(1), 3),
        tables + n_users * LANES * 4,
        "items (d, I); library = matmul + amax (the same function)")
    stream = {}
    for bi in blocks:
        stream[bi] = ms(lambda: erk.stream_sweep(users, items_t, excl, bi))
        log(f"  stream_sweep block_i={bi}: {stream[bi]:.3f} ms")
    row("stream_sweep", stream[small],
        ms(lambda: erk.stream_sweep_reference(users, items_t, excl, small),
           1, 1),
        topk_ms, tables + cands,
        f"block_i={small}; library = matmul + topk({k + r}), less work")
    multi = {}
    for p in ema.P_ACC:
        multi[p] = ms(lambda: ema.multiacc_sweep(users, items_t, excl, big, p))
        log(f"  multiacc_sweep P={p} block_i={big}: {multi[p]:.3f} ms")
    row("multiacc_sweep", multi[p_row],
        ms(lambda: ema.multiacc_sweep_reference(users, items_t, excl, big,
                                                p_row), 1, 1),
        topk_ms, tables + cands,
        f"P={p_row} block_i={big}; library = matmul + topk({k + r}), less "
        "work")
    skip = {}
    for tile_u in tiles:
        skip[tile_u] = ms(lambda: ebs.skip_sweep(users, items_t, excl, tile_u,
                                                 big, 0), 2)
        log(f"  skip_sweep tile_u={tile_u} floor=rv[0] block_i={big}: "
            f"{skip[tile_u]:.3f} ms")
    tile_u = tiles[-1]
    row("skip_sweep", skip[tile_u],
        ms(lambda: skip_plain(users, items_t, excl, tile_u, big, 0), 1, 1),
        topk_ms, tables + cands + n_users // tile_u * 4,
        f"tile_u={tile_u} floor=rv[0] block_i={big}; library = matmul + "
        f"topk({k + r}), less work")
    if device.type == "cuda":
        log(f"  SM clock, power draw after: {smi_line(CLOCKS)}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = run_phase("device", smi_line)
    kind = torch.cuda.get_device_name(0)
    log(f"  {smi} | torch: {kind}, {torch.cuda.device_count()} card(s), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    built = run_phase("build", kbuild.build)
    log(f"  {built.path.name}: nvcc {built.seconds:.2f} s\n{built.ptxas}")

    errs = [
        run_phase("kernel-bx", kernel_vs_plain, device, 2048, BX[1]),
        run_phase("kernel-ml", kernel_ml, device),
    ]
    exact = run_phase("kernel-int", kernel_int, device)
    launches = run_phase("slice", slice_run, device, *BX)
    variants = run_phase("variants", variants_run, device)
    t = run_phase("timing", time_sweep, device)
    t512 = time_sweep(device, n_users=SERVE_USERS)
    for n, r in ((2048, t), (SERVE_USERS, t512)):
        log(f"  sweep {n} x {BX[1]} d={D} [{smi}]: kernel {r['ms']:.3f} ms, "
            f"plain {r['plain_ms']:.3f} ms, library (matmul+topk) "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}: {r['flops']:.3e} FLOP, {r['bytes']:.3e} B)")
    tm = time_merge(device)
    time_merge(device, n_users=2048, parts=2)
    tv = run_phase("timing-variants", time_variants, device,
                   ptxas=built.ptxas)

    kernels = [{
        "name": "fused_sweep",
        "route": "cuda",
        "source": "coldrec_tpu_torch/csrc/retrieval.cu",
        "replaces": "coldrec_tpu/ops/pallas/retrieval.py:63",
        "launches": launches["fused_sweep"],
        "max_abs_err": max([e["max_abs_err"] for e in errs]
                           + [exact["fused_sweep"]]),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }, {
        "name": "merge_parts",
        "route": "cuda",
        "source": "coldrec_tpu_torch/csrc/retrieval.cu",
        "replaces": "coldrec_tpu/ops/pallas/retrieval.py:63",
        "launches": launches["merge_parts"],
        "max_abs_err": max(errs[1]["merge_err"], exact["merge_parts"]),
        **{k: tm[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")},
    }]
    for name, source, replaces in (
            ("dot_sweep", "exp_retrieval_kernels.cu",
             "tools/exp_retrieval_kernels.py:55"),
            ("stream_sweep", "exp_retrieval_kernels.cu",
             "tools/exp_retrieval_kernels.py:94"),
            ("multiacc_sweep", "exp_multiacc.cu", "tools/exp_multiacc.py:72"),
            ("skip_sweep", "exp_blockskip.cu", "tools/exp_blockskip.py:57")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"coldrec_tpu_torch/csrc/{source}",
            "replaces": replaces,
            **variants[name],
            **tv[name],
        })
    log(f"total {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
