"""The port's sharded ops (``coldrec_tpu_torch/parallel/ops.py``) on real
gloo ranks against the JAX package's on a CPU device mesh of the same
width.

A module fixture (:func:`run_both`) writes seeded numpy inputs, starts a
child script as 2 and as 4 ranks (``launch_ranks``: separate processes on
localhost, meshes 1x2 and 1x4), and computes the JAX functions on
``make_mesh(1, 2)`` and ``make_mesh(1, 4)`` meanwhile (conftest gives 8 CPU
devices). Each rank gathers its results and gradients whole; rank 0 writes
them. The JAX package's ``shard_map`` programs run under ``jax.jit`` here
(its helper wrapped while the fixture runs): run eagerly, each primitive
compiles on its own and one retrieval call took 6 s. Held here: both
lookup modes and ``auto`` on a table that picks each, values and gradients
(``TOL``); the SpMM's edge partition, its output and its gradient;
``sharded_masked_topk``; ``pad_rows``. ``sharded_retrieval_topk`` is held
in ``test_torch_parallel_retrieval.py`` through the same fixture.
"""
import concurrent.futures
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from coldrec_tpu.data.synthetic import synthetic_dataset as jsynth
from coldrec_tpu.parallel import ops as jops
from coldrec_tpu.parallel.mesh import AXIS_MODEL, make_mesh as jmesh
from coldrec_tpu_torch.parallel import ops as tops
from coldrec_tpu_torch.parallel.distributed import launch_ranks
from test_torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6
WIDTHS = (2, 4)
LOOKUPS = (("small", "gather"), ("small", "exchange"), ("small", "auto"),
           ("big", "exchange"), ("big", "auto"))
RETRIEVAL = ("general", "collision", "pad")

CHILD = r'''
import sys
import numpy as np
import torch
from coldrec_tpu_torch.parallel.distributed import (
    all_gather, init_distributed, process_count, process_index,
    shutdown_distributed)
from coldrec_tpu_torch.parallel.mesh import make_mesh
from coldrec_tpu_torch.parallel import ops

torch.set_num_threads(1)
init_distributed(device="cpu")
mesh = make_mesh(1, process_count())
inp = dict(np.load(sys.argv[1]))
section = sys.argv[3]
out = {}
t = lambda a: torch.as_tensor(a)
whole = lambda x: all_gather(x.detach().contiguous(), mesh.model_group)

for tab in ("small", "big") if section == "ops" else ():
    for mode in ("gather", "exchange", "auto"):
        local = ops.shard_rows(mesh, t(inp[f"{tab}_table"])).clone()
        local.requires_grad_(True)
        rows = ops.sharded_lookup(mesh, local, t(inp[f"{tab}_ids"]), mode)
        (rows * t(inp[f"{tab}_cot"])).sum().backward()
        out[f"lookup_{tab}_{mode}"] = rows.detach().numpy()
        out[f"lookup_{tab}_{mode}_grad"] = whole(local.grad).numpy()

if section == "ops":
    class G:
        pass
    g = G()
    g.rows, g.cols, g.vals = inp["g_rows"], inp["g_cols"], inp["g_vals"]
    sg = ops.ShardedGraph(mesh, g, inp["x"].shape[0])
    lens = whole(torch.tensor([sg.rows.numel()]))
    out["sg_lens"] = lens.numpy()
    for key in ("rows", "cols", "vals"):  # each shard's edges, -1 after
        v = getattr(sg, key)
        padded = torch.full((int(lens.max()),), -1, dtype=v.dtype)
        padded[:v.numel()] = v
        out[f"sg_{key}"] = whole(padded[None]).numpy()
    x = ops.shard_rows(mesh, t(inp["x"])).clone().requires_grad_(True)
    y = ops.sharded_spmm(sg, x)
    (y * ops.shard_rows(mesh, t(inp["x_cot"]))).sum().backward()
    out["spmm"] = whole(y).numpy()
    out["spmm_grad"] = whole(x.grad).numpy()
    v, i = ops.sharded_masked_topk(
        mesh, t(inp["mt_u"]), ops.shard_rows(mesh, t(inp["mt_items"])),
        ops.shard_rows(mesh, t(inp["mt_excl"])), int(inp["mt_k"]))
    out["masked_vals"], out["masked_ids"] = v.numpy(), i.numpy()

for case in ("general", "collision", "pad") if section == "retrieval" else ():
    v, i = ops.sharded_retrieval_topk(
        mesh, t(inp[f"{case}_u"]),
        ops.shard_rows(mesh, t(inp[f"{case}_items"])), inp[f"{case}_rated"],
        ops.shard_rows(mesh, t(inp[f"{case}_excl"])), int(inp[f"{case}_k"]))
    out[f"{case}_vals"], out[f"{case}_ids"] = v, i
if process_index() == 0:
    np.savez(sys.argv[2], **out)
shutdown_distributed()
'''


def _inputs(m: int) -> dict:
    """The seeded inputs of a mesh of width ``m`` (the shapes of
    ``tests/test_sharding.py``, the pad case's item count a multiple of 96
    per shard so every shard carries pad columns)."""
    rng = np.random.default_rng(100 + m)
    inp = {}
    for tab, n in (("small", 64), ("big", 256)):
        inp[f"{tab}_table"] = rng.standard_normal((n, 16)).astype(np.float32)
        inp[f"{tab}_ids"] = rng.integers(0, n, 32).astype(np.int32)
        inp[f"{tab}_cot"] = rng.standard_normal((32, 16)).astype(np.float32)
    data, _ = jsynth(n_users=50, n_items=40, n_inter=900, seed=3)
    host = data.norm_adj
    inp["g_rows"], inp["g_cols"], inp["g_vals"] = (host.rows, host.cols,
                                                   host.vals)
    n = host.shape[0]
    n_pad = -(-n // m) * m
    inp["x"] = rng.standard_normal((n_pad, 8)).astype(np.float32)
    inp["x_cot"] = rng.standard_normal((n_pad, 8)).astype(np.float32)
    inp["mt_u"] = rng.standard_normal((16, 8)).astype(np.float32)
    inp["mt_items"] = rng.standard_normal((64, 8)).astype(np.float32)
    excl = np.zeros(64, bool)
    excl[rng.choice(64, 10, replace=False)] = True
    inp["mt_excl"], inp["mt_k"] = excl, 5
    # general: rated rejection and a fifth of the items excluded
    b, n_items, d, k, r = 24, 8 * 128, 16, 6, 8
    inp["general_u"] = rng.standard_normal((b, d)).astype(np.float32)
    inp["general_items"] = rng.standard_normal((n_items, d)).astype(
        np.float32)
    rated = np.full((b, r), n_items, np.int32)
    for i in range(b):
        nr = rng.integers(0, r)
        rated[i, :nr] = rng.choice(n_items, nr, replace=False)
    excl = np.zeros(n_items, bool)
    excl[rng.choice(n_items, n_items // 5, replace=False)] = True
    inp["general_rated"], inp["general_excl"], inp["general_k"] = (
        rated, excl, k)
    # collision: a planted top set in one lane class of one shard
    n_items, d, k = 8 * 256, 8, 12
    u = np.zeros((8, d), np.float32)
    u[:, 0] = 1.0
    items = rng.standard_normal((n_items, d)).astype(np.float32) * 0.01
    for rank, iid in enumerate(range(0, 10 * 128, 128)):
        items[iid] = 0.0
        items[iid, 0] = 100.0 - rank
    inp["collision_u"], inp["collision_items"] = u, items
    inp["collision_rated"] = np.full((8, 4), n_items, np.int32)
    inp["collision_excl"], inp["collision_k"] = np.zeros(n_items, bool), k
    # pad: 2 candidates for k=5, items_per = 96 (no lane multiple)
    n_items = 96 * m
    inp["pad_u"] = rng.standard_normal((8, 8)).astype(np.float32)
    inp["pad_items"] = rng.standard_normal((n_items, 8)).astype(np.float32)
    inp["pad_rated"] = np.full((8, 4), n_items, np.int32)
    excl = np.ones(n_items, bool)
    excl[rng.choice(n_items, 2, replace=False)] = False
    inp["pad_excl"], inp["pad_k"] = excl, 5
    return inp


def _jax_ops(inp: dict, m: int) -> dict:
    """The JAX package's lookups, SpMM and masked top-k on the same inputs,
    on a 1 x m device mesh (each family in one ``jax.jit``)."""
    mesh = jmesh(1, m)
    row = NamedSharding(mesh, P(AXIS_MODEL))

    def lookups(tables):
        out = {}
        for tab, mode in LOOKUPS:
            ids = jnp.asarray(inp[f"{tab}_ids"])
            cot = jnp.asarray(inp[f"{tab}_cot"])
            out[f"lookup_{tab}_{mode}"] = jops.sharded_lookup(
                mesh, tables[tab], ids, mode)
            out[f"lookup_{tab}_{mode}_grad"] = jax.grad(
                lambda tb: jnp.sum(jops.sharded_lookup(mesh, tb, ids, mode)
                                   * cot))(tables[tab])
        return out

    out = jax.jit(lookups)({tab: jops.shard_rows(
        mesh, jnp.asarray(inp[f"{tab}_table"])) for tab in ("small", "big")})
    host = type("G", (), {})()
    host.rows, host.cols, host.vals = inp["g_rows"], inp["g_cols"], \
        inp["g_vals"]
    sg = jops.ShardedGraph(mesh, host, inp["x"].shape[0])
    for key, arr in (("rows", sg.rows_s), ("cols", sg.cols_s),
                     ("vals", sg.vals_s)):
        out[f"sg_{key}"] = arr
    cot = jnp.asarray(inp["x_cot"])
    out["spmm"], out["spmm_grad"] = jax.jit(lambda x: (
        jops.sharded_spmm(sg, x),
        jax.grad(lambda xx: jnp.sum(jops.sharded_spmm(sg, xx) * cot))(x)))(
            jops.shard_rows(mesh, jnp.asarray(inp["x"])))
    out["masked_vals"], out["masked_ids"] = jops.sharded_masked_topk(
        mesh, jnp.asarray(inp["mt_u"]),
        jops.shard_rows(mesh, jnp.asarray(inp["mt_items"])),
        jax.device_put(jnp.asarray(inp["mt_excl"]), row), int(inp["mt_k"]))
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_retrieval(inp: dict, m: int) -> dict:
    """The JAX package's ``sharded_retrieval_topk`` (its kernel in interpret
    mode) on the three cases, on a 1 x m device mesh."""
    mesh = jmesh(1, m)
    row = NamedSharding(mesh, P(AXIS_MODEL))
    out = {}
    for case in RETRIEVAL:
        out[f"{case}_vals"], out[f"{case}_ids"] = jops.sharded_retrieval_topk(
            mesh, jnp.asarray(inp[f"{case}_u"]),
            jops.shard_rows(mesh, jnp.asarray(inp[f"{case}_items"])),
            inp[f"{case}_rated"],
            jax.device_put(jnp.asarray(inp[f"{case}_excl"]), row),
            int(inp[f"{case}_k"]), tile_u=8, block_i=128, interpret=True)
    return out


def run_both(tmp, section: str) -> dict:
    """{m: (the ranks' results, the JAX results, the inputs)} of one
    section, the ranks of both widths running while JAX computes."""
    child = tmp / "child.py"
    child.write_text(CHILD)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    jax_fn = {"ops": _jax_ops, "retrieval": _jax_retrieval}[section]
    inputs, futures = {}, {}
    with pytest.MonkeyPatch.context() as mp, \
            concurrent.futures.ThreadPoolExecutor(len(WIDTHS)) as pool:
        shard_map = jops.shard_map
        mp.setattr(jops, "shard_map",
                   lambda *a, **k: jax.jit(shard_map(*a, **k)))
        for m in WIDTHS:
            inputs[m] = _inputs(m)
            np.savez(tmp / f"in{m}.npz", **inputs[m])
            futures[m] = pool.submit(
                launch_ranks, [sys.executable, str(child),
                               str(tmp / f"in{m}.npz"),
                               str(tmp / f"out{m}.npz"), section], m, 240,
                env)
        ref = {m: jax_fn(inputs[m], m) for m in WIDTHS}
        for m in WIDTHS:
            for rank, (code, out) in enumerate(futures[m].result()):
                assert code == 0, f"{m} ranks, rank {rank}:\n{out[-3000:]}"
    return {m: (dict(np.load(tmp / f"out{m}.npz")), ref[m], inputs[m])
            for m in WIDTHS}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("parallel_ops"), "ops")


@pytest.mark.parametrize("m", WIDTHS)
@pytest.mark.parametrize("tab,mode", LOOKUPS)
def test_lookup_values_and_gradients(results, m, tab, mode):
    port, ref, inp = results[m]
    key = f"lookup_{tab}_{mode}"
    np.testing.assert_allclose(port[key], ref[key], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(port[key],
                               inp[f"{tab}_table"][inp[f"{tab}_ids"]])
    np.testing.assert_allclose(port[f"{key}_grad"], ref[f"{key}_grad"],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("m", WIDTHS)
def test_spmm_partition_values_and_gradient(results, m):
    """Each shard holds the JAX partition's real edges in its order; the
    JAX shard's tail beyond them is no-op padding (value 0), which the port
    leaves out."""
    port, ref, inp = results[m]
    rps = inp["x"].shape[0] // m
    assert port["sg_lens"].sum() == inp["g_rows"].size
    for s, n in enumerate(port["sg_lens"]):
        for key in ("sg_rows", "sg_cols", "sg_vals"):
            np.testing.assert_array_equal(port[key][s, :n], ref[key][s, :n])
        assert (ref["sg_vals"][s, n:] == 0).all()
        assert (ref["sg_rows"][s, n:] == s * rps).all()
    np.testing.assert_allclose(port["spmm"], ref["spmm"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(port["spmm_grad"], ref["spmm_grad"],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("m", WIDTHS)
def test_sharded_masked_topk(results, m):
    port, ref, _ = results[m]
    np.testing.assert_array_equal(port["masked_ids"], ref["masked_ids"])
    np.testing.assert_allclose(port["masked_vals"], ref["masked_vals"],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("x,multiple", [
    (np.ones((10, 3), np.float32), 4),
    (np.arange(8, dtype=np.int32), 4),
    (np.ones((7, 2), bool), 3),
])
def test_pad_rows(x, multiple):
    got = tops.pad_rows(x, multiple)
    ref = jops.pad_rows(x, multiple)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_one_process_mesh_and_the_table_rule():
    """Without a group: a 1x1 mesh (``default_mesh`` too), any other size
    raises as the JAX ``make_mesh`` does; ``--mesh`` parsing; the table
    rule of the JAX ``_setup_mesh`` at book-crossing shape (the item table
    shards over 2, the user table of 92,107 rows stays whole)."""
    from coldrec_tpu_torch.parallel.mesh import (
        default_mesh, make_mesh, parse_mesh, shards_rows)

    assert (default_mesh().n_data, default_mesh().n_model) == (1, 1)
    mesh = make_mesh(1, 1)
    assert (mesh.model_group, mesh.data_group, mesh.rank) == (None, None, 0)
    with pytest.raises(ValueError, match="needs 4 processes, have 1"):
        make_mesh(2, 2)
    assert parse_mesh("2X4") == (2, 4)
    for bad in ("2", "0x2", "ax1"):
        with pytest.raises(ValueError, match="--mesh"):
            parse_mesh(bad)
    rows = {92_107, 270_170}
    assert shards_rows((270_170, 64), rows, 2)
    assert not shards_rows((92_107, 64), rows, 2)
    assert not shards_rows((270_170,), rows, 2)
    assert not shards_rows((270_170, 64), rows, 1)
    assert not shards_rows((64, 64), rows, 2)
