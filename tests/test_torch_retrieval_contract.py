"""The port's plain retrieval sweep against its contract: the Pallas sweep
it replaces, the ghost bound as a property test, and the wrapper's dispatch
and input checks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coldrec_tpu.ops.pallas import retrieval as jret
from coldrec_tpu_torch.ops.cuda import retrieval as tret
from test_torch_threads import torch_threads  # noqa: F401  (autouse)


def test_plain_sweep_matches_pallas_sweep(rng):
    """With one 128-item block per grid step the Pallas kernel keeps each
    lane class's exact top-8 too, so values and ghosts agree exactly; ids
    agree wherever a slot's value is unique in its class, discarded values
    included (which of several tied items is kept is the only freedom)."""
    n_users, n_items, d = 24, 1900, 8
    ue = rng.integers(-1000, 1001, (n_users, d)).astype(np.float32)
    ie = rng.integers(-1000, 1001, (n_items, d)).astype(np.float32)
    excluded = np.zeros(n_items, bool)
    excluded[rng.choice(n_items, n_items // 4, replace=False)] = True
    items_t, excl_row = tret.pad_items(torch.as_tensor(ie),
                                       torch.as_tensor(excluded))
    cv, ci, gh = tret.fused_sweep(torch.as_tensor(ue), items_t, excl_row)
    jv, ji, jg = jret._fused_sweep(
        jnp.asarray(ue), jnp.asarray(items_t.numpy()),
        jnp.asarray(excl_row.numpy()[None, :]), 8, 128, True)
    np.testing.assert_array_equal(cv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(jg))
    v = cv.numpy().reshape(n_users, tret.SLOTS, tret.LANES)
    dup = v == gh.numpy()[:, None, :]  # ties a discarded value
    for s in range(tret.SLOTS):
        dup[:, s] |= (v == v[:, s:s + 1]).sum(axis=1) > 1
    a = ci.numpy().reshape(v.shape)
    b = np.asarray(ji).reshape(v.shape)
    assert (~dup).mean() > 0.5
    np.testing.assert_array_equal(a[~dup], b[~dup])


@pytest.mark.parametrize("seed", range(16))
def test_ghost_contract_property(seed):
    """For random tables (few value levels, so ties abound; shapes drawn
    from the seed): each class's slots hold its top-8 in (-value, id)
    order, and every item that is not a candidate scores <= the user's max
    ghost."""
    rng = np.random.default_rng(seed)
    n_users = int(rng.integers(1, 7))
    n_items = int(rng.integers(1, 1501))
    d = int(rng.integers(1, 7))
    levels = int(rng.integers(1, 6))
    excl_frac = float(rng.random())
    ue = rng.integers(-levels, levels + 1, (n_users, d)).astype(np.float32)
    ie = rng.integers(-levels, levels + 1, (n_items, d)).astype(np.float32)
    excluded = rng.random(n_items) < excl_frac
    items_t, excl_row = tret.pad_items(torch.as_tensor(ie),
                                       torch.as_tensor(excluded))
    cv, ci, gh = tret.fused_sweep(torch.as_tensor(ue), items_t, excl_row)
    cv, ci, gh = cv.numpy(), ci.numpy(), gh.numpy()
    z = ue @ items_t.numpy()
    z[:, excl_row.numpy() != 0] = tret.NEG
    filled = cv > tret.INIT_NEG
    rows = np.repeat(np.arange(n_users)[:, None], tret.CANDIDATES, 1)
    np.testing.assert_array_equal(z[rows[filled], ci[filled]], cv[filled])
    assert (ci[filled] % tret.LANES
            == np.nonzero(filled)[1] % tret.LANES).all()
    v = cv.reshape(n_users, tret.SLOTS, tret.LANES)
    assert (np.diff(v, axis=1) <= 0).all()
    slot_ids = ci.reshape(v.shape)
    for u in range(n_users):
        for c in range(tret.LANES):
            ids = np.arange(c, z.shape[1], tret.LANES)
            best = ids[np.lexsort((ids, -z[u, ids]))][: tret.SLOTS]
            np.testing.assert_array_equal(slot_ids[u, : best.size, c], best)
    rest = z.copy()
    rest[rows[filled], ci[filled]] = -np.inf
    assert (rest.max(axis=1) <= gh.max(axis=1)).all()


def test_wrapper_checks_and_cpu_dispatch():
    users = torch.zeros((4, 8))
    items_t = torch.zeros((8, 256))
    excl = torch.zeros(256, dtype=torch.int8)
    before = tret.fused_sweep.launches
    cv, ci, gh = tret.fused_sweep(users, items_t, excl)
    assert tret.fused_sweep.launches == before  # CPU: the plain version
    assert cv.shape == (4, tret.CANDIDATES) and ci.dtype == torch.int32
    assert gh.shape == (4, tret.LANES)
    # bf16 tables: the plain version on the widened tables, no launch
    rng = np.random.default_rng(0)
    ub = torch.as_tensor(rng.standard_normal((4, 8), dtype=np.float32))
    ib = torch.as_tensor(rng.standard_normal((8, 256), dtype=np.float32))
    before = tret.fused_sweep.launches_bf16
    got = tret.fused_sweep(ub.bfloat16(), ib.bfloat16(), excl)
    assert tret.fused_sweep.launches_bf16 == before
    ref = tret.fused_sweep_reference(tret.bf16_round(ub),
                                     tret.bf16_round(ib), excl)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    with pytest.raises(TypeError, match="one type"):
        tret.fused_sweep(users.bfloat16(), items_t, excl)
    with pytest.raises(TypeError):
        tret.fused_sweep(users.double(), items_t.double(), excl)
    with pytest.raises(ValueError):
        tret.fused_sweep(users, torch.zeros((8, 200)),
                         torch.zeros(200, dtype=torch.int8))
    with pytest.raises(ValueError):
        tret.fused_sweep(users, items_t.t().contiguous().t(), excl)
    with pytest.raises(ValueError):
        tret.retrieval_topk(np.zeros((2, 8), np.float32),
                            np.zeros((300, 8), np.float32),
                            np.full((2, 1020), 300, np.int32),
                            np.zeros(300, bool), 10, device="cpu")
