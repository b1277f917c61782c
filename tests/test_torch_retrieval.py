"""Port retrieval module vs the JAX package.

The port's ``retrieval_topk`` (on the CPU: the kernel's plain version plus
the same resolve / tie-order / fallback host logic) against the JAX
``retrieval_topk(..., interpret=True)``, id-exact, mirroring
tests/test_pallas_retrieval.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coldrec_tpu.ops.pallas import retrieval as jret
from coldrec_tpu.runtime.eval import masked_topk as jmasked_topk
from coldrec_tpu_torch.ops.cuda import retrieval as tret


def _case(rng, n_users, n_items, d=16, max_rated=12, excl_frac=4):
    ue = rng.integers(-3, 4, (n_users, d)).astype(np.float32)
    ie = rng.integers(-3, 4, (n_items, d)).astype(np.float32)
    rated = np.full((n_users, max_rated), n_items, np.int32)
    for u in range(n_users):
        nr = rng.integers(0, max_rated)
        rated[u, :nr] = rng.choice(n_items, nr, replace=False)
    excluded = np.zeros(n_items, bool)
    if excl_frac:
        excluded[rng.choice(n_items, n_items // excl_frac, replace=False)] = True
    return ue, ie, rated, excluded


def _jax(ue, ie, rated, excluded, k, tile_u=8, block_i=128):
    return jret.retrieval_topk(ue, ie, rated, excluded, k, tile_u=tile_u,
                               block_i=block_i, interpret=True)


def _port(ue, ie, rated, excluded, k):
    return tret.retrieval_topk(ue, ie, rated, excluded, k, device="cpu")


@pytest.mark.parametrize("n_items", [100, 256, 1000])
def test_retrieval_id_exact_vs_jax(rng, n_items):
    """Integer-valued tables: exact scores, real ties, equal lists."""
    ue, ie, rated, excluded = _case(rng, 40, n_items)
    jv, ji = _jax(ue, ie, rated, excluded, 10)
    tv, ti = _port(ue, ie, rated, excluded, 10)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    for u in range(40):
        assert not set(ti[u]) & set(np.flatnonzero(excluded).tolist())
        assert not set(ti[u]) & set(rated[u][rated[u] < n_items].tolist())


def test_retrieval_random_tables_vs_masked_topk(rng):
    """Continuous scores over more users than one kernel launch takes: the
    port's result equals the JAX exact path."""
    n_users, n_items, d, k = 2 * tret.USER_CHUNK + 5, 700, 16, 12
    ue = rng.standard_normal((n_users, d)).astype(np.float32)
    ie = rng.standard_normal((n_items, d)).astype(np.float32)
    _, _, rated, excluded = _case(rng, n_users, n_items)
    tv, ti = _port(ue, ie, rated, excluded, k)
    scores = ue.astype(np.float64) @ ie.astype(np.float64).T
    rv, ri = jmasked_topk(jnp.asarray(scores.astype(np.float32)),
                          jnp.asarray(rated), jnp.asarray(excluded), k)
    np.testing.assert_array_equal(ti, np.asarray(ri))
    np.testing.assert_allclose(tv, np.asarray(rv), rtol=1e-5, atol=1e-5)


def test_high_scoring_rated_items_rejected(rng):
    n_items, d, k = 512, 16, 10
    ue = np.zeros((4, d), dtype=np.float32)
    ue[:, 0] = 1.0
    ie = rng.integers(-2, 3, (n_items, d)).astype(np.float32)
    hot = rng.choice(n_items, 24, replace=False).astype(np.int32)
    ie[hot, 0] = 50.0  # rated items score far above everything else
    rated = np.tile(np.sort(hot), (4, 1)).astype(np.int32)
    excluded = np.zeros(n_items, dtype=bool)
    jv, ji = _jax(ue, ie, rated, excluded, k, tile_u=4)
    tv, ti = _port(ue, ie, rated, excluded, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    assert not set(ti.ravel().tolist()) & set(hot.tolist())


def test_all_tie_rows_route_through_fallback(rng):
    """All scores tie at 0: every row is flagged and the chunked fallback
    returns the lowest-index order, as in the JAX package."""
    n_users, n_items, d, k = 24, 512, 8, 10
    ue = rng.standard_normal((n_users, d)).astype(np.float32)
    ie = np.zeros((n_items, d), dtype=np.float32)
    rated = np.full((n_users, 4), n_items, dtype=np.int32)
    excluded = np.zeros(n_items, dtype=bool)
    excluded[rng.choice(n_items, n_items // 2, replace=False)] = True
    users = torch.as_tensor(ue)
    items_t, excl_row = tret.pad_items(torch.as_tensor(ie),
                                       torch.as_tensor(excluded))
    cv, ci, gh = tret.fused_sweep(users, items_t, excl_row)
    _, _, sus = tret._resolve(cv, ci, gh, torch.as_tensor(rated).long(), k)
    assert bool(sus.all())
    jv, ji = _jax(ue, ie, rated, excluded, k)
    tv, ti = _port(ue, ie, rated, excluded, k)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(
        ti[0], np.flatnonzero(~excluded)[:k])


def test_apply_exact_fallback_chunk_boundaries(rng):
    """20 flagged rows with chunk=8 pad to 24: three chunks, and the results
    land on the right rows, as the JAX helper does."""
    n, k, chunk = 30, 4, 8
    sus = np.zeros(n, bool)
    sus[rng.choice(n, 20, replace=False)] = True
    out = {}
    for name, fn in (("jax", jret.apply_exact_fallback),
                     ("port", tret.apply_exact_fallback)):
        vals = np.zeros((n, k), np.float32)
        ids = np.zeros((n, k), np.int32)
        calls = []

        def exact_chunk(rows_pad):
            calls.append(rows_pad.copy())
            fv = np.repeat(rows_pad[:, None], k, 1).astype(np.float32) + 0.5
            fi = np.repeat(rows_pad[:, None], k, 1).astype(np.int32) * 10
            return fv, fi

        fn(vals, ids, sus, exact_chunk, chunk=chunk)
        out[name] = (vals, ids, calls)
    assert len(out["port"][2]) == 3
    for a, b in zip(out["jax"][2], out["port"][2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out["jax"][0], out["port"][0])
    np.testing.assert_array_equal(out["jax"][1], out["port"][1])
    for r in np.flatnonzero(~sus):
        np.testing.assert_array_equal(out["port"][0][r], np.zeros(k))


def test_lane_collision_triggers_exact_fallback(rng):
    """More than SLOTS of the true top-k in one lane class: the ghost flags
    the row and the fallback finds the planted set."""
    n_items, d, k = 2048, 16, tret.SLOTS + 4
    n_plant = tret.SLOTS + 2
    ue = np.zeros((8, d), dtype=np.float32)
    ue[:, 0] = 1.0
    ie = rng.integers(-2, 3, (n_items, d)).astype(np.float32) * 0.01
    plant = list(range(0, n_plant * 128, 128))  # all in lane class 0
    for rank, iid in enumerate(plant):
        ie[iid] = 0.0
        ie[iid, 0] = 100.0 - rank
    rated = np.full((8, 4), n_items, dtype=np.int32)
    excluded = np.zeros(n_items, dtype=bool)
    users = torch.as_tensor(ue)
    items_t, excl_row = tret.pad_items(torch.as_tensor(ie),
                                       torch.as_tensor(excluded))
    cv, ci, gh = tret.fused_sweep(users, items_t, excl_row)
    _, _, sus = tret._resolve(cv, ci, gh, torch.as_tensor(rated).long(), k)
    assert bool(sus.all())
    jv, ji = _jax(ue, ie, rated, excluded, k, block_i=256)
    tv, ti = _port(ue, ie, rated, excluded, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    assert ti[0, :n_plant].tolist() == plant


def _nan_case(nan_items, n_users=8, n_items=1024, d=8, seed=11):
    rng = np.random.default_rng(seed)
    ue = rng.standard_normal((n_users, d)).astype(np.float32)
    ie = rng.standard_normal((n_items, d)).astype(np.float32)
    ie[nan_items] = np.nan
    rated = np.full((n_users, 1), n_items, np.int32)
    return ue, ie, rated, np.zeros(n_items, bool)


@pytest.mark.parametrize("nan_items", [[300], [5, 133, 261, 389, 517, 901]],
                         ids=["one", "one-lane-class"])
def test_nan_items_never_ranked_as_jax_kernel_path(nan_items):
    """A NaN item row scores NaN for every user: the JAX kernel path drops
    it, and so must the port's plain sweep (no slot; the ghost of its lane
    class turns NaN, as the TPU kernel's does)."""
    ue, ie, rated, excluded = _nan_case(nan_items)
    jv, ji = _jax(ue, ie, rated, excluded, 5, block_i=256)
    tv, ti = _port(ue, ie, rated, excluded, 5)
    assert not set(np.asarray(ji).ravel().tolist()) & set(nan_items)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    users = torch.as_tensor(ue)
    items_t, excl_row = tret.pad_items(torch.as_tensor(ie),
                                       torch.as_tensor(excluded))
    cv, ci, gh = tret.fused_sweep(users, items_t, excl_row)
    assert not bool(cv.isnan().any())
    nan_class = torch.zeros(tret.LANES, dtype=torch.bool)
    nan_class[[i % tret.LANES for i in nan_items]] = True
    assert torch.equal(gh.isnan(), nan_class.expand_as(gh))
    assert not set(ci[cv > tret.INIT_NEG].tolist()) & set(nan_items)


def _crowded_case(nan_item, excluded_nan=False, n_users=8, n_blocks=12,
                  block_i=256, d=8, seed=21):
    """One lane class (0) holds 11 of every row's top-12 items, one per
    item block of ``block_i``, so the TPU kernel's block-local top-2 keeps
    each of them and both packages hold the same candidates; its 8 slots
    overflow, so only the ghost of the NaN item's class decides the flag."""
    rng = np.random.default_rng(seed)
    n_items = n_blocks * block_i
    ue = np.zeros((n_users, d), np.float32)
    ue[:, 0] = 1.0
    ue[:, 1:] = rng.standard_normal((n_users, d - 1)).astype(np.float32)
    ie = (rng.standard_normal((n_items, d)) * 0.1).astype(np.float32)
    for rank, iid in enumerate(range(0, (n_blocks - 1) * block_i, block_i)):
        ie[iid, 0] = 100.0 - rank
    ie[nan_item] = np.nan
    excluded = np.zeros(n_items, bool)
    if excluded_nan:
        excluded[nan_item] = True
    rated = np.full((n_users, 2), n_items, np.int32)
    return ue, ie, rated, excluded


def _flags(ue, ie, rated, excluded, k, block_i=256, tile_u=8):
    """(JAX kernel path's flags, the port's) for the same tables."""
    n_items = ie.shape[0]
    i_pad = jret._round_up(n_items, block_i)
    _, _, jsus = jret._sweep_padded(
        jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(rated),
        jnp.asarray(excluded), i_pad, jret._round_up(ue.shape[0], tile_u),
        tile_u, block_i, k, interpret=True)
    items_t, excl_row = tret.pad_items(torch.as_tensor(ie),
                                       torch.as_tensor(excluded))
    cv, ci, gh = tret.fused_sweep(torch.as_tensor(ue), items_t, excl_row)
    _, _, tsus = tret._resolve(cv, ci, gh, torch.as_tensor(rated).long(), k)
    return np.asarray(jsus), tsus.numpy()


@pytest.mark.parametrize("nan_item,excluded_nan,flagged", [
    (300, False, False), (1152, False, False), (300, True, True)],
    ids=["other-class", "crowded-class", "excluded"])
def test_nan_ghost_decides_the_flag_as_jax(nan_item, excluded_nan, flagged):
    """The NaN item's class ghost is NaN in both packages, so the row's max
    ghost is NaN and ``NaN >= theta`` never flags it: both return the
    candidates' list (the crowded class's 9th to 11th items left out, the
    NaN item nowhere). An excluded NaN item scores NEG, so the ghost stays
    finite and both flag every row and take the exact path."""
    ue, ie, rated, excluded = _crowded_case(nan_item, excluded_nan)
    k = 12
    jsus, tsus = _flags(ue, ie, rated, excluded, k)
    np.testing.assert_array_equal(tsus, jsus)
    assert bool(tsus.all()) == flagged and bool(tsus.any()) == flagged
    jv, ji = _jax(ue, ie, rated, excluded, k, block_i=256)
    tv, ti = _port(ue, ie, rated, excluded, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    if not excluded_nan:
        assert nan_item not in set(ti.ravel().tolist())


@pytest.mark.parametrize("groups", [4, 20])
def test_plain_ghost_is_nan_exactly_in_nan_classes(groups):
    """With fewer item groups than SLOTS (no ghost value otherwise) and with
    more: a class's ghost is NaN iff one of its scores is NaN after the
    exclusion mask; every other ghost and every slot is a number."""
    rng = np.random.default_rng(groups)
    n_items, d = groups * tret.LANES, 6
    ue = rng.integers(-3, 4, (9, d)).astype(np.float32)
    ie = rng.integers(-3, 4, (n_items, d)).astype(np.float32)
    nan_rows = rng.choice(n_items, 5, replace=False)
    ie[nan_rows] = np.nan
    excluded = np.zeros(n_items, bool)
    excluded[nan_rows[:2]] = True  # masked first: these score NEG
    items_t, excl_row = tret.pad_items(torch.as_tensor(ie),
                                       torch.as_tensor(excluded))
    cv, _, gh = tret.fused_sweep_reference(torch.as_tensor(ue), items_t,
                                           excl_row)
    nan_class = torch.zeros(tret.LANES, dtype=torch.bool)
    nan_class[torch.as_tensor(nan_rows[2:] % tret.LANES)] = True
    assert torch.equal(gh.isnan(), nan_class.expand_as(gh))
    assert not bool(cv.isnan().any())
    if groups <= tret.SLOTS:
        assert bool((gh[:, ~nan_class] == tret.INIT_NEG).all())


def _split_tables(kind, seed=0):
    """Integer tables (every sum exact) with excluded items and pad items:
    random, one all-tie block of items, few items (classes with fewer than
    9 items in a part), and NaN item rows."""
    rng = np.random.default_rng(seed)
    n_users, n_items, d = 13, (300 if kind == "few" else 2900), 6
    ue = rng.integers(-3, 4, (n_users, d)).astype(np.float32)
    ie = rng.integers(-3, 4, (n_items, d)).astype(np.float32)
    if kind == "ties":
        ie[:1500] = 1.0
    if kind == "nan":
        ie[rng.choice(n_items, 60, replace=False)] = np.nan
        ie[[7, 135, 263, 391]] = np.nan  # several in one lane class
    excluded = rng.random(n_items) < 0.2
    items_t, excl_row = tret.pad_items(torch.as_tensor(ie),
                                       torch.as_tensor(excluded))
    return torch.as_tensor(ue), items_t, excl_row


@pytest.mark.parametrize("kind", ["random", "ties", "few", "nan"])
@pytest.mark.parametrize("parts", [1, 2, 3, 8])
def test_split_and_merge_equal_one_sweep(kind, parts):
    """Sweeping each part of the item range with the plain version and
    merging the parts gives the one-sweep plain output bit for bit."""
    users, items_t, excl_row = _split_tables(kind)
    ref = tret.fused_sweep_reference(users, items_t, excl_row)
    got = tret.merge_parts(*tret.sweep_parts_reference(
        users, items_t, excl_row, parts))
    for g, r in zip(got, ref):  # bit for bit, NaN ghosts at equal places
        assert g.dtype == r.dtype
        torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)
    assert tret.merge_parts.launches == 0  # the CPU runs the plain merge


def test_part_bounds_cover_the_groups():
    for groups, parts in ((1, 1), (10, 3), (2111, 8), (16, 16)):
        b = tret.part_bounds(groups, parts)
        assert b[0] == 0 and b[-1] == groups and len(b) == parts + 1
        assert all(hi > lo for lo, hi in zip(b[:-1], b[1:]))


def test_merge_parts_refuses_bad_input():
    v = torch.zeros((2, 3, tret.CANDIDATES))
    i = torch.zeros((2, 3, tret.CANDIDATES), dtype=torch.int32)
    g = torch.zeros((2, 3, tret.LANES))
    with pytest.raises(ValueError):
        tret.merge_parts(v, i, g[:1])
    with pytest.raises(TypeError):
        tret.merge_parts(v, i.long(), g)
    with pytest.raises(ValueError, match="no merge kernel"):
        tret.merge_parts(v.to("meta"), i.to("meta"), g.to("meta"))
