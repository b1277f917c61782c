"""The retrieval kernel on the card, held against its plain version.

Marked ``gpu``: without a card every test here skips (the check runs inside
the ``cuda`` fixture, never at import). On the card, run them with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py sets up JAX, which the card's
machine does not have; this file imports nothing of JAX.)
"""
import numpy as np
import pytest
import torch

from coldrec_tpu_torch.ops.cuda import retrieval as tret

pytestmark = pytest.mark.gpu

# fp32 sums in another order (the kernel's FFMA chain vs cuBLAS): scores of
# N(0,1) tables at d <= 64 stay below ~40, so reordering stays below 1e-3
TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _same(got, ref):
    """Bit for bit equal, NaN equal to NaN at the same places
    (``torch.equal`` is False on any NaN)."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        return False
    if not got.is_floating_point():
        return torch.equal(got, ref)
    nan = got.isnan()
    return torch.equal(nan, ref.isnan()) and torch.equal(got[~nan],
                                                         ref[~nan])


def _tables(device, n_users, n_items, d, seed=0, ints=False):
    rng = np.random.default_rng(seed)
    if ints:
        ue = rng.integers(-3, 4, (n_users, d)).astype(np.float32)
        ie = rng.integers(-3, 4, (n_items, d)).astype(np.float32)
    else:
        ue = rng.standard_normal((n_users, d), dtype=np.float32)
        ie = rng.standard_normal((n_items, d), dtype=np.float32)
    excluded = rng.random(n_items) < 0.25
    rated = np.full((n_users, 8), n_items, np.int32)
    for u in range(n_users):
        c = min(int(rng.integers(0, 9)), n_items)
        rated[u, :c] = rng.choice(n_items, c, replace=False)
    return ue, ie, excluded, rated


@pytest.mark.parametrize("n_users,n_items,d",
                         [(1, 1, 1), (7, 300, 16), (130, 5000, 64),
                          (33, 1000, 3)])
def test_kernel_matches_plain(cuda, n_users, n_items, d):
    ue, ie, excluded, _ = _tables(cuda, n_users, n_items, d)
    users = torch.as_tensor(ue, device=cuda)
    items_t, excl_row = tret.pad_items(torch.as_tensor(ie, device=cuda),
                                       torch.as_tensor(excluded, device=cuda))
    before = tret.fused_sweep.launches
    cv, ci, gh = tret.fused_sweep(users, items_t, excl_row)
    torch.cuda.synchronize(cuda)
    assert tret.fused_sweep.launches == before + 1
    rv, ri, rg = tret.fused_sweep_reference(users, items_t, excl_row)
    torch.testing.assert_close(cv, rv, rtol=0, atol=TOL)
    torch.testing.assert_close(gh, rg, rtol=0, atol=TOL)
    # ghost contract against the full scores
    z = (users @ items_t).masked_fill(excl_row.bool()[None], tret.NEG)
    filled = cv > tret.INIT_NEG
    cid = torch.where(filled, ci, ci[:, :1]).long()
    torch.testing.assert_close(z.gather(1, cid)[filled], cv[filled],
                               rtol=0, atol=TOL)
    z.scatter_(1, cid, -float("inf"))
    assert bool((z.max(1).values <= gh.max(1).values + TOL).all())


def test_kernel_integer_tables_exact(cuda):
    """Integer-valued tables: every sum is exact, so candidates, ids and
    ghosts equal the plain version's bit for bit (ties: lowest id)."""
    ue, ie, excluded, _ = _tables(cuda, 64, 3000, 16, seed=1, ints=True)
    users = torch.as_tensor(ue, device=cuda)
    items_t, excl_row = tret.pad_items(torch.as_tensor(ie, device=cuda),
                                       torch.as_tensor(excluded, device=cuda))
    cv, ci, gh = tret.fused_sweep(users, items_t, excl_row)
    rv, ri, rg = tret.fused_sweep_reference(users, items_t, excl_row)
    assert torch.equal(cv, rv) and torch.equal(ci, ri) and torch.equal(gh, rg)


# B changes the part count; d the depth chunks, and at 1200 the user tile
# no longer stays resident in shared memory (it is staged step by step)
SPLIT_SHAPES = ([(b, 16) for b in (1, 7, 130, 512, 2049)]
                + [(130, d) for d in (1, 3, 64, 200, 1200)])


def _int_sweep_inputs(device, n_users, n_items, d, seed, nan_items=0):
    users, items_t, excl_row, _ = _int_sweep_nan(device, n_users, n_items, d,
                                                 seed, nan_items)
    return users, items_t, excl_row


def _int_sweep_nan(device, n_users, n_items, d, seed, nan_items=0):
    """The inputs of ``_int_sweep_inputs`` and the (128,) mask of the lane
    classes holding a NaN item that is not excluded (their ghosts are
    NaN)."""
    rng = np.random.default_rng(seed)
    ue = rng.integers(-3, 4, (n_users, d)).astype(np.float32)
    ie = rng.integers(-3, 4, (n_items, d)).astype(np.float32)
    nan_rows = np.zeros(0, np.int64)
    if nan_items:
        nan_rows = np.concatenate([
            rng.choice(n_items, nan_items, replace=False), [1, 129, 257]])
        ie[nan_rows] = np.nan  # the last three in one lane class
    excluded = rng.random(n_items) < 0.2
    users = torch.as_tensor(ue, device=device)
    items_t, excl_row = tret.pad_items(torch.as_tensor(ie, device=device),
                                       torch.as_tensor(excluded, device=device))
    nan_class = torch.zeros(tret.LANES, dtype=torch.bool, device=device)
    live = nan_rows[~excluded[nan_rows]]
    nan_class[torch.as_tensor(live % tret.LANES, device=device)] = True
    return users, items_t, excl_row, nan_class


@pytest.mark.parametrize("n_users,d", SPLIT_SHAPES)
def test_kernel_split_integer_tables_exact(cuda, n_users, d):
    """The part count changes with B (and the depth chunks with d); on
    integer tables the merged kernel output equals the plain version's bit
    for bit."""
    users, items_t, excl_row = _int_sweep_inputs(cuda, n_users, 3000, d,
                                                 seed=n_users + d)
    before = tret.fused_sweep.launches
    got = tret.fused_sweep(users, items_t, excl_row)
    torch.cuda.synchronize(cuda)
    assert tret.fused_sweep.launches == before + 1
    ref = tret.fused_sweep_reference(users, items_t, excl_row)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("n_users", [70, 512])
def test_kernel_nan_items_match_plain(cuda, n_users):
    """NaN item rows never enter a slot, and the ghost of every lane class
    holding one that is not excluded is NaN, on the card (one part at 70
    users of 5000 items; parts and the merge at 512) as in the plain
    version."""
    users, items_t, excl_row, nan_class = _int_sweep_nan(
        cuda, n_users, 5000, 16, seed=9, nan_items=200)
    got = tret.fused_sweep(users, items_t, excl_row)
    ref = tret.fused_sweep_reference(users, items_t, excl_row)
    for g, r in zip(got, ref):
        assert _same(g, r)
    assert not bool(got[0].isnan().any())
    assert bool(nan_class.any())
    assert torch.equal(got[2].isnan(), nan_class.expand_as(got[2]))


@pytest.mark.parametrize("parts", [2, 3, 8])
def test_merge_kernel_matches_plain(cuda, parts):
    users, items_t, excl_row = _int_sweep_inputs(cuda, 37, 3000, 8, seed=4,
                                                 nan_items=50)
    pv, pi, pg = tret.sweep_parts_reference(users, items_t, excl_row, parts)
    before = tret.merge_parts.launches
    got = tret.merge_parts(pv, pi, pg)
    torch.cuda.synchronize(cuda)
    assert tret.merge_parts.launches == before + 1
    ref = tret.merge_parts_reference(pv, pi, pg)
    for g, r in zip(got, ref):
        assert _same(g, r)
    for g, r in zip(got, tret.fused_sweep_reference(users, items_t,
                                                    excl_row)):
        assert _same(g, r)
    assert bool(got[2].isnan().any())  # the NaN ghosts went through


def test_retrieval_topk_card_equals_cpu(cuda):
    n_users = 2 * tret.USER_CHUNK + 5
    ue, ie, excluded, rated = _tables(cuda, n_users, 4000, 16, seed=2,
                                      ints=True)
    before = tret.fused_sweep.launches
    gv, gi = tret.retrieval_topk(ue, ie, rated, excluded, 20, device=cuda)
    assert tret.fused_sweep.launches == before + 3
    cv, ci = tret.retrieval_topk(ue, ie, rated, excluded, 20, device="cpu")
    np.testing.assert_array_equal(gi, ci)
    np.testing.assert_array_equal(gv, cv)


def test_serving_and_three_way_test_on_card(cuda):
    from coldrec_tpu_torch.data.synthetic import synthetic_dataset
    from coldrec_tpu_torch.runtime.serving import RetrievalServer
    from coldrec_tpu_torch.runtime.trainer import three_way_test

    data, _ = synthetic_dataset(n_users=200, n_items=900, n_inter=6000,
                                seed=3)
    rng = np.random.default_rng(4)
    ue = rng.integers(-3, 4, (data.user_num, 8)).astype(np.float32)
    ie = rng.integers(-3, 4, (data.item_num, 8)).astype(np.float32)
    uids = np.arange(50)
    _, gi = RetrievalServer(ue, ie, dataset=data, device=cuda).topk(uids, 10)
    _, ci = RetrievalServer(ue, ie, dataset=data, device="cpu").topk(uids, 10)
    np.testing.assert_array_equal(gi, ci)
    g = three_way_test(data, ue, ie, device=cuda, verbose=False)
    c = three_way_test(data, ue, ie, device="cpu", verbose=False)
    for setting in ("all", "cold", "warm"):
        np.testing.assert_array_equal(g[setting]["rec"], c[setting]["rec"])


def test_wrapper_refuses_bad_card_input(cuda):
    users = torch.zeros((4, 8), device=cuda)
    items_t = torch.zeros((8, 256), device=cuda)
    excl = torch.zeros(256, dtype=torch.int8, device=cuda)
    with pytest.raises(NotImplementedError):
        tret.fused_sweep(users.bfloat16(), items_t.bfloat16(), excl)
    with pytest.raises(ValueError):
        tret.fused_sweep(users, items_t.cpu(), excl)


# ---------------------------------------------- kernel-variant experiments
from coldrec_tpu_torch.tools import exp_blockskip as tebs  # noqa: E402
from coldrec_tpu_torch.tools import exp_multiacc as tema  # noqa: E402
from coldrec_tpu_torch.tools import exp_retrieval_kernels as terk  # noqa: E402


# NaN item rows: 259 is lane class 3 in slice 2 of the first block of 384
# items or more, 650 in slice 2 of the second 384-item block (which starts
# at an odd item group), 1283 a second NaN of class 3
NAN_ROWS = (259, 650, 1029, 1283)


def _variant_tables(device, n_users, n_items, d, seed, block_i=None,
                    nan_items=0):
    """Integer tables on the card (every sum exact), 20% of items excluded.
    With ``block_i``: positive users and non-negative items scaled down
    block by block, so that block skips fire. With ``nan_items``: the
    ``NAN_ROWS`` (not excluded) and that many random item rows are NaN."""
    rng = np.random.default_rng(seed)
    lo = 1 if block_i else -8
    users = rng.integers(lo, 9, (n_users, d)).astype(np.float32)
    items = rng.integers(0 if block_i else -8, 9,
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


def _launched(wrapper, fn):
    before = wrapper.launches
    out = fn()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    return out


def _assert_same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.device == r.device and _same(g, r)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("n_users,n_items,d", [(37, 1280, 64), (5, 384, 3),
                                               (9, 256, 130)])
def test_dot_kernel_matches_plain(cuda, transposed, n_users, n_items, d):
    users, items, items_t, _ = _variant_tables(cuda, n_users, n_items, d, 5)
    tab = items_t if transposed else items
    got = _launched(terk.dot_sweep,
                    lambda: terk.dot_sweep(users, tab, transposed))
    _assert_same([got], [terk.dot_sweep_reference(users, tab, transposed)])


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("n_users,d", SPLIT_SHAPES)
def test_dot_kernel_split_matches_plain(cuda, transposed, n_users, d):
    users, items, items_t, _ = _variant_tables(cuda, n_users, 2944, d,
                                               n_users + d)
    tab = items_t if transposed else items
    got = _launched(terk.dot_sweep,
                    lambda: terk.dot_sweep(users, tab, transposed))
    _assert_same([got], [terk.dot_sweep_reference(users, tab, transposed)])


@pytest.mark.parametrize("block_i", [128, 512])
def test_stream_kernel_matches_plain(cuda, block_i):
    users, _, items_t, excl = _variant_tables(cuda, 37, 2048, 16, 6)
    got = _launched(terk.stream_sweep, lambda: terk.stream_sweep(
        users, items_t, excl, block_i))
    _assert_same(got, terk.stream_sweep_reference(users, items_t, excl,
                                                  block_i))


# d = 1200 is above what keeps the user tile resident beside the slot ids
# (560 for multiacc at P = 1, 544 for skip at 16 users, ~490 at 32): the
# walk stages the users step by step, as the production sweep does there
@pytest.mark.parametrize("p_acc", tema.P_ACC)
@pytest.mark.parametrize("block_i", [384, 1024])
@pytest.mark.parametrize("d", [16, 1200])
def test_multiacc_kernel_matches_plain(cuda, p_acc, block_i, d):
    users, _, items_t, excl = _variant_tables(cuda, 37, 3072, d, 7)
    got = _launched(tema.multiacc_sweep, lambda: tema.multiacc_sweep(
        users, items_t, excl, block_i, p_acc))
    _assert_same(got, tema.multiacc_sweep_reference(users, items_t, excl,
                                                    block_i, p_acc))


# blocks that close inside a step of the tile's walk (256, 384) and span
# many steps (2048, 8192); 24,576 items hold a whole number of each
@pytest.mark.parametrize("p_acc", tema.P_ACC)
@pytest.mark.parametrize("block_i", [256, 384, 2048, 8192])
def test_multiacc_kernel_block_grid(cuda, p_acc, block_i):
    users, _, items_t, excl = _variant_tables(cuda, 37, 24576, 16, 17)
    got = _launched(tema.multiacc_sweep, lambda: tema.multiacc_sweep(
        users, items_t, excl, block_i, p_acc))
    _assert_same(got, tema.multiacc_sweep_reference(users, items_t, excl,
                                                    block_i, p_acc))


@pytest.mark.parametrize("transposed", [False, True])
def test_dot_kernel_matches_plain_on_nan_table(cuda, transposed):
    """A NaN score makes its class's max NaN, as in the plain version."""
    users, items, items_t, _ = _variant_tables(cuda, 37, 3072, 16, 18,
                                               nan_items=20)
    tab = items_t if transposed else items
    got = _launched(terk.dot_sweep,
                    lambda: terk.dot_sweep(users, tab, transposed))
    ref = terk.dot_sweep_reference(users, tab, transposed)
    assert bool(ref.isnan().any())
    _assert_same([got], [ref])


# p_acc 0: the stream sweep; blocks of 1, 2, 3 and 4 slices (no multiple
# of P at 384, fewer slices than chains at 128 and 256); d = 1200 stages
# the users step by step
@pytest.mark.parametrize("p_acc", (0,) + tema.P_ACC)
@pytest.mark.parametrize("block_i", [128, 256, 384, 512])
@pytest.mark.parametrize("d", [16, 1200])
def test_chain_kernels_match_plain_on_nan_table(cuda, p_acc, block_i, d):
    """stream and multiacc each keep NaN as their own plain version (and
    JAX tool) does: the chain, and at P > 1 which slices share a chain."""
    users, _, items_t, excl = _variant_tables(cuda, 37, 3072, d, 19,
                                              nan_items=20)
    if p_acc == 0:
        got = _launched(terk.stream_sweep, lambda: terk.stream_sweep(
            users, items_t, excl, block_i))
        ref = terk.stream_sweep_reference(users, items_t, excl, block_i)
    else:
        got = _launched(tema.multiacc_sweep, lambda: tema.multiacc_sweep(
            users, items_t, excl, block_i, p_acc))
        ref = tema.multiacc_sweep_reference(users, items_t, excl, block_i,
                                            p_acc)
    assert bool(ref[2].isnan().any())
    _assert_same(got, ref)


def _skip_check(cuda, users, items_t, excl, tile_u, floor_slot, block_i):
    """The kernel's outputs, held bit for bit to the plain version on the
    users padded to the tile; returns the skip counts."""
    b, d = users.shape
    got = _launched(tebs.skip_sweep, lambda: tebs.skip_sweep(
        users, items_t, excl, tile_u, block_i, floor_slot))
    pad = torch.zeros((got[3].numel() * tile_u, d), device=cuda)
    pad[:b] = users
    ref = tebs.skip_sweep_reference(pad, items_t, excl, tile_u, block_i,
                                    floor_slot)
    _assert_same(got, [r[:b] for r in ref[:3]] + [ref[3]])
    return got[3]


@pytest.mark.parametrize("tile_u,floor_slot", [(8, 0), (8, 7), (64, 0),
                                               (256, 7), (260, 0)])
@pytest.mark.parametrize("d", [8, 1200])
def test_skip_kernel_matches_plain_where_skips_fire(cuda, tile_u, floor_slot,
                                                    d):
    users, _, items_t, excl = _variant_tables(cuda, 300, 4096, d, 8,
                                              block_i=256)
    skips = _skip_check(cuda, users, items_t, excl, tile_u, floor_slot, 256)
    assert int(skips.max()) > 0


# 4 and 16: whole tiles in a CTA; 12: one tile in a CTA of 16 rows, the
# rows past it zero and dominated; 64 and 256: a cluster of 4 and of 16
# CTAs; 260: the 32-user CTA tile in a cluster of 9, the last CTA partly
# filled. 1040 users are no multiple of 12, 64, 256 or 260.
@pytest.mark.parametrize("tile_u", [4, 12, 16, 64, 256, 260])
@pytest.mark.parametrize("floor_slot", [0, 7])
@pytest.mark.parametrize("table", ["falling", "iid"])
def test_skip_kernel_layout_grid(cuda, tile_u, floor_slot, table):
    falling = table == "falling"
    users, _, items_t, excl = _variant_tables(
        cuda, 1040, 8192, 8, 9, block_i=512 if falling else None)
    skips = _skip_check(cuda, users, items_t, excl, tile_u, floor_slot, 512)
    if falling and floor_slot == 0:
        assert int(skips.max()) > 0


@pytest.mark.parametrize("tile_u", [8, 64, 256])
@pytest.mark.parametrize("floor_slot", [0, 7])
def test_skip_kernel_matches_plain_on_nan_table(cuda, tile_u, floor_slot):
    """A block whose max is NaN never skips, and a NaN ghost stays NaN
    through the blocks a tile skips."""
    users, _, items_t, excl = _variant_tables(cuda, 300, 4096, 8, 20,
                                              block_i=256, nan_items=20)
    skips = _skip_check(cuda, users, items_t, excl, tile_u, floor_slot, 256)
    if floor_slot == 0:
        assert int(skips.max()) > 0


def test_skip_kernel_refuses_a_cluster_above_16(cuda):
    users, _, items_t, excl = _variant_tables(cuda, 1040, 1024, 8, 11)
    with pytest.raises(RuntimeError, match="launch failed"):
        tebs.skip_sweep(users, items_t, excl, 520, 512, 0)


def test_variant_wrappers_refuse_bad_card_input(cuda):
    users = torch.zeros((4, 8), device=cuda)
    items_t = torch.zeros((8, 512), device=cuda)
    excl = torch.zeros(512, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        terk.stream_sweep(users, items_t.cpu(), excl, 256)
    with pytest.raises(ValueError):
        tema.multiacc_sweep(users, items_t, excl, 384, 2)
    with pytest.raises(ValueError):
        tebs.skip_sweep(users, items_t, excl, 8, 256, 9)
    with pytest.raises(TypeError):
        terk.dot_sweep(users.half(), items_t, True)
