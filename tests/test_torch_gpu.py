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
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

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
    with pytest.raises(TypeError, match="one type"):
        tret.fused_sweep(users.bfloat16(), items_t, excl)
    with pytest.raises(TypeError):
        tret.fused_sweep(users.double(), items_t.double(), excl)
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


# ---------------------------------------------------------------- training
# Card vs CPU MF steps: the same loss in another summation order (and, on
# the card, the index backward's accumulation order). Adam's first steps are
# ~lr * sign(g), so an element whose gradient cancels to ~0 may flip sign
# and move by up to 2 * lr a step; at most STEP_FLIPS of the elements may
# lie beyond STEP_ATOL.
STEP_ATOL = 1e-5
STEP_FLIPS = 1e-4


def _mf_trainer(data, device, init, epochs=1, **kw):
    from coldrec_tpu_torch.config import default_args
    from coldrec_tpu_torch.models.mf import MFTrainer
    from coldrec_tpu_torch.runtime.trainer import Config

    args = default_args(model="MF", epochs=epochs, bs=256, emb_size=16,
                        save_emb=False, seed=1, device=str(device), **kw)
    return MFTrainer(Config(args, data), init_params=init)


def _small_data():
    from coldrec_tpu_torch.data.synthetic import synthetic_dataset

    return synthetic_dataset(n_users=300, n_items=2000, n_inter=9000,
                             seed=6)[0]


def _init_tables(data, d=16, seed=2):
    rng = np.random.default_rng(seed)
    return {"user_emb": rng.standard_normal((data.user_num, d)).astype(
        np.float32) * 0.1,
        "item_emb": rng.standard_normal((data.item_num, d)).astype(
            np.float32) * 0.1}


def test_mf_steps_on_card_match_cpu(cuda):
    from coldrec_tpu_torch.data.sampler import pairwise_batches

    data = _small_data()
    init = _init_tables(data)
    card, cpu = (_mf_trainer(data, dev, init) for dev in (cuda, "cpu"))
    for _, batch in zip(range(20), pairwise_batches(
            data, 256, np.random.default_rng(0))):
        lg = card.train_step(card.upload(batch))
        lc = cpu.train_step(cpu.upload(batch))
        assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    for a, b in zip(card.model.forward_tables(), cpu.model.forward_tables()):
        diff = (a.detach().cpu() - b.detach()).abs()
        assert float(diff.max()) <= 2 * 1e-3 * 20
        assert int((diff > STEP_ATOL).sum()) <= STEP_FLIPS * diff.numel()


def test_fast_evaluation_lists_of_trained_tables_match_plain(cuda):
    """Validation lists of trained tables through the kernel equal the plain
    path's, except at near-ties (scores within 1e-5 of the row's top)."""
    from coldrec_tpu_torch.runtime.trainer import rec_lists

    data = _small_data()
    tm = _mf_trainer(data, cuda, _init_tables(data), epochs=2)
    before = tret.fused_sweep.launches
    tm.train()
    assert tret.fused_sweep.launches > before
    assert [s["epoch"] for s in tm.epoch_stats] == [1, 2]
    assert all(s["step_device_s"] > 0 for s in tm.epoch_stats)
    ue, ie = tm.user_emb, tm.item_emb
    for setting in ("all", "cold", "warm"):
        got = tm.valid(setting)
        ref = rec_lists(tm.sweep, "valid", setting, ue, ie, backend="plain")
        users = data.eval_splits[
            {"all": "overall_val", "cold": "cold_val",
             "warm": "warm_val"}[setting]].users
        for r in np.flatnonzero((got != ref).any(axis=1)):
            u = ue[int(users[r])]
            sa = ie[torch.as_tensor(got[r], device=cuda).long()] @ u
            sb = ie[torch.as_tensor(ref[r], device=cuda).long()] @ u
            scale = float(torch.maximum(sa.abs().max(), sb.abs().max()))
            assert float((sa - sb).abs().max()) <= 1e-5 * scale


def test_host_sampler_builds_on_the_card_machine(cuda):
    from coldrec_tpu_torch import native

    path = native.build()
    assert path.exists() and path.parent == native.BUILD_DIR
    data = _small_data()
    users = data.train_pairs[:1000, 0]
    negs = native.sample_negatives_native(
        data.train_indptr, data.train_items_sorted, users, data.n_seen_items,
        7)
    assert negs.shape == (1000,) and not data.is_rated(users, negs).any()
    np.testing.assert_array_equal(negs, native.sample_negatives_native(
        data.train_indptr, data.train_items_sorted, users, data.n_seen_items,
        7))


# ---------------------------------------------------------------- bf16 mode
def _bf16(*tensors):
    return tuple(t.to(torch.bfloat16) for t in tensors)


@pytest.mark.parametrize("n_users,d", SPLIT_SHAPES)
def test_bf16_kernel_integer_tables_exact(cuda, n_users, d):
    """Integer tables in [-3, 3] are exact in bf16: the bf16 instance (any
    part count, resident or staged users) equals its plain version, the
    fp32 sweep of the widened tables, bit for bit."""
    users, items_t, excl_row = _int_sweep_inputs(cuda, n_users, 3000, d,
                                                 seed=n_users + d)
    ub, ib = _bf16(users, items_t)
    before = (tret.fused_sweep.launches, tret.fused_sweep.launches_bf16)
    got = tret.fused_sweep(ub, ib, excl_row)
    torch.cuda.synchronize(cuda)
    assert (tret.fused_sweep.launches,
            tret.fused_sweep.launches_bf16) == (before[0], before[1] + 1)
    for g, r in zip(got, tret.fused_sweep_reference(users, items_t,
                                                    excl_row)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("n_users", [70, 512])
def test_bf16_kernel_nan_items_match_plain(cuda, n_users):
    users, items_t, excl_row, nan_class = _int_sweep_nan(
        cuda, n_users, 5000, 16, seed=9, nan_items=200)
    got = tret.fused_sweep(*_bf16(users, items_t), excl_row)
    for g, r in zip(got, tret.fused_sweep_reference(users, items_t,
                                                    excl_row)):
        assert _same(g, r)
    assert torch.equal(got[2].isnan(), nan_class.expand_as(got[2]))


def test_bf16_kernel_matches_plain_on_normal_tables(cuda):
    """N(0,1) tables: the products are exact, only the order of the fp32
    sums differs from the plain version (cuBLAS), so the values agree
    within TOL, and ``retrieval_topk(bf16=True)`` lists equal the CPU's
    plain bf16 lists but at near-ties."""
    ue, ie, excluded, rated = _tables(cuda, 2 * tret.USER_CHUNK + 5, 4000,
                                      64, seed=5)
    users = torch.as_tensor(ue, device=cuda)
    items_t, excl_row = tret.pad_items(torch.as_tensor(ie, device=cuda),
                                       torch.as_tensor(excluded, device=cuda))
    cv, ci, gh = tret.fused_sweep(*_bf16(users, items_t), excl_row)
    rv, ri, rg = tret.fused_sweep_reference(
        tret.bf16_round(users), tret.bf16_round(items_t), excl_row)
    torch.testing.assert_close(cv, rv, rtol=0, atol=TOL)
    torch.testing.assert_close(gh, rg, rtol=0, atol=TOL)
    before = tret.fused_sweep.launches_bf16
    gv, gi = tret.retrieval_topk(ue, ie, rated, excluded, 20, device=cuda,
                                 bf16=True)
    assert tret.fused_sweep.launches_bf16 == before + 3
    cv2, ci2 = tret.retrieval_topk(ue, ie, rated, excluded, 20,
                                   device="cpu", bf16=True)
    np.testing.assert_allclose(gv, cv2, rtol=0, atol=TOL)
    ub = tret.bf16_round(torch.as_tensor(ue)).numpy()
    ib = tret.bf16_round(torch.as_tensor(ie)).numpy()
    for r in np.flatnonzero((gi != ci2).any(axis=1)):
        sa, sb = ib[gi[r]] @ ub[r], ib[ci2[r]] @ ub[r]
        np.testing.assert_allclose(sa, sb, atol=1e-5 * np.abs(sb).max())


@pytest.mark.parametrize("n_users,d", [(130, 17), (130, 31), (130, 2312)])
def test_bf16_kernel_integer_tables_exact_at_more_depths(cuda, n_users, d):
    """Depths that end inside a k-step of the tensor cores (17, 31: the
    tail up to 16 is zero in both operands) and one whose user tile is
    staged step by step beside the items (2,312): bit for bit equal to the
    plain version."""
    users, items_t, excl_row = _int_sweep_inputs(cuda, n_users, 3000, d,
                                                 seed=n_users + d)
    got = tret.fused_sweep(*_bf16(users, items_t), excl_row)
    for g, r in zip(got, tret.fused_sweep_reference(users, items_t,
                                                    excl_row)):
        assert torch.equal(g, r)


def test_bf16_kernel_ties_across_parts_keep_the_lowest_ids(cuda):
    """Scores with few distinct values (items of 0/1 entries, d=4): most
    items of a lane class tie, within a part and across the parts the
    sweep is split into, and the slots hold the lowest ids of each value,
    as in the plain version."""
    rng = np.random.default_rng(11)
    users = torch.ones((130, 4), device=cuda)
    items = torch.as_tensor(rng.integers(0, 2, (20000, 4)).astype(np.float32),
                            device=cuda)
    excluded = torch.as_tensor(rng.random(20000) < 0.1, device=cuda)
    items_t, excl_row = tret.pad_items(items, excluded)
    assert tret.sweep_parts("coldrec_fused_sweep_bf16_parts", cuda, 130, 4,
                            items_t.shape[1]) > 1
    got = tret.fused_sweep(*_bf16(users, items_t), excl_row)
    ref = tret.fused_sweep_reference(users, items_t, excl_row)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert int((ref[0] == 4.0).sum()) > 130 * tret.LANES  # ties in slots


def test_bf16_kernel_at_serving_shape_within_tol(cuda):
    """2048 users x 270,170 items (book-crossing's), d=64, N(0,1) tables:
    values and ghosts within TOL of the plain version (the tensor cores'
    fp32 sums in another order), every non-candidate below the ghost."""
    ue, ie, excluded, _ = _tables(cuda, 2048, 270_170, 64, seed=7)
    users = tret.bf16_round(torch.as_tensor(ue, device=cuda))
    items_t, excl_row = tret.pad_items(
        tret.bf16_round(torch.as_tensor(ie, device=cuda)),
        torch.as_tensor(excluded, device=cuda))
    cv, ci, gh = tret.fused_sweep(*_bf16(users, items_t), excl_row)
    rv, ri, rg = tret.fused_sweep_reference(users, items_t, excl_row)
    torch.testing.assert_close(cv, rv, rtol=0, atol=TOL)
    torch.testing.assert_close(gh, rg, rtol=0, atol=TOL)
    for s in range(0, 2048, 256):
        z = (users[s:s + 256] @ items_t).masked_fill(
            excl_row.bool()[None], tret.NEG)
        filled = cv[s:s + 256] > tret.INIT_NEG
        cid = torch.where(filled, ci[s:s + 256], ci[s:s + 256, :1]).long()
        torch.testing.assert_close(z.gather(1, cid)[filled],
                                   cv[s:s + 256][filled], rtol=0, atol=TOL)
        z.scatter_(1, cid, -float("inf"))
        assert bool((z.max(1).values
                     <= gh[s:s + 256].max(1).values + TOL).all())


def test_bf16_kernel_keeps_subnormal_inputs(cuda):
    """bf16 subnormals are not flushed: 2^-130 (a user value) x 2^100 and
    2^-100 x 2^-40 (a subnormal fp32 product) score as the plain version
    does."""
    excl = torch.zeros(tret.LANES, dtype=torch.int8, device=cuda)
    for uv, iv in ((2.0 ** -130, 2.0 ** 100), (2.0 ** -100, 2.0 ** -40)):
        users = torch.zeros((1, 16), device=cuda)
        users[0, 0] = uv
        items_t = torch.zeros((16, tret.LANES), device=cuda)
        items_t[0, 3] = iv
        got = tret.fused_sweep(*_bf16(users, items_t), excl)
        ref = tret.fused_sweep_reference(users, items_t, excl)
        assert float(got[0][0, 3]) == float(ref[0][0, 3]) == uv * iv != 0


def test_bf16_kernel_refuses_misaligned_items(cuda):
    users, items_t, excl_row = _int_sweep_inputs(cuda, 8, 300, 16, seed=1)
    ub, ib = _bf16(users, items_t)
    flat = torch.zeros(ib.numel() + 1, dtype=torch.bfloat16, device=cuda)
    odd = flat[1:].view_as(ib)
    odd.copy_(ib)
    with pytest.raises(ValueError, match="16-byte"):
        tret.fused_sweep(ub, odd, excl_row)
    with pytest.raises(TypeError, match="one type"):
        tret.fused_sweep(ub, items_t, excl_row)
    excl_odd = torch.zeros(excl_row.numel() + 1, dtype=torch.int8,
                           device=cuda)[1:]
    excl_odd.copy_(excl_row)
    with pytest.raises(ValueError, match="16-byte"):
        tret.fused_sweep(ub, ib, excl_odd)


# ------------------------------------------------------------ graph path
def _graph_data():
    from coldrec_tpu_torch.data.synthetic import synthetic_dataset

    return synthetic_dataset(n_users=300, n_items=500, n_inter=9000,
                             cold_object="item", seed=3)[0]


def test_spmm_on_card_matches_cpu(cuda):
    """The ELL + tail apply and its symmetric backward on the card against
    the same plain torch on the CPU (fp32 sums in another order)."""
    from coldrec_tpu_torch.ops import spmm

    data = _graph_data()
    gen = torch.Generator().manual_seed(0)
    n = data.norm_adj.shape[0]
    x, g = (torch.randn((n, 64), generator=gen) for _ in range(2))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        graph = spmm.build_ell(data.norm_adj, device=dev)
        assert graph.tail_rows.shape[0] > 0
        xr = x.to(dev).requires_grad_(True)
        y = spmm.SymSpmm(graph)(xr)
        y.backward(g.to(dev))
        out[dev.type] = (spmm.ell_apply(graph, x.to(dev)).cpu(),
                         y.detach().cpu(), xr.grad.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_unique_padded_and_info_nce_do_not_sync(cuda):
    """SimGCL's CL term runs without a device -> host synchronisation."""
    from coldrec_tpu_torch.ops.losses import info_nce_masked, unique_padded

    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 100, (256,), generator=gen).to(cuda)
    w = torch.ones(256, device=cuda)
    w[-17:] = 0
    v1, v2 = (torch.randn((101, 16), generator=gen).to(cuda)
              for _ in range(2))
    torch.cuda.synchronize(cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        u, m = unique_padded(ids, w, 256, 100)
        loss = info_nce_masked(v1[u], v2[u], m, 0.2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cu, cm = unique_padded(ids.cpu(), w.cpu(), 256, 100)
    assert torch.equal(u.cpu(), cu) and torch.equal(m.cpu(), cm)
    ref = info_nce_masked(v1.cpu()[cu], v2.cpu()[cu], cm, 0.2)
    torch.testing.assert_close(loss.cpu(), ref, rtol=1e-5, atol=0)


def test_kmeans_on_card_matches_cpu(cuda):
    from coldrec_tpu_torch.ops.kmeans import kmeans

    x = torch.randn((3000, 64), generator=torch.Generator().manual_seed(2))
    init = torch.randperm(3000, generator=torch.Generator().manual_seed(3))[
        :20]
    gc, ga = kmeans(x.to(cuda), 20, init_idx=init)
    cc, ca = kmeans(x, 20, init_idx=init)
    assert torch.equal(ga.cpu(), ca)
    torch.testing.assert_close(gc.cpu(), cc, rtol=0, atol=1e-5)


@pytest.mark.parametrize("model", ["LightGCN", "SimGCL"])
def test_graph_steps_on_card_match_cpu(cuda, model):
    """5 steps of a graph model on the card and on the CPU from the same
    tables and batches (SimGCL: the same injected noise): losses within
    1e-5 relative, tables within 2 * lr a step (Adam's sign flips)."""
    from coldrec_tpu_torch.config import default_args
    from coldrec_tpu_torch.data.sampler import pairwise_batches
    from coldrec_tpu_torch.models import TRAINERS
    from coldrec_tpu_torch.models.lightgcn import GraphTables
    from coldrec_tpu_torch.runtime.trainer import Config

    data = _graph_data()
    init = {k: v.detach().numpy() for k, v in GraphTables(
        data.user_num, data.item_num, 32, seed=4,
        device="cpu").named_parameters()}
    trainers = [TRAINERS[model](Config(default_args(
        model=model, emb_size=32, bs=512, seed=4, save_emb=False,
        device=str(dev)), data), init_params=init)
        for dev in (cuda, torch.device("cpu"))]
    rng = np.random.default_rng(5)
    n = data.user_num + data.item_num
    for _, batch in zip(range(5), pairwise_batches(
            data, 512, np.random.default_rng(4))):
        kw = [{}, {}]
        if model == "SimGCL":
            noise = rng.random((2, 2, n, 32), dtype=np.float32)
            kw = [{"noise_pair": tuple(torch.as_tensor(v, device=t.device)
                                       for v in noise)} for t in trainers]
        a, b = (float(t.train_step(t.upload(batch), **k))
                for t, k in zip(trainers, kw))
        assert abs(a - b) <= 1e-5 * abs(b), (a, b)
    for p, q in zip(trainers[0].model.parameters(),
                    trainers[1].model.parameters()):
        assert float((p.detach().cpu() - q.detach()).abs().max()) <= \
            2 * 1e-3 * 5


# content KNN at book-crossing's content widths: the item content (416, the
# user tile resident) and the user content (2,312, the user tile staged)
@pytest.mark.parametrize("d", [416, 2312])
def test_knn_kernel_route_matches_plain_on_integer_tables(cuda, d):
    """``knn_inner_product`` takes the kernel route on the card: on integer
    tables (exact products) its ids and values equal the plain route's bit
    for bit, all-zero query rows included (every score ties)."""
    from coldrec_tpu_torch.ops import knn as tknn

    rng = np.random.default_rng(d)
    queries = rng.integers(-3, 4, (3000, d)).astype(np.float32)
    values = rng.integers(-3, 4, (9000, d)).astype(np.float32)
    queries[:4] = 0.0
    assert tknn.knn_route(len(values), 5, cuda) == "kernel"
    before = tret.fused_sweep.launches
    s, i = tknn.knn_inner_product(queries, values, 5, chunk=1024,
                                  device=cuda)
    assert tret.fused_sweep.launches > before
    ps, pi = tknn.knn_plain(queries, values, 5, chunk=1024, device=cuda)
    np.testing.assert_array_equal(i, pi)
    np.testing.assert_array_equal(s, ps)
    np.testing.assert_array_equal(i[:4], np.tile(np.arange(5), (4, 1)))


def test_kernel_at_d2312_matches_plain(cuda):
    """The sweep at d = 2,312 (the staged user tile), split into parts and
    merged, bit for bit against ``fused_sweep_reference`` on integer
    tables, and on N(0,1) ones within 1e-2 (scores reach ~250 at this
    depth; the two fp32 sum orders part by well under 1e-2)."""
    users, items_t, excl_row = _int_sweep_inputs(cuda, 300, 20_000, 2312, 7)
    got = tret.fused_sweep(users, items_t, excl_row)
    ref = tret.fused_sweep_reference(users, items_t, excl_row)
    assert all(_same(g, r) for g, r in zip(got, ref))
    rng = np.random.default_rng(8)
    users = torch.as_tensor(rng.standard_normal((300, 2312),
                                                dtype=np.float32), device=cuda)
    cv, _, gh = tret.fused_sweep(users, items_t.normal_(generator=torch.
                                                        Generator(cuda)),
                                 excl_row)
    rv, _, rg = tret.fused_sweep_reference(users, items_t, excl_row)
    torch.testing.assert_close(cv, rv, rtol=0, atol=1e-2)
    torch.testing.assert_close(gh, rg, rtol=0, atol=1e-2)


# FSGNN's cosine-kNN graphs search a table against itself: the item side at
# book-crossing's 416 content columns, the user side at its 32 fallback
# columns (no user content under item cold start); k = fsgnn_knn_k + 1
@pytest.mark.parametrize("d", [416, 32])
def test_knn_self_search_matches_plain_on_integer_tables(cuda, d):
    """The square self-search (queries = values) through the kernel route,
    bit for bit against the plain route on integer tables: ids and values,
    duplicate and all-zero rows (ties across the cut) included."""
    from coldrec_tpu_torch.ops import knn as tknn

    rng = np.random.default_rng(d + 1)
    table = rng.integers(-3, 4, (12_000, d)).astype(np.float32)
    table[:3] = 0.0
    table[100:110] = table[99]
    assert tknn.knn_route(len(table), 16, cuda) == "kernel"
    before = tret.fused_sweep.launches
    s, i = tknn.knn_inner_product(table, table, 16, device=cuda)
    assert tret.fused_sweep.launches > before
    ps, pi = tknn.knn_plain(table, table, 16, device=cuda)
    np.testing.assert_array_equal(i, pi)
    np.testing.assert_array_equal(s, ps)


def test_usim_batch_step_on_card_matches_cpu(cuda, tmp_path):
    """One USIM batch step (3 rollouts, 5 PPO iterations, the termination
    step) on the card and on the CPU from the same seeded weights and the
    same draws, on the dense and on the chunked PPO path: the rollout
    actions equal, the losses within 1e-5 relative, the nets within 1e-3
    in relative norm; then the greedy inference of the cold items: the
    actions equal."""
    from coldrec_tpu_torch.config import default_args
    from coldrec_tpu_torch.data.synthetic import synthetic_dataset
    from coldrec_tpu_torch.models import TRAINERS
    from coldrec_tpu_torch.models import usim as tusim
    from coldrec_tpu_torch.runtime.trainer import Config

    data = synthetic_dataset(n_users=300, n_items=400, n_inter=6000,
                             content_dim=16, seed=3, cold_object="item")[0]
    for dense in (True, False):
        trainers = [TRAINERS["USIM"](Config(default_args(
            model="USIM", dataset="synth", emb_dir=str(tmp_path), emb_size=16,
            bs=64, seed=4, save_emb=False, device=str(dev)), data))
            for dev in (cuda, torch.device("cpu"))]
        if not dense:
            for t in trainers:
                t.model._DENSE_OPT_ELEMS = 0
        batch = next(iter(trainers[1].batches()))
        draws = trainers[1].draw(64)
        out = []
        for t in trainers:
            t.train_step(t.upload(batch), draws={
                k: v.to(t.device) for k, v in draws.items()})
            out.append({k: v.cpu() for k, v in t.last_step.items()})
        assert torch.equal(out[0]["actions"], out[1]["actions"])
        a, b = out[0]["losses"], out[1]["losses"]
        assert float(((a - b).abs() / b.abs().clamp_min(1e-12)).max()) \
            <= 1e-5, (a, b)
        for p, q in zip(trainers[0].model.parameters(),
                        trainers[1].model.parameters()):
            gap = float((p.detach().cpu() - q.detach()).norm()
                        / q.detach().norm().clamp_min(1e-30))
            assert gap <= 1e-3, gap
        m = [t.model for t in trainers]
        cold = trainers[1].cold_idx
        _, acts_card = m[0]._infer(m[0].actor, m[0].content[cold.to(cuda)],
                                   with_actions=True)
        _, acts_cpu = m[1]._infer(m[1].actor, m[1].content[cold],
                                  with_actions=True)
        assert torch.equal(acts_card.cpu(), acts_cpu)
        assert isinstance(m[0], tusim.USIM)


# ------------------------------------ the bench entry, --fused_steps
def test_bench_entry_gives_finite_device_figures(cuda):
    """The bench entry at a reduced sweep shape: every figure of its line
    (device times included) finite and positive, the card named, both
    sweeps launched."""
    from coldrec_tpu_torch import bench as tbench

    line = tbench.run("cuda", shape=(512, 20000))
    figures = {k: v for k, v in line.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
    assert all(np.isfinite(v) and v > 0 for v in figures.values()), figures
    assert not [k for k, v in line.items() if v is None], line
    assert line["device_kind"] == torch.cuda.get_device_name(0)
    assert line["kernel_launches"]["fused_sweep"] > 0
    assert line["kernel_launches"]["fused_sweep_bf16"] > 0


def test_fused_steps_on_card_equal_per_batch(cuda):
    """MF with --fused_steps 4 on the card: the same tables (the tolerance
    of tests/test_fused_steps.py) and test results as the per-batch loop."""
    data = _small_data()
    init = _init_tables(data)
    runs = []
    for k in (0, 4):
        tm = _mf_trainer(data, cuda, init, epochs=2, fused_steps=k)
        assert tm._use_fused() == k
        tm.run()
        runs.append(tm)
    base, fused = runs
    for a, b in ((base.user_emb, fused.user_emb),
                 (base.item_emb, fused.item_emb)):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    assert base.overall_test_results == fused.overall_test_results
    assert base.cold_test_results == fused.cold_test_results


SHARD_CHILD = r'''
import sys
import numpy as np
import torch
from coldrec_tpu_torch.ops.cuda import retrieval as tret
from coldrec_tpu_torch.parallel import ops
from coldrec_tpu_torch.parallel.distributed import (
    init_distributed, process_index, rank_device, shutdown_distributed)
from coldrec_tpu_torch.parallel.mesh import make_mesh

init_distributed(device="cuda")
dev = rank_device("cuda")
mesh = make_mesh(1, 2)
t = np.load(sys.argv[1])
ue = torch.as_tensor(t["ue"], device=dev)
local = torch.as_tensor(ops.shard_rows(mesh, t["ie"]), device=dev)
excl = torch.as_tensor(ops.shard_rows(mesh, t["excluded"]), device=dev)
tret.fused_sweep.launches = 0
vals, ids = ops.sharded_retrieval_topk(mesh, ue, local, t["rated"], excl, 20)
np.savez(f"{sys.argv[2]}{process_index()}.npz", vals=vals, ids=ids,
         launches=tret.fused_sweep.launches, device=str(dev))
shutdown_distributed()
'''


def test_sharded_retrieval_on_two_ranks_equals_unsharded(cuda, tmp_path):
    """Two ranks on the card, each sweeping its half of 270,170 items with
    the kernel, merge to the unsharded ``retrieval_topk``'s lists."""
    import os
    import sys

    from coldrec_tpu_torch.parallel.distributed import launch_ranks

    ue, ie, excluded, rated = _tables(cuda, 2048, 270_170, 64, seed=5)
    np.savez(tmp_path / "tables.npz", ue=ue, ie=ie, excluded=excluded,
             rated=rated)
    (tmp_path / "child.py").write_text(SHARD_CHILD)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = launch_ranks([sys.executable, str(tmp_path / "child.py"),
                         str(tmp_path / "tables.npz"), str(tmp_path / "r")],
                        2, 600, {**os.environ, "PYTHONPATH": repo})
    for code, out in runs:
        assert code == 0, out[-3000:]
    got = [np.load(tmp_path / f"r{r}.npz") for r in range(2)]
    vals, ids = tret.retrieval_topk(ue, ie, rated, excluded, 20, device=cuda)
    for g in got:
        assert int(g["launches"]) >= 1 and str(g["device"]) == "cuda:0"
        np.testing.assert_array_equal(g["ids"], ids)
        # a flagged row's exact scores come from cuBLAS on another shape
        np.testing.assert_allclose(g["vals"], vals, rtol=0, atol=TOL)


def test_dryrun_on_the_card(cuda):
    """``python -m coldrec_tpu_torch.parallel.dryrun --device cuda``: two
    ranks on the card, each phase against one rank, the server's kernel
    launched on every rank."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "coldrec_tpu_torch.parallel.dryrun",
         "--ranks", "2", "--device", "cuda"], cwd=repo, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    verdict = json.loads(proc.stdout.strip().splitlines()[-1])
    assert verdict["mf"]["bit_equal"] and verdict["serve"]["ids_equal"]
    assert verdict["serve"]["fused_sweep_launches"] >= 1
