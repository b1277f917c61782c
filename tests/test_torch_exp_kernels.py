"""The port's kernel-variant experiments vs the JAX package's tools.

Each plain version (what the port's wrappers compute for CPU tensors) is
held bit for bit against the JAX tool's Pallas kernel, run on the CPU under
``pltpu.force_tpu_interpret_mode()``, on integer-valued tables (every sum
is exact in fp32, and ties are many): values, ids, ghosts and skip counts.
The ported table generators give the JAX tools' tables for the same seed,
the wrappers refuse what their kernels do not take, and each tool's
``main()`` runs on the CPU."""
import exp_blockskip as jebs
import exp_multiacc as jema
import exp_retrieval_kernels as jerk
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from coldrec_tpu_torch.tools import exp_blockskip as tebs
from coldrec_tpu_torch.tools import exp_multiacc as tema
from coldrec_tpu_torch.tools import exp_retrieval_kernels as terk

B, I, D = 16, 2048, 8
TILE_U = 8  # the JAX kernels' user tile (changes no result but the skip's)


def _int_tables(seed, n_users=B, n_items=I, d=D, lo=-4, hi=4, item_lo=-4):
    rng = np.random.default_rng(seed)
    users = rng.integers(lo, hi + 1, (n_users, d)).astype(np.float32)
    items_t = rng.integers(item_lo, 5, (d, n_items)).astype(np.float32)
    excl = (rng.random((1, n_items)) < 0.2).astype(np.int8)
    return users, items_t, excl


def _firing_tables(seed, n_items=4096, block_i=256):
    """Positive users and non-negative items scaled down block by block
    (block j by n_blocks - j): later blocks are dominated, so skips fire."""
    users, items_t, excl = _int_tables(seed, n_items=n_items, lo=1, item_lo=0)
    scale = np.repeat(np.arange(n_items // block_i, 0, -1), block_i)
    return users, items_t * scale.astype(np.float32)[None], excl


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _assert_equal(port, jax_out):
    assert len(port) == len(jax_out)
    for p, j in zip(port, jax_out):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


@pytest.mark.parametrize("transposed", [False, True])
def test_dot_plain_matches_jax(transposed):
    users, items_t, _ = _int_tables(0)
    items = items_t if transposed else items_t.T.copy()
    with pltpu.force_tpu_interpret_mode():
        ref = jerk.dot_sweep(users, items, TILE_U, 512, transposed)
    got = terk.dot_sweep(*_t(users, items), transposed)
    _assert_equal([got], [ref])


@pytest.mark.parametrize("block_i", [128, 512])
def test_stream_plain_matches_jax(block_i):
    users, items_t, excl = _int_tables(1, n_items=1024)
    with pltpu.force_tpu_interpret_mode():
        ref = jerk.stream_sweep(users, items_t, excl, TILE_U, block_i)
    u, it, ex = _t(users, items_t, excl[0])
    _assert_equal(terk.stream_sweep(u, it, ex, block_i), ref)


@pytest.mark.parametrize("p_acc", [1, 2, 4, 8])
def test_multiacc_plain_matches_jax(p_acc):
    users, items_t, excl = _int_tables(2, n_items=1024)
    with pltpu.force_tpu_interpret_mode():
        ref = jema.multiacc_sweep(users, items_t, excl, TILE_U, 512, p_acc)
    u, it, ex = _t(users, items_t, excl[0])
    _assert_equal(tema.multiacc_sweep(u, it, ex, 512, p_acc), ref)


@pytest.mark.parametrize("floor_slot", [0, 7])
def test_skip_plain_matches_jax_where_skips_fire(floor_slot):
    """13 users: the port pads them with zero rows to the tile, as the JAX
    tool's ``_pad_inputs`` does, and pad rows take part in the predicate
    (a zero row's block max, 0, never falls below its floor, 0, so the
    padded tile never skips); their rows are not returned."""
    users, items_t, excl = _firing_tables(3)
    users[13:] = 0
    with pltpu.force_tpu_interpret_mode():
        cv, ci, gh, sk = jebs._skip_sweep(users, items_t, excl, TILE_U, 256,
                                          floor_slot)
    skips = np.asarray(sk)[::8, 0]  # one (8, 128) broadcast block per tile
    assert skips[0] > 0 and skips[1] == 0, skips
    u, it, ex = _t(users[:13], items_t, excl[0])
    got = tebs.skip_sweep(u, it, ex, TILE_U, 256, floor_slot)
    assert got[0].shape == (13, 1024)
    _assert_equal(got, [cv[:13], ci[:13], gh[:13], skips])
    if floor_slot == 0:
        # here the skipped blocks change the candidates: a result the
        # stream sweep does not give
        stream = terk.stream_sweep(u, it, ex, 256)
        assert not all(torch.equal(a, b) for a, b in zip(got[:3], stream))


NAN_ITEMS = 1536  # a whole number of blocks of 128, 384 and 512 items


def _nan_items(items_t, excl, live=(259, 650, 1029, 1283), dead=(700,)):
    """NaN item columns. Item 259 is lane class 3 in slice 2 of the first
    block of 384 or 512 items, so the finite candidates of slices 0 and 1
    come ahead of it; 650 lies in slice 2 of the second 384-item block,
    which starts at an odd item group (so a chain index taken from the
    global group differs from the block-relative slice's at P = 2); 1283
    is a second NaN of class 3. The ``dead`` items are excluded and score
    NEG."""
    items_t, excl = items_t.copy(), excl.copy()
    items_t[:, list(live + dead)] = np.nan
    excl[0, list(live)] = 0
    excl[0, list(dead)] = 1
    return items_t, excl


def _nan_table(seed=10):
    users, items_t, excl = _int_tables(seed, n_users=8, n_items=NAN_ITEMS)
    return (users,) + _nan_items(items_t, excl)


@pytest.mark.parametrize("transposed", [False, True])
def test_dot_plain_matches_jax_on_nan_table(transposed):
    """A NaN score makes its lane class's max NaN (``maximum``)."""
    users, items_t, _ = _nan_table()
    items = items_t if transposed else items_t.T.copy()
    with pltpu.force_tpu_interpret_mode():
        ref = jerk.dot_sweep(users, items, TILE_U, 512, transposed)
    assert np.isnan(np.asarray(ref)).any()
    _assert_equal([terk.dot_sweep(*_t(users, items), transposed)], [ref])


# multiacc at every P on blocks of 4 slices, and at P > 1 on blocks of 3
# (a slice count that is no multiple of P)
NAN_CASES = ([("stream", 1, block_i) for block_i in (128, 512)]
             + [("multiacc", p, 512) for p in tema.P_ACC]
             + [("multiacc", p, 384) for p in tema.P_ACC if p > 1])


@pytest.mark.parametrize("variant,p_acc,block_i", NAN_CASES)
def test_plain_matches_jax_on_nan_table(variant, p_acc, block_i):
    """Each variant keeps NaN as its own JAX tool does: stream's chain
    (``where``) keeps a block's finite top-2 and turns m3 and the ghost
    NaN; multiacc's (``maximum``/``minimum``) turns its chain NaN for the
    rest of the block, and ``_merge_two`` lets a NaN in the higher chain
    win; values, ids and ghosts equal, NaN at the same places."""
    users, items_t, excl = _nan_table()
    with pltpu.force_tpu_interpret_mode():
        if variant == "stream":
            ref = jerk.stream_sweep(users, items_t, excl, TILE_U, block_i)
        else:
            ref = jema.multiacc_sweep(users, items_t, excl, TILE_U, block_i,
                                      p_acc)
    u, it, ex = _t(users, items_t, excl[0])
    got = (terk.stream_sweep(u, it, ex, block_i) if variant == "stream"
           else tema.multiacc_sweep(u, it, ex, block_i, p_acc))
    assert np.isnan(np.asarray(ref[2])).any()  # the NaN reached the ghosts
    assert not np.isnan(np.asarray(ref[0])).any()  # and no slot
    _assert_equal(got, ref)


@pytest.mark.parametrize("floor_slot", [0, 7])
def test_skip_plain_matches_jax_on_nan_table(floor_slot):
    """The skip sweep takes the stream chain, and a block whose max is NaN
    never skips; a NaN ghost stays NaN through the skipped blocks."""
    users, items_t, excl = _firing_tables(11, block_i=512)
    items_t, excl = _nan_items(items_t, excl)
    with pltpu.force_tpu_interpret_mode():
        cv, ci, gh, sk = jebs._skip_sweep(users, items_t, excl, TILE_U, 512,
                                          floor_slot)
    skips = np.asarray(sk)[::8, 0]
    assert skips.sum() > 0 and np.isnan(np.asarray(gh)).any()
    got = tebs.skip_sweep(*_t(users, items_t, excl[0]), TILE_U, 512,
                          floor_slot)
    _assert_equal(got, [cv, ci, gh, skips])


def test_multiacc_is_stream_only_without_nan():
    """On a finite table every P gives the stream sweep's result; on the
    NaN table P = 1 and P = 2 do not (a NaN ends a multiacc chain's
    block), as the JAX tools do not."""
    users, items_t, excl = _int_tables(12, n_users=8, n_items=NAN_ITEMS)
    for table in ((users, items_t, excl), _nan_table()):
        u, it, ex = _t(table[0], table[1], table[2][0])
        stream = terk.stream_sweep(u, it, ex, 512)
        same = [all(np.array_equal(a.numpy(), b.numpy(), equal_nan=True)
                    for a, b in zip(tema.multiacc_sweep(u, it, ex, 512, p),
                                    stream))
                for p in tema.P_ACC]
        if table[0] is users:
            assert all(same)
        else:
            assert not same[0] and not same[1]


def test_make_inputs_matches_jax():
    ref = jema.make_inputs(20, 1000, TILE_U, 256, seed=5)
    got = tema.make_inputs(20, 1000, TILE_U, 256, seed=5, device="cpu")
    ref = list(ref)
    ref[2] = np.asarray(ref[2])[0]  # the JAX tool's (1, I_pad) row
    _assert_equal(got, ref)


@pytest.mark.parametrize("regime", ["iid", "skew", "skew_sorted"])
def test_make_tables_matches_jax(regime):
    ref = jebs.make_tables(regime, 12, 700, np.random.default_rng(6))
    got = tebs.make_tables(regime, 12, 700, np.random.default_rng(6))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))


def test_pad_inputs_matches_jax():
    ue, ie = tebs.make_tables("iid", 13, 700, np.random.default_rng(7))
    ref = jebs._pad_inputs(ue, ie, TILE_U, 256)
    got = tebs._pad_inputs(ue, ie, TILE_U, 256, device="cpu")
    _assert_equal(got, [ref[0], ref[1], np.asarray(ref[2])[0]])


def _bad_calls():
    u = torch.zeros((4, 8))
    it = torch.zeros((8, 512))
    ex = torch.zeros(512, dtype=torch.int8)
    return {
        "stream ragged block": lambda: terk.stream_sweep(u, it, ex, 384),
        "stream block not x128": lambda: terk.stream_sweep(u, it, ex, 200),
        "multiacc ragged block": lambda: tema.multiacc_sweep(u, it, ex, 384,
                                                              2),
        "multiacc P": lambda: tema.multiacc_sweep(u, it, ex, 256, 3),
        "skip ragged block": lambda: tebs.skip_sweep(u, it, ex, 8, 384, 0),
        "skip tile": lambda: tebs.skip_sweep(u, it, ex, 6, 256, 0),
        "skip floor slot": lambda: tebs.skip_sweep(u, it, ex, 8, 256, 8),
        "dot ragged items": lambda: terk.dot_sweep(u, torch.zeros((8, 500)),
                                                   True),
        "dot dtype": lambda: terk.dot_sweep(u.double(), it, True),
        "stream dtype": lambda: terk.stream_sweep(u.double(), it, ex, 256),
        "stream excl dtype": lambda: terk.stream_sweep(u, it, ex.bool(), 256),
        "multiacc bf16": lambda: tema.multiacc_sweep(u.bfloat16(), it, ex,
                                                     256, 2),
        "dot contiguity": lambda: terk.dot_sweep(u, it.T, False),
        "stream contiguity": lambda: terk.stream_sweep(
            u, torch.zeros((512, 8)).T, ex, 256),
        "skip contiguity": lambda: tebs.skip_sweep(
            torch.zeros((8, 4)).T, it, ex, 8, 256, 0),
        # a device with no kernel (meta): no plain fallback either
        "dot meta": lambda: terk.dot_sweep(u.to("meta"), it.to("meta"), True),
        "stream meta": lambda: terk.stream_sweep(
            u.to("meta"), it.to("meta"), ex.to("meta"), 256),
        "multiacc meta": lambda: tema.multiacc_sweep(
            u.to("meta"), it.to("meta"), ex.to("meta"), 256, 2),
        "skip meta": lambda: tebs.skip_sweep(
            u.to("meta"), it.to("meta"), ex.to("meta"), 4, 256, 0),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_wrappers_refuse_what_their_kernels_do_not_take(case):
    with pytest.raises((ValueError, TypeError, NotImplementedError)) as e:
        _bad_calls()[case]()
    if "meta" in case:
        assert "kernel for device meta" in str(e.value)


@pytest.mark.parametrize("tool,argv", [
    (terk, ["--users", "12", "--items", "1000", "--dim", "8", "--iters", "1",
            "--block_i", "256"]),
    (tema, ["--users", "12", "--items", "1000", "--tile_u", "8",
            "--block_i", "512", "--iters", "1"]),
    (tebs, ["--users", "12", "--items", "512", "--block_i", "256",
            "--iters", "1"]),
])
def test_tool_main_runs_on_cpu(tool, argv, capsys):
    tool.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "device=cpu" in out
    assert "G pairs/s" in out


def test_multiacc_check_and_blockskip_check_exact_on_cpu(capsys):
    tema.check(n_users=16, n_items=2048, tile_u=TILE_U, block_i=512,
               device="cpu")
    assert capsys.readouterr().out.count("bit-identical") == 2
    rng = np.random.default_rng(8)
    ue, ie = tebs.make_tables("skew_sorted", 16, 2048, rng)
    rat = np.full((16, 8), 2048, np.int32)
    rat[:, :3] = rng.choice(2048, (16, 3))
    stats = tebs.check_exact(ue, ie, rat, TILE_U, 256, 0, device="cpu")
    assert 0.0 <= stats["skip_rate"] <= 1.0
    assert stats["flags_skip"] >= 0 and stats["flags_prod"] >= 0


def _cta_rows(layout, tile_u, b_pad):
    """(first row, rows) of each CTA, as ``csrc/exp_blockskip.cu`` derives
    them from the layout."""
    out = []
    for x in range(layout.ctas):
        if layout.cluster == 1:
            u0 = x * layout.cta_users
            out.append((u0, min(layout.cta_users, b_pad - u0)))
        else:
            r = x % layout.cluster
            u0 = x // layout.cluster * tile_u + r * layout.cta_tile
            out.append((u0, min(layout.cta_tile, tile_u - r * layout.cta_tile)))
    return out


@pytest.mark.parametrize("tile_u", [4, 8, 12, 16, 64, 256, 260])
@pytest.mark.parametrize("n_tiles", [1, 3, 8])
def test_skip_layout_covers_every_tile(tile_u, n_tiles):
    """Every row lies in one CTA, a CTA holds whole tiles or the rows of
    one tile, the rows of a tile lie in one cluster of at most 16 CTAs, and
    no CTA holds more rows than its tile."""
    b_pad = tile_u * n_tiles
    lay = tebs.skip_layout(tile_u, b_pad)
    assert lay.cta_tile in tebs.CTA_TILES
    assert 1 <= lay.cluster <= tebs.MAX_CLUSTER
    rows = _cta_rows(lay, tile_u, b_pad)
    assert len(rows) == lay.ctas
    seen = np.zeros(b_pad, int)
    for x, (u0, n) in enumerate(rows):
        assert 0 < n <= lay.cta_tile
        seen[u0:u0 + n] += 1
        if lay.cluster == 1:
            assert u0 % tile_u == 0 and n % tile_u == 0
        else:
            assert (u0 // tile_u == (u0 + n - 1) // tile_u
                    == x // lay.cluster)
    assert (seen == 1).all()
    if tile_u <= 16 * tebs.MAX_CLUSTER:
        assert lay.cta_tile == 16
    if tile_u > 16:
        assert lay.cluster == -(-tile_u // lay.cta_tile)


def test_skip_layout_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        tebs.skip_layout(6, 12)
    with pytest.raises(ValueError):
        tebs.skip_layout(8, 12)
    with pytest.raises(ValueError):
        tebs.skip_layout(0, 16)
    assert tebs.skip_layout(512, 512) == (32, 32, 16, 16)  # the widest
    assert tebs.skip_layout(520, 520).cluster == 17  # the card refuses it
