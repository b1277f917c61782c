"""The port's host batch stream against the JAX package's: ``is_rated``,
the C++ sampler copy's draws and every field of every BPR batch over two
epochs, bit for bit, on the native path and on the numpy path."""
import numpy as np
import pytest

from coldrec_tpu import native as jnative
from coldrec_tpu.data import sampler as jsampler
from coldrec_tpu.data.synthetic import synthetic_dataset as jsynth
from coldrec_tpu_torch import native as tnative
from coldrec_tpu_torch.data import sampler as tsampler
from coldrec_tpu_torch.data.synthetic import synthetic_dataset as tsynth
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

KW = dict(n_users=70, n_items=80, n_inter=1400, cold_object="item", seed=71)


@pytest.fixture(scope="module")
def datasets():
    jd, _ = jsynth(**KW)
    td, _ = tsynth(**KW)
    return jd, td


def test_is_rated_matches_jax(datasets):
    jd, td = datasets
    rng = np.random.default_rng(0)
    u = rng.integers(0, td.user_num, 5000)
    i = rng.integers(0, td.item_num, 5000)
    # every training pair is rated
    u = np.concatenate([u, td.train_pairs[:, 0]])
    i = np.concatenate([i, td.train_pairs[:, 1]])
    got = td.is_rated(u, i)
    np.testing.assert_array_equal(got, jd.is_rated(u, i))
    assert got[-td.n_train:].all() and not got[:5000].all()


@pytest.mark.parametrize("with_pool", [False, True])
def test_native_draws_match_jax(datasets, with_pool):
    assert jnative.available()
    _, td = datasets
    rng = np.random.default_rng(1)
    users = rng.integers(0, td.n_seen_users, 3000)
    pool = np.arange(0, td.n_seen_items, 3, dtype=np.int64) if with_pool \
        else None
    for seed in (0, 12345, 2**63 - 2):
        args = (td.train_indptr, td.train_items_sorted, users,
                td.n_seen_items, seed)
        got = tnative.sample_negatives_native(*args, pool=pool)
        np.testing.assert_array_equal(
            got, jnative.sample_negatives_native(*args, pool=pool))
        assert not td.is_rated(users, got).any()
        if with_pool:
            assert np.isin(got, pool).all()


def _epochs(batches_fn, rng, n_epochs=2):
    return [b for _ in range(n_epochs) for b in batches_fn(rng)]


def _assert_same_stream(a, b):
    assert len(a) == len(b) > 1
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("bs", [256, 1000])
def test_pairwise_batches_native_match_jax(datasets, bs):
    assert jnative.available()
    jd, td = datasets
    port = _epochs(lambda r: tsampler.pairwise_batches(td, bs, r),
                   np.random.default_rng(5))
    ref = _epochs(lambda r: jsampler.pairwise_batches(jd, bs, r),
                  np.random.default_rng(5))
    _assert_same_stream(port, ref)
    last = port[-1]  # the padded tail of the second epoch
    n_real = td.n_train % bs or bs
    assert last["weight"].sum() == n_real
    assert not td.is_rated(last["user"][:n_real],
                           last["neg_item"][:n_real]).any()


def test_pairwise_batches_numpy_match_jax(datasets, monkeypatch):
    jd, td = datasets
    monkeypatch.setattr(jnative, "available", lambda: False)
    port = _epochs(lambda r: tsampler.pairwise_batches(td, 256, r,
                                                       sampler="numpy"),
                   np.random.default_rng(9))
    ref = _epochs(lambda r: jsampler.pairwise_batches(jd, 256, r),
                  np.random.default_rng(9))
    _assert_same_stream(port, ref)
    native = _epochs(lambda r: tsampler.pairwise_batches(td, 256, r),
                     np.random.default_rng(9))
    assert any((a["neg_item"] != b["neg_item"]).any()
               for a, b in zip(native, port))


@pytest.mark.parametrize("sampler", ["native", "numpy"])
def test_multi_negatives_match_jax(datasets, sampler, monkeypatch):
    jd, td = datasets
    if sampler == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
    users = td.train_pairs[:300, 0]
    got = tsampler.sample_negatives(td, users, np.random.default_rng(2),
                                    n_negs=3, sampler=sampler)
    ref = jsampler.sample_negatives(jd, users, np.random.default_rng(2),
                                    n_negs=3)
    assert got.shape == (300, 3)
    np.testing.assert_array_equal(got, ref)


def test_unknown_sampler_raises(datasets):
    _, td = datasets
    with pytest.raises(ValueError, match="sampler"):
        tsampler.sample_negatives(td, td.train_pairs[:4, 0],
                                  np.random.default_rng(0), sampler="torch")


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A sampler that does not build raises; nothing falls back to numpy."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "compile_command",
                        lambda out: ["false", str(out)])
    tnative.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="host sampler build failed"):
            tsampler.sample_negatives(
                tsynth(**KW)[0], np.zeros(4, np.int64),
                np.random.default_rng(0))
    finally:
        tnative.load_library.cache_clear()
    assert not list(tmp_path.iterdir())


def test_native_rejects_out_of_range_users(datasets):
    _, td = datasets
    with pytest.raises(ValueError, match="user ids"):
        tnative.sample_negatives_native(
            td.train_indptr, td.train_items_sorted,
            np.array([td.user_num]), td.n_seen_items, 0)
