"""Port eval layer vs the JAX package: ``masked_topk`` and
``_hierarchical_topk`` id-exact (lowest-index tie rule included), the
heavy-rated scatter branch, item spaces wider than 32,768, and the chunked
``EvalSweep.run``.

Integer-valued embeddings keep every fp32 score exact in both frameworks, so
ties are real ties and the comparison can demand equal ids."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coldrec_tpu.runtime import eval as jeval
from coldrec_tpu_torch.runtime import eval as teval
from test_torch_threads import torch_threads  # noqa: F401  (autouse)


def _int_scores(rng, b, n_items, d=8, lo=-3, hi=4):
    ue = rng.integers(lo, hi, (b, d)).astype(np.float32)
    ie = rng.integers(lo, hi, (n_items, d)).astype(np.float32)
    return ue @ ie.T  # exact: small integers


def _rated(rng, b, r, n_items, fill=None):
    rated = np.full((b, r), n_items, np.int32)
    for u in range(b):
        c = int(rng.integers(0, r + 1)) if fill is None else fill
        rated[u, :c] = rng.choice(n_items, c, replace=False)
    return rated


def _both(scores, rated, excluded, k):
    jv, ji = jeval.masked_topk(jnp.asarray(scores), jnp.asarray(rated),
                               jnp.asarray(excluded), k)
    tv, ti = teval.masked_topk(torch.as_tensor(scores),
                               torch.as_tensor(rated),
                               torch.as_tensor(excluded), k)
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


@pytest.mark.parametrize("n_items", [40, 300, 5000, 40000])
def test_masked_topk_id_exact_with_ties(rng, n_items):
    b, k = 12, 20
    scores = _int_scores(rng, b, n_items)
    rated = _rated(rng, b, 16, n_items)
    excluded = np.zeros(n_items, bool)
    excluded[rng.choice(n_items, n_items // 5, replace=False)] = True
    (jv, ji), (tv, ti) = _both(scores, rated, excluded, k)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)


def test_masked_topk_heavy_rated_branch_id_exact(rng):
    """(k+R)*R > I: both packages take the scattered (B, I+1) mask plane."""
    b, n_items, k, r = 6, 1000, 20, 200
    assert (k + r) * r > n_items
    scores = _int_scores(rng, b, n_items)
    rated = _rated(rng, b, r, n_items)
    excluded = np.zeros(n_items, bool)
    excluded[rng.choice(n_items, 100, replace=False)] = True
    (jv, ji), (tv, ti) = _both(scores, rated, excluded, k)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    for i in range(b):
        assert not set(ti[i]) & set(rated[i][rated[i] < n_items].tolist())


def test_masked_topk_fewer_valid_items_than_k(rng):
    """Rows with fewer than k valid items rank masked items by the same
    rule in both packages."""
    n_items, k = 30, 20
    scores = _int_scores(rng, 5, n_items)
    rated = _rated(rng, 5, 8, n_items, fill=8)
    excluded = np.zeros(n_items, bool)
    excluded[:15] = True
    (jv, ji), (tv, ti) = _both(scores, rated, excluded, k)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)


def test_hierarchical_topk_matches_jax_wide(rng):
    """40,000 items: the JAX two-stage path and the port's one-pass top-k
    give the same ids, ties included, and the same as a flat top_k."""
    b, n_items, k = 8, 40000, 20
    scores = _int_scores(rng, b, n_items, d=4, lo=-2, hi=3)
    jv, ji = jeval._hierarchical_topk(jnp.asarray(scores), k)
    tv, ti = teval._hierarchical_topk(torch.as_tensor(scores), k)
    fv, fi = jax.lax.top_k(jnp.asarray(scores), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(fi))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(fv))


def test_hierarchical_matches_flat_random(rng):
    b, n_items, k = 8, 40000, 20
    scores = rng.standard_normal((b, n_items)).astype(np.float32)
    tv, ti = teval._hierarchical_topk(torch.as_tensor(scores), k)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(ti.numpy(), order)
    np.testing.assert_array_equal(
        tv.numpy(), np.take_along_axis(scores, order, axis=1))


@pytest.mark.parametrize("k", [1, 5, 33])
def test_stable_topk_all_ties_lowest_index_first(k):
    x = torch.zeros((3, 64))
    x[1, 10] = 1.0
    v, i = teval.stable_topk(x, k)
    np.testing.assert_array_equal(i[0].numpy(), np.arange(k))
    assert int(i[1, 0]) == 10
    np.testing.assert_array_equal(
        i[1, 1:].numpy(), [j for j in range(64) if j != 10][: k - 1])
    assert v.shape == (3, k)


@pytest.mark.parametrize("k", [1, 7, 30, 63, 64])
def test_stable_topk_integer_ties_match_stable_sort(rng, k):
    """Ties crossing the cut in most rows (integer values), a row of -inf:
    ids and values as a stable descending sort's."""
    x = rng.integers(-3, 4, (40, 64)).astype(np.float32)
    x[4, :] = -np.inf
    x[5, 7:] = -np.inf
    v, i = teval.stable_topk(torch.as_tensor(x), k)
    order = np.argsort(-x, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(i.numpy(), order)
    np.testing.assert_array_equal(v.numpy(), np.take_along_axis(x, order, 1))


def test_mask_bias_vector_identical():
    for mask in (None, np.array([], np.int32), np.array([0, 5, 7])):
        np.testing.assert_array_equal(jeval.mask_bias_vector(10, mask),
                                      teval.mask_bias_vector(10, mask))


def test_eval_sweep_run_matches_jax():
    from coldrec_tpu.data.synthetic import synthetic_dataset as jsynth
    from coldrec_tpu_torch.data.synthetic import synthetic_dataset as tsynth

    kw = dict(n_users=90, n_items=150, n_inter=2500, cold_object="item",
              seed=8)
    jd, _ = jsynth(**kw)
    td, _ = tsynth(**kw)
    rng = np.random.default_rng(1)
    ue = rng.integers(-3, 4, (jd.user_num, 8)).astype(np.float32)
    ie = rng.integers(-3, 4, (jd.item_num, 8)).astype(np.float32)
    js = jeval.EvalSweep(jd, "item", 32, 20)
    ts = teval.EvalSweep(td, "item", 32, 20, device="cpu")
    for split, data_type in (("overall_test", "all"), ("cold_test", "cold"),
                             ("warm_val", "warm")):
        jr = js.run(split, data_type,
                    lambda u: jnp.asarray(ue[u]) @ jnp.asarray(ie).T)
        tr = ts.run(split, data_type,
                    lambda u: teval.exact_scores(torch.as_tensor(ue[u]),
                                                 torch.as_tensor(ie)))
        np.testing.assert_array_equal(tr, jr)
        assert ts._prepare(split, data_type)["rated_widths"] == \
            js._prepare(split, data_type)["rated_widths"]
