"""Content KNN and the content models' samplers of the port against the JAX
package, on the CPU.

``knn_inner_product`` / ``knn_cosine`` against the JAX package's: on
integer tables (exact products) the ids and the scores bit for bit, on
N(0,1) tables the ids equal and the scores within 1e-5 of their scale;
all-zero query rows (every score ties: lowest ids first), ``k + 1 > V``
and value sets below the kernel route's 512 rows. Both routes of the port
compute the function: the plain route, and the kernel route, whose sweep
is here the kernel's plain version (``fused_sweep_reference``). On the CPU
the entry point always takes the plain route; the route rule and its
event are held too. Then the LARA and CLCRec samplers, bit for bit with
the JAX package's over two epochs, with the native sampler and with
numpy's.
"""
import json

import numpy as np
import pytest

from coldrec_tpu import native as jnative
from coldrec_tpu.data import sampler as jsampler
from coldrec_tpu.data.synthetic import synthetic_dataset as jsynth
from coldrec_tpu.ops import knn as jknn
from coldrec_tpu_torch.data import sampler as tsampler
from coldrec_tpu_torch.data.synthetic import synthetic_dataset as tsynth
from coldrec_tpu_torch.ops import knn as tknn
from coldrec_tpu_torch.ops.cuda import retrieval as tret
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

RTOL = 1e-5
ROUTES = {"kernel": tknn.knn_via_kernel, "plain": tknn.knn_plain}
# (queries, values, d, k): the kernel route's shapes (V >= 512), k + 1 > V,
# and V below 512
SHAPES = [(300, 900, 24, 5), (120, 600, 12, 11), (40, 5, 8, 5),
          (60, 200, 16, 10)]


def tables(q, v, d, integer, seed=0):
    rng = np.random.default_rng(seed)
    if integer:
        queries = rng.integers(-3, 4, (q, d)).astype(np.float32)
        values = rng.integers(-3, 4, (v, d)).astype(np.float32)
    else:
        queries = rng.standard_normal((q, d), dtype=np.float32)
        values = rng.standard_normal((v, d), dtype=np.float32)
    queries[:3] = 0.0  # all-tie rows
    return queries, values


# the kernel route sweeps at least k + 1 values
@pytest.mark.parametrize("route,shape", [
    (r, s) for r in sorted(ROUTES) for s in SHAPES
    if r == "plain" or s[3] + 1 <= s[1]],
    ids=lambda x: x if isinstance(x, str) else "x".join(map(str, x)))
@pytest.mark.parametrize("integer", [True, False], ids=["int", "normal"])
def test_knn_inner_product_matches_jax(route, shape, integer):
    q, v, d, k = shape
    queries, values = tables(q, v, d, integer)
    js, ji = (np.asarray(x) for x in jknn.knn_inner_product(queries, values,
                                                            k))
    s, i = ROUTES[route](queries, values, k, chunk=64, device="cpu")
    assert s.dtype == np.float32 and i.shape == (q, k)
    np.testing.assert_array_equal(i, ji)
    if integer:
        np.testing.assert_array_equal(s, js)
    else:
        np.testing.assert_allclose(s, js, rtol=0,
                                   atol=RTOL * np.abs(js).max())
    # the all-zero rows: every value ties at 0, lowest ids first
    np.testing.assert_array_equal(i[:3], np.tile(np.arange(k), (3, 1)))


@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: "x".join(
    map(str, s)))
def test_knn_cosine_matches_jax(shape):
    q, v, d, k = shape
    queries, values = tables(q, v, d, False, seed=1)
    js, ji = jknn.knn_cosine(queries, values, k)
    for route in ROUTES.values():
        qn = queries / np.maximum(
            np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
        vn = values / np.maximum(
            np.linalg.norm(values, axis=1, keepdims=True), 1e-12)
        s, i = route(qn, vn, k, chunk=64, device="cpu")
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_allclose(s, np.asarray(js), rtol=0, atol=RTOL)
    s, i = tknn.knn_cosine(queries, values, k, device="cpu")
    np.testing.assert_array_equal(i, np.asarray(ji))


def test_kernel_route_pads_the_values_once(monkeypatch):
    """One ``pad_items`` per call, however many query chunks; every chunk's
    sweep takes the same prepared operands, and all-tie rows take the
    exact fallback."""
    calls, sweeps = [], []
    pad, sweep = tknn.pad_items, tknn.sweep_topk
    monkeypatch.setattr(tknn, "pad_items",
                        lambda *a: calls.append(1) or pad(*a))

    def counting(ue, ie, items_t, *rest):
        sweeps.append(items_t.data_ptr())
        return sweep(ue, ie, items_t, *rest)

    monkeypatch.setattr(tknn, "sweep_topk", counting)
    queries, values = tables(300, 900, 16, True)
    before = tret.apply_exact_fallback.rows
    s, i = tknn.knn_via_kernel(queries, values, 5, chunk=64, device="cpu")
    assert len(calls) == 1 and len(sweeps) == 5 and len(set(sweeps)) == 1
    assert tret.apply_exact_fallback.rows - before >= 3
    want = tknn.knn_plain(queries, values, 5, device="cpu")
    np.testing.assert_array_equal(i, want[1])
    np.testing.assert_array_equal(s, want[0])


def test_route_rule_and_event(tmp_path, monkeypatch):
    """The JAX package's size rule (V >= 512, k + 1 <= 1024) on the card,
    the plain route on the CPU, one ``knn_route`` event per call."""
    assert tknn.knn_route(512, 5, "cpu") == "plain"
    if not tknn.torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tknn.knn_route(512, 5, "cuda")
    monkeypatch.setattr(tknn, "resolve_device",
                        lambda d: tknn.torch.device("cuda"))
    assert tknn.knn_route(512, 5, "cuda") == "kernel"
    assert tknn.knn_route(511, 5, "cuda") == "plain"
    assert tknn.knn_route(4096, 1023, "cuda") == "kernel"
    assert tknn.knn_route(4096, 1024, "cuda") == "plain"
    monkeypatch.undo()
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("COLDREC_EVENT_LOG", str(log))
    queries, values = tables(10, 600, 8, False)
    tknn.knn_inner_product(queries, values, 3, device="cpu")
    from coldrec_tpu_torch.utils.logging import event_log

    event_log().close()
    evs = [json.loads(x) for x in log.read_text().splitlines()]
    assert [e for e in evs if e["event"] == "knn_route"] == [
        {**evs[0], "event": "knn_route", "route": "plain", "queries": 10,
         "values": 600, "d": 8, "k": 3}]


def test_entry_points_default_to_the_card():
    if tknn.torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would run on it")
    queries, values = tables(4, 600, 8, False)
    for fn in (tknn.knn_inner_product, tknn.knn_cosine, tknn.knn_plain,
               tknn.knn_via_kernel):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(queries, values, 3)


# ------------------------------------------------------------- samplers
KW = dict(n_users=70, n_items=80, n_inter=1400, cold_object="item", seed=71)


@pytest.fixture(scope="module")
def datasets():
    return jsynth(**KW)[0], tsynth(**KW)[0]


def _epochs(batches_fn, rng, n_epochs=2):
    return [b for _ in range(n_epochs) for b in batches_fn(rng)]


def _assert_same_stream(a, b):
    assert len(a) == len(b) > 1
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_warm_item_pool_matches_jax(datasets):
    jd, td = datasets
    pool = tsampler.warm_item_pool(td)
    np.testing.assert_array_equal(pool, jsampler.warm_item_pool(jd))
    assert not np.isin(pool, td.mapped_cold_item_idx).any()


@pytest.mark.parametrize("sampler", ["native", "numpy"])
@pytest.mark.parametrize("kind", ["neg_users", "multi_neg"])
def test_content_samplers_match_jax(datasets, sampler, kind, monkeypatch):
    """LARA's (negative user and item) and CLCRec's (n negatives from the
    warm pool) batch streams, bit for bit."""
    jd, td = datasets
    if sampler == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
    else:
        assert jnative.available()
    pool = tsampler.warm_item_pool(td)
    if kind == "neg_users":
        port = _epochs(lambda r: tsampler.pairwise_batches_with_neg_users(
            td, 256, r, sampler=sampler), np.random.default_rng(5))
        ref = _epochs(lambda r: jsampler.pairwise_batches_with_neg_users(
            jd, 256, r), np.random.default_rng(5))
    else:
        port = _epochs(lambda r: tsampler.pairwise_batches_multi_neg(
            td, 256, r, 6, pool, sampler=sampler), np.random.default_rng(5))
        ref = _epochs(lambda r: jsampler.pairwise_batches_multi_neg(
            jd, 256, r, 6, pool), np.random.default_rng(5))
    _assert_same_stream(port, ref)
    n_real = td.n_train % 256 or 256
    last = port[-1]
    assert last["weight"].sum() == n_real
    users, items = last["user"][:n_real], last["pos_item"][:n_real]
    if kind == "neg_users":
        assert not td.is_rated(last["neg_user"][:n_real], items).any()
        assert not td.is_rated(users, last["neg_item"][:n_real]).any()
    else:
        negs = last["neg_items"][:n_real]
        assert negs.shape == (n_real, 6) and np.isin(negs, pool).all()
        assert not td.is_rated(np.repeat(users, 6), negs.ravel()).any()
