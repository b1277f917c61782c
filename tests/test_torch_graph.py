"""The graph half of the port against the JAX package, on the CPU.

The builder's graph arrays (normalized adjacency, interaction matrix, the
ELL + tail split) are numpy and scipy on both sides, so they are held bit
for bit. The SpMM, the contrastive terms and k-means are float32 sums in
another order: held within ``TOL`` (1e-6; k-means centroids 1e-5 after 20
Lloyd iterations). Every case runs on a split with a COO tail and with
nodes of degree 0 (the cold items).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from coldrec_tpu.data.synthetic import synthetic_dataset as jsynth
from coldrec_tpu.ops import kmeans as jkmeans_mod
from coldrec_tpu.ops import losses as jlosses
from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from coldrec_tpu_torch.ops import losses as tlosses
from coldrec_tpu_torch.ops.kmeans import kmeans
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

jspmm = importlib.import_module("coldrec_tpu.ops.spmm")
tspmm = importlib.import_module("coldrec_tpu_torch.ops.spmm")

TOL = 1e-6
KMEANS_TOL = 1e-5
KW = dict(n_users=160, n_items=220, n_inter=5000, seed=13)


@pytest.fixture(scope="module", params=["item", "user"])
def graphs(request):
    """(JAX dataset, port dataset) of one cold object."""
    return (jsynth(cold_object=request.param, **KW)[0],
            synthetic_dataset(cold_object=request.param, **KW)[0])


def _x(n, d=16, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, d)).astype(np.float32)


def test_graph_arrays_bit_identical(graphs):
    jd, td = graphs
    a, b = jd.norm_adj, td.norm_adj
    assert a.shape == b.shape and b.nnz == a.nnz > 0
    for f in ("rows", "cols", "vals"):
        ja, ta = getattr(a, f), getattr(b, f)
        assert ja.dtype == ta.dtype and np.array_equal(ja, ta), f
    for name in ("interaction_csr",):
        ja, ta = getattr(jd, name), getattr(td, name)
        assert (ja != ta).nnz == 0 and ja.shape == ta.shape
    for self_conn in (False, True):
        ja = jd.bipartite_adjacency(self_conn)
        ta = td.bipartite_adjacency(self_conn)
        assert (ja != ta).nnz == 0
        nj, nt = jd.normalize_graph(ja), td.normalize_graph(ta)
        assert np.array_equal(nj.toarray(), nt.toarray())
    # the row form D^-1 A of a rectangular matrix, rows of degree 0 at 0
    rj = jd.normalize_graph(jd.interaction_csr)
    rt = td.normalize_graph(td.interaction_csr)
    assert np.array_equal(rj.toarray(), rt.toarray())
    deg = np.bincount(b.rows, minlength=b.shape[0])
    assert (deg == 0).any()


def test_build_ell_bit_identical_with_a_tail(graphs):
    jd, td = graphs
    je = jspmm.build_ell(jd.norm_adj)
    te = tspmm.build_ell(td.norm_adj, device="cpu")
    assert te.ell_cols.shape == tuple(je.ell_cols.shape)
    assert te.tail_rows.shape[0] > 0 and te.n_rows == je.n_rows
    for f in ("ell_cols", "ell_vals", "tail_rows", "tail_cols", "tail_vals"):
        assert np.array_equal(np.asarray(getattr(je, f)),
                              getattr(te, f).numpy()), f


@pytest.mark.parametrize("form", ["ell", "coo", "operator"])
def test_spmm_matches_jax_and_scipy(graphs, form):
    jd, td = graphs
    host = td.norm_adj
    x = _x(host.shape[0])
    ref = tspmm.spmm_ref(host, x)
    want = np.asarray(jspmm.spmm(jspmm.build_ell(jd.norm_adj), jnp.asarray(x)))
    if form == "coo":
        got = tspmm.spmm(tspmm.SparseGraph.from_host(host, "cpu"),
                         torch.tensor(x))
    elif form == "operator":
        got = tspmm.spmm(tspmm.make_sym_spmm(host, device="cpu"),
                         torch.tensor(x))
    else:
        got = tspmm.ell_apply(tspmm.build_ell(host, device="cpu"),
                              torch.tensor(x))
    got = got.numpy()
    np.testing.assert_allclose(got, ref, atol=TOL)
    np.testing.assert_allclose(got, want, atol=TOL)
    deg = np.bincount(host.rows, minlength=host.shape[0])
    assert not got[deg == 0].any()


def test_sym_spmm_backward_is_the_apply_of_the_gradient(graphs):
    _, td = graphs
    host = td.norm_adj
    op = tspmm.make_sym_spmm(host, device="cpu")
    x = torch.tensor(_x(host.shape[0]), requires_grad=True)
    g = torch.tensor(_x(host.shape[0], seed=1))
    (op(x) * g).sum().backward()
    assert torch.equal(x.grad, tspmm.ell_apply(op.graph, g))
    dense = torch.tensor(sp.coo_matrix((host.vals, (host.rows, host.cols)),
                                       shape=host.shape).toarray())
    xd = x.detach().clone().requires_grad_(True)
    ((dense @ xd) * g).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), xd.grad.numpy(), atol=TOL)


def test_sym_spmm_saves_nothing_of_the_gather():
    """The backward re-applies A: autograd saves no (N, K, d) gather."""
    td = synthetic_dataset(cold_object="item", **KW)[0]
    op = tspmm.make_sym_spmm(td.norm_adj, device="cpu")
    saved = []
    x = torch.tensor(_x(td.norm_adj.shape[0]), requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        y = op(op(x))
    assert saved == [] and y.requires_grad


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normalize_matches_jax(seed):
    x = _x(40, 12, seed)
    x[3] = 0.0
    x[7] = 1e-14
    got = tlosses._normalize(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlosses._normalize(
        jnp.asarray(x))), atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_unique_padded_matches_jax(seed):
    """Duplicates and pad rows (weight 0): the same ascending uniques, pad
    entries id 0 with mask 0, as jnp.unique(size=bs) + mask."""
    rng = np.random.default_rng(seed)
    bs, sentinel = 64, 50
    ids = rng.integers(0, 30 if seed % 2 else sentinel, bs).astype(np.int64)
    w = np.ones(bs, np.float32)
    w[bs - int(rng.integers(1, 20)):] = 0.0
    ju, jm = jlosses.unique_padded(jnp.asarray(ids), jnp.asarray(w), bs,
                                   sentinel)
    tu, tm = tlosses.unique_padded(torch.tensor(ids), torch.tensor(w), bs,
                                   sentinel)
    assert np.array_equal(tu.numpy(), np.asarray(ju))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert tu.shape == (bs,) and tm.dtype == torch.float32
    real = np.unique(ids[w > 0])
    assert np.array_equal(tu.numpy()[tm.numpy() > 0], real)


@pytest.mark.parametrize("seed", [0, 1])
def test_info_nce_masked_matches_jax(seed):
    rng = np.random.default_rng(seed)
    v1, v2 = _x(48, 16, seed), _x(48, 16, seed + 5)
    valid = (rng.random(48) < 0.7).astype(np.float32)
    want, jgrad = jax.value_and_grad(
        lambda a: jlosses.info_nce_masked(a, jnp.asarray(v2),
                                          jnp.asarray(valid), 0.2))(
        jnp.asarray(v1))
    a = torch.tensor(v1, requires_grad=True)
    got = tlosses.info_nce_masked(a, torch.tensor(v2), torch.tensor(valid),
                                  0.2)
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jgrad), atol=TOL)
    # the order of the unique rows does not matter
    perm = rng.permutation(48)
    again = tlosses.info_nce_masked(torch.tensor(v1[perm]),
                                    torch.tensor(v2[perm]),
                                    torch.tensor(valid[perm]), 0.2)
    assert abs(float(again) - float(want)) <= TOL * abs(float(want))


@pytest.mark.parametrize("n,k,seed", [(300, 20, 0), (500, 7, 1),
                                      (64, 64, 2)])
def test_kmeans_matches_jax_from_its_initial_draw(n, k, seed):
    x = _x(n, 16, seed)
    key = jax.random.PRNGKey(seed)
    init = np.asarray(jax.random.choice(key, n, shape=(k,), replace=False))
    jc, ja = jkmeans_mod.kmeans(key, jnp.asarray(x), k)
    tc, ta = kmeans(torch.tensor(x), k, init_idx=init)
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=KMEANS_TOL)


def test_kmeans_draw_and_empty_cluster():
    """A drawn start has k distinct rows; a cluster that loses every point
    keeps its centroid."""
    x = torch.tensor(_x(200, 8, 4))
    gen = torch.Generator().manual_seed(0)
    c, a = kmeans(x, 10, generator=gen)
    assert c.shape == (10, 8) and a.shape == (200,) and int(a.max()) < 10
    again = kmeans(x, 10, generator=torch.Generator().manual_seed(0))
    assert torch.equal(c, again[0])
    # two equal rows as the start: the first wins every point (argmax
    # keeps the first of equal scores), the second keeps its centroid
    pts = torch.tensor([[0.0, 0.0], [0.0, 0.0], [4.0, 4.0], [5.0, 5.0]])
    c, _ = kmeans(pts, 2, n_iters=1, init_idx=[0, 1])
    assert torch.equal(c[1], pts[1])
    assert torch.equal(c[0], pts.mean(dim=0))
