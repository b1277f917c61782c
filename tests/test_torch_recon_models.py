"""The reconstruction-family cold models of the port (CCFCRec, M2VAE, CGRC,
FSGNN) and their host code against the JAX package, on the CPU.

Each model case builds the JAX trainer and the port's from the same numpy
data (200 users x 150 items, 16 content columns, d = 16) and the same bus
(random MF tables), carries the JAX ``params`` (and M2VAE's BatchNorm
state) across with ``init_params`` / ``init_state``, and feeds both the
same numpy batch. The loss's draws are the JAX package's, handed to the
port: M2VAE's four normals, CGRC's simulated cold items, sampled edges and
extra items, FSGNN's dropout mask and structure-loss edges. The eval
tables, the loss and every gradient agree within ``RTOL`` (1e-5) of each
tensor's largest magnitude. The host code is held exactly: the CCFCRec
batch stream (both samplers), the PPR extra edges (dense power iteration
and native push), the cosine-KNN graphs and CGRC's top-k users.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from coldrec_tpu import native as jnative
from coldrec_tpu.config import default_args as jargs
from coldrec_tpu.data import sampler as jsampler
from coldrec_tpu.data.synthetic import synthetic_dataset as jsynth
from coldrec_tpu.models import cgrc as jcgrc
from coldrec_tpu.models import fsgnn as jfsgnn
from coldrec_tpu.models import model_factory as jfactory
from coldrec_tpu.runtime.checkpoints import save_embeddings as jsave
from coldrec_tpu.runtime.trainer import Config as JConfig
from coldrec_tpu_torch.config import default_args
from coldrec_tpu_torch.data import sampler as tsampler
from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from coldrec_tpu_torch.models import TRAINERS, model_factory
from coldrec_tpu_torch.models import cgrc as tcgrc
from coldrec_tpu_torch.models import fsgnn as tfsgnn
from coldrec_tpu_torch.runtime.trainer import Config
from coldrec_tpu_torch.models.common import jax_value
from test_torch_content_models import (
    RTOL, assert_close, assert_slots, port_value, to_numpy,
)
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

D = 16
MODELS = ("CCFCRec", "M2VAE", "CGRC", "FSGNN")
ITEM_ONLY = ("CCFCRec", "M2VAE", "CGRC")
CASES = [(m, "item") for m in MODELS] + [("FSGNN", "user")]
KW = dict(n_users=200, n_items=150, n_inter=3000, content_dim=16, seed=31)
# narrow widths for the CPU
SMALL = dict(positive_number=3, negative_number=5, self_neg_number=4,
             attr_present_dim=D, implicit_dim=D, cat_implicit_dim=D,
             cgrc_mlp_hidden=8, cgrc_le_max_edges=64,
             cgrc_ranking_neg_per_user=4, cgrc_recon_topk=5,
             fsgnn_gat_hidden=8, fsgnn_knn_k=4, fsgnn_ppr_topk=3,
             fsgnn_sc_max_edges=64, fsgnn_fallback_dim=8)
COMMON = dict(dataset="synth", bs=256, emb_size=D, seed=5, save_emb=False,
              early_stop=10)


def small_flags(model):
    """The model's own flags of SMALL (the others would be refused)."""
    own = default_args(model=model).__dict__
    return {k: v for k, v in SMALL.items() if k in own}


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    """Per cold object: the JAX and port datasets (equal, bit for bit) and
    an emb dir holding random MF tables."""
    out = {}
    for obj in ("item", "user"):
        jd = jsynth(cold_object=obj, **KW)[0]
        td = synthetic_dataset(cold_object=obj, **KW)[0]
        emb_dir = str(tmp_path_factory.mktemp(f"emb_{obj}"))
        rng = np.random.default_rng(7)
        jsave(emb_dir, "synth", obj, "MF", {
            "user_emb": rng.standard_normal((jd.user_num, D)).astype(
                np.float32) * 0.3,
            "item_emb": rng.standard_normal((jd.item_num, D)).astype(
                np.float32) * 0.3})
        out[obj] = (jd, td, emb_dir)
    return out


def flags_of(envs, model, obj, **kw):
    return {**COMMON, **small_flags(model), "model": model,
            "cold_object": obj, "emb_dir": envs[obj][2], **kw}


def make_pair(envs, model, obj, **kw):
    """(JAX trainer, port trainer) from the same data and bus, the port's
    weights (and M2VAE's statistics) carried from the JAX trainer's."""
    jd, td, _ = envs[obj]
    flags = flags_of(envs, model, obj, **kw)
    jm = jfactory(JConfig(jargs(**flags), jd))
    extra = {}
    if model == "M2VAE":
        extra["init_state"] = {k: v for k, v in to_numpy(jm.net_state).items()
                               if k != "eval_key"}
    tm = TRAINERS[model](Config(default_args(**flags, device="cpu"), td),
                         init_params=to_numpy(jm.params), **extra)
    return jm, tm


def first_batch(tm, seed=3):
    """The first batch of the trainer's own stream from a fresh seed."""
    tm.host_rng = np.random.default_rng(seed)
    return next(iter(tm.batches()))


def jax_draws(jm, tm, n, key):
    """The port's ``draws`` of the JAX loss's ``key`` for a batch of ``n``
    rows."""
    name = tm.model_name
    if name == "M2VAE":
        keys = jax.random.split(key, 4)
        return {k: torch.tensor(np.asarray(jax.random.normal(kk, (n, tm.d))))
                for k, kk in zip(("z_a", "z_c", "z_p", "z"), keys)}
    if name == "CGRC":
        k1, k2, k3 = jax.random.split(key, 3)
        n_i = jm.data.item_num
        cold = (jax.random.uniform(k1, (n_i,)) < jm.rho) & jm._eligible
        edges = jax.random.randint(k2, (jm.le_max,), 0,
                                   jm.data.train_pairs.shape[0])
        extra = jax.random.randint(k3, (jm.ranking_neg * 8,), 0, n_i)
        return {k: torch.tensor(np.asarray(v)) for k, v in (
            ("cold_mask", cold), ("edges", edges), ("extra", extra))}
    if name == "FSGNN":
        k1, k2 = jax.random.split(key)
        ku, ki = jax.random.split(k1)
        keep = 1.0 - float(jm.args.fsgnn_p_drop)
        out = {}
        if jm.args.cold_object == "item":
            out["keep_i"] = jax.random.bernoulli(
                ki, keep, (jm.data.item_num, D))
        else:
            out["keep_u"] = jax.random.bernoulli(
                ku, keep, (jm.data.user_num, D))
        kuu, kii = jax.random.split(k2)
        for tag, kk, (rows, _) in (("uu", kuu, jm._bus["uu_edges"]),
                                   ("ii", kii, jm._bus["ii_edges"])):
            m = rows.shape[0]
            if m:
                out[f"sel_{tag}"] = jax.random.randint(
                    kk, (min(m, int(jm.args.fsgnn_sc_max_edges)),), 0, m)
        return {k: torch.tensor(np.asarray(v)) for k, v in out.items()}
    return None


# Weights whose exact gradient is 0, where both packages return float32
# noise: attr_b1 adds one constant to every attribute's attention logit,
# which the softmax over the attributes cancels; a Linear bias right ahead
# of a BatchNorm is cancelled by its mean; CGRC's last edge-MLP bias enters
# an edge's positive logit and its logsumexp alike. Each is held to be
# noise on both sides (within RTOL of the gradient named beside it), not
# equal.
ZERO_GRADIENT = {
    ("params", "attr_b1"): ("params", "attr_matrix"),
    ("params", "edge_mlp", 1, "b"): ("params", "edge_mlp", 1, "w"),
    **{("params", blk, "lin", "b"): ("params", blk, "lin", "w")
       for blk in ("fc2", "fc3", "decoder")},
}


def assert_gradients(tm, jgrads):
    tree = {"params": to_numpy(jgrads)}
    slots = {path: (t, tr) for path, t, tr in tm.model.jax_slots()
             if path[0] == "params"}
    for path, (tensor, transposed) in slots.items():
        got = port_value(tensor, transposed, grad=True)
        want = jax_value(tree, path)
        if path in ZERO_GRADIENT:
            scale = np.abs(jax_value(tree, ZERO_GRADIENT[path])).max()
            assert np.abs(got).max() <= RTOL * scale, path
            assert np.abs(want).max() <= RTOL * scale, path
        else:
            assert_close(got, want, "/".join(map(str, path)))


def jax_loss(jm, batch, key):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if jm.model_name == "FSGNN":
        jb["bus"] = jm._bus
    if jm.stateful:
        return lambda p: jm.loss_fn(p, jm.net_state, jb, key)
    return lambda p: jm.loss_fn(p, jb, key)


def jax_tables(jm):
    state = getattr(jm, "net_state", None)
    return jm.forward_tables(jm.params, *(() if state is None else (state,)))


def port_tables(jm, tm):
    """The port's eval tables; M2VAE's cold rows with the JAX eval draw."""
    if tm.model_name == "M2VAE":
        normal = np.asarray(jax.random.normal(
            jm.net_state["eval_key"], (tm.cold_idx.shape[0], tm.d)))
        tm.eval_normal = lambda n: torch.tensor(normal)
        tm.refresh_tables()
    return tm.user_emb, tm.item_emb


@pytest.mark.parametrize("model,obj", CASES)
def test_tables_loss_and_gradients_match_jax(envs, model, obj):
    """The eval tables of the carried weights, then one batch: the loss,
    every gradient and (M2VAE) the running statistics after it."""
    jm, tm = make_pair(envs, model, obj)
    for got, want, side in zip(port_tables(jm, tm), jax_tables(jm), "ui"):
        assert_close(got.numpy(), want, f"{side} table")
    batch = first_batch(tm)
    key = jax.random.PRNGKey(11)
    if jm.stateful:
        (jloss, jstate), jgrads = jax.value_and_grad(
            jax_loss(jm, batch, key), has_aux=True)(jm.params)
    else:
        (jloss, jgrads), jstate = jax.value_and_grad(
            jax_loss(jm, batch, key))(jm.params), None
    draws = jax_draws(jm, tm, len(batch["user"]), key)
    tm.model.zero_grad()
    loss = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                   **({} if draws is None else {"draws": draws}))
    loss.backward()
    assert_close(loss.item(), float(jloss), "loss")
    assert_gradients(tm, jgrads)
    if jstate is not None:
        assert_slots(tm, {"state": to_numpy(jstate)}, kinds=("state",))


@pytest.mark.parametrize("model", ITEM_ONLY)
def test_item_cold_only_models_raise_under_user_cold(envs, model):
    jd, td, _ = envs["user"]
    flags = flags_of(envs, model, "user")
    with pytest.raises(ValueError, match="item cold-start"):
        model_factory(Config(default_args(**flags, device="cpu"), td))
    with pytest.raises(ValueError, match="item cold-start"):
        jfactory(JConfig(jargs(**flags), jd))


@pytest.mark.parametrize("sampler", ["native", "numpy"])
@pytest.mark.parametrize("model", ["CCFCRec", "M2VAE"])
def test_ccfcrec_batches_match_jax(envs, sampler, model, monkeypatch):
    """The CCFCRec / M2VAE batch stream over two epochs, bit for bit with
    the JAX package's, on the native sampler and on the numpy path."""
    jd, td, _ = envs["item"]
    if sampler == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
    else:
        assert jnative.available()
    pool = tsampler.warm_item_pool(td)
    p, n, s = 3, 5, (4 if model == "CCFCRec" else 1)

    def stream(fn, data, **kw):
        rng = np.random.default_rng(5)
        return [b for _ in range(2)
                for b in fn(data, 256, rng, p, n, s, pool, **kw)]

    port = stream(tsampler.ccfcrec_batches, td, sampler=sampler)
    ref = stream(jsampler.ccfcrec_batches, jd)
    assert len(port) == len(ref) > 2
    for x, y in zip(port, ref):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    n_real = td.n_train % 256 or 256
    last = port[-1]
    assert last["weight"].sum() == n_real
    users, items = last["user"][:n_real], last["pos_item"][:n_real]
    assert last["neg_grid"].shape == (256, p, n)
    assert not td.is_rated(last["neg_user"][:n_real], items).any()
    negs = last["neg_grid"][:n_real].reshape(n_real, -1)
    assert np.isin(negs, pool).all()
    assert not td.is_rated(np.repeat(users, p * n), negs.ravel()).any()
    assert td.is_rated(np.repeat(users, p),
                       last["pos_grid"][:n_real].ravel()).all()


def _bipartite(nu, ni, density, seed):
    dens = sp.random(nu, ni, density=density, random_state=seed,
                     dtype=np.float32)
    return (dens > 0).astype(np.float32).tocsr()


@pytest.mark.parametrize("route", ["dense", "push"])
@pytest.mark.parametrize("weighted", [True, False])
def test_ppr_extra_edges_match_jax(route, weighted, monkeypatch):
    """The PPR extra edges as one CSR, identical to the JAX package's on
    both paths (the push forced by a zero size rule, as in
    tests/test_native.py)."""
    if route == "push":
        assert jnative.available()
        monkeypatch.setattr(jfsgnn, "_DENSE_PPR_ELEMS", 0)
        monkeypatch.setattr(tfsgnn, "DENSE_PPR_ELEMS", 0)
    r_train = _bipartite(60, 50, 0.08, 7)
    kw = dict(delta=0.15, n_iter=60, topk=5, weighted=weighted)
    if route == "push":
        kw["push_eps"] = 1e-7
    got = tfsgnn.ppr_topk_extra_edges(r_train, **kw)
    want = jfsgnn.ppr_topk_extra_edges(r_train, **kw)
    assert got.nnz > 0 and got.shape == want.shape
    for attr in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, attr),
                                      getattr(want, attr), err_msg=attr)
    assert got.dtype == want.dtype


def test_ppr_push_build_failure_raises(tmp_path, monkeypatch):
    """A push library that does not build raises: nothing falls back to
    the dense power iteration."""
    from coldrec_tpu_torch import native as tnative

    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "compile_command",
                        lambda out: ["false", str(out)])
    monkeypatch.setattr(tfsgnn, "DENSE_PPR_ELEMS", 0)
    tnative.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="host sampler build failed"):
            tfsgnn.ppr_topk_extra_edges(_bipartite(20, 15, 0.2, 1),
                                        delta=0.15, n_iter=10, topk=3,
                                        weighted=True)
    finally:
        tnative.load_library.cache_clear()


@pytest.mark.parametrize("weighted", [True, False])
def test_cosine_knn_graph_matches_jax(weighted):
    """The kNN graph as one CSR, identical to the JAX package's per-row
    loop, with the self rows (a row's own id among its k + 1, or not: a
    zero row ties everywhere, so it lists the lowest ids) and duplicate
    rows. Each row holds four entries of +-1 (norm 2), so the cosines are
    exact and the ties the same in both packages."""
    rng = np.random.default_rng(4)
    feats = np.zeros((70, 8), np.float32)
    for row in feats:
        row[rng.choice(8, 4, replace=False)] = rng.choice([-1.0, 1.0], 4)
    feats[[3, 40]] = 0.0
    feats[11] = feats[12]
    for k in (4, 9):
        got = tfsgnn.cosine_knn_graph(feats, k, weighted, device="cpu")
        want = jfsgnn.cosine_knn_graph(feats, k, weighted)
        assert got.nnz > 0 and got.dtype == want.dtype
        for attr in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(got, attr),
                                          getattr(want, attr), err_msg=attr)
    assert tfsgnn.cosine_knn_graph(feats[:1], 4, weighted,
                                   device="cpu").nnz == 0


def _jax_topk_self(cap):
    """The attributes the JAX package's ``CGRC._topk_users_chunked`` reads
    of its trainer."""
    from types import SimpleNamespace

    return SimpleNamespace(
        args=SimpleNamespace(cgrc_mlp_hidden=8), _DENSE_ELEMS_CAP=cap,
        _edge_parts=lambda p, h, x: jcgrc.CGRC._edge_parts(None, p, h, x))


@pytest.mark.parametrize("n_users", [200, 700])
def test_cgrc_topk_users_match_jax_with_ties(n_users, monkeypatch):
    """CGRC's top-k users per cold item, id for id with the JAX package's
    chunked merge, on integer tables whose edge logits tie often (the
    lowest user id first); the port's dense route under the cap and its
    chunked route (three user chunks at 700 users) give the same ids."""
    rng = np.random.default_rng(8)
    d, h, c, k = 4, 8, 37, 6
    params = {"user_emb": np.zeros((n_users, d), np.float32),
              "item_lin": {"w": np.zeros((3, d), np.float32),
                           "b": np.zeros(d, np.float32)},
              "edge_mlp": [
                  {"w": rng.integers(-2, 3, (2 * d, h)).astype(np.float32),
                   "b": rng.integers(-2, 3, h).astype(np.float32)},
                  {"w": rng.integers(-2, 3, (h, 1)).astype(np.float32),
                   "b": np.ones(1, np.float32)}]}
    h_u = rng.integers(-2, 3, (n_users, d)).astype(np.float32)
    x_cold = rng.integers(-2, 3, (c, d)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want = jcgrc.CGRC._topk_users_chunked(_jax_topk_self(1 << 10), jp,
                                          jnp.asarray(h_u),
                                          jnp.asarray(x_cold), k)
    module = tcgrc.CGRC.from_jax_params(params, device="cpu")
    dense = module.topk_users(torch.from_numpy(h_u),
                              torch.from_numpy(x_cold), k)
    monkeypatch.setattr(tcgrc, "DENSE_ELEMS_CAP", 1 << 10)
    chunked = module.topk_users(torch.from_numpy(h_u),
                                torch.from_numpy(x_cold), k)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(want))
    np.testing.assert_array_equal(chunked.numpy(), np.asarray(want))
    hu, xi = module.edge_parts(torch.from_numpy(h_u),
                               torch.from_numpy(x_cold))
    b1, w2, b2 = module.mlp_tail()
    logits = tcgrc.block_logits(xi + b1, hu, w2, b2).detach()
    kth = logits.sort(dim=1, descending=True)[0][:, k - 1: k]
    assert int(((logits == kth).sum(dim=1) > 1).sum()) > c // 2  # ties


def test_cgrc_blocked_softmax_matches_jax_scan(envs, monkeypatch):
    """L_E's logsumexp in many blocks of items (a small element budget)
    against the JAX package's running lax.scan at its own small budget:
    the loss and every gradient within RTOL."""
    monkeypatch.setattr(tcgrc, "DENSE_ELEMS_CAP", 256)
    monkeypatch.setattr(jcgrc.CGRC, "_DENSE_ELEMS_CAP", 256)
    jm, tm = make_pair(envs, "CGRC", "item")
    batch = first_batch(tm)
    key = jax.random.PRNGKey(13)
    jloss, jgrads = jax.value_and_grad(jax_loss(jm, batch, key))(jm.params)
    tm.model.zero_grad()
    draws = jax_draws(jm, tm, len(batch["user"]), key)
    loss = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                   draws=draws)
    loss.backward()
    assert_close(loss.item(), float(jloss), "loss")
    assert_gradients(tm, jgrads)
