"""The content-feature cold models of the port (KNN, AGNN, VBPR, AMR, MTPR,
MetaEmbedding, LARA, CLCRec, GoRec) against the JAX package, on the CPU.

Each case builds the JAX trainer and the port's from the same numpy data
(200 users x 150 items, 16 content columns, d = 16) and the same bus
(random MF tables, and random VBPR tensors for AMR), carries the JAX
``params`` (and GoRec's BatchNorm state) across with ``init_params`` /
``init_state``, and feeds both the same numpy batch. The loss's draws are
the JAX package's, handed to the port: AGNN's four dropout masks and VAE
normal, GoRec's two normals and content dropout, CLCRec's ``rand_index``
(with repeated rows) and GoRec's k-means start rows. The eval tables, the
loss and every gradient agree within ``RTOL`` (1e-5) of each tensor's
largest magnitude: float32 sums in another order. MetaEmbedding's
gradients hold only through the second-order inner step. The models
whose loss draws nothing also train 3 epochs through both trainers from
shared weights (``test_torch_content_train.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coldrec_tpu.config import default_args as jargs
from coldrec_tpu.data.synthetic import synthetic_dataset as jsynth
from coldrec_tpu.models import gorec as jgorec
from coldrec_tpu.models import model_factory as jfactory
from coldrec_tpu.runtime.checkpoints import save_embeddings as jsave
from coldrec_tpu.runtime.trainer import Config as JConfig
from coldrec_tpu_torch.config import default_args
from coldrec_tpu_torch.data.sampler import (
    pairwise_batches, pairwise_batches_multi_neg,
    pairwise_batches_with_neg_users,
)
from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from coldrec_tpu_torch.models import TRAINERS, model_factory
from coldrec_tpu_torch.models.common import jax_value
from coldrec_tpu_torch.runtime.trainer import Config
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

RTOL = 1e-5
SCALE_FLOOR = 1e-2
D = 16
MODELS = ("KNN", "AGNN", "VBPR", "AMR", "MTPR", "MetaEmbedding", "LARA",
          "CLCRec", "GoRec")
CASES = [(m, obj) for m in MODELS for obj in ("item", "user")
         if (m, obj) != ("CLCRec", "user")]
KW = dict(n_users=200, n_items=150, n_inter=3000, content_dim=16, seed=31)
# narrow widths for the CPU; GoRec's content dropout on, to hold its mask
SMALL = dict(num_neg=8, pre_cluster_num=8, dropout=0.2, agnn_knn_k=4)
COMMON = dict(dataset="synth", bs=256, emb_size=D, seed=5, save_emb=False,
              early_stop=10)


def small_flags(model):
    """The model's own flags of SMALL (the others would be refused)."""
    own = default_args(model=model).__dict__
    return {k: v for k, v in SMALL.items() if k in own}


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    """Per cold object: the JAX and port datasets (equal, bit for bit) and
    an emb dir holding random MF tables and random VBPR tensors."""
    out = {}
    for obj in ("item", "user"):
        jd = jsynth(cold_object=obj, **KW)[0]
        td = synthetic_dataset(cold_object=obj, **KW)[0]
        emb_dir = str(tmp_path_factory.mktemp(f"emb_{obj}"))
        rng = np.random.default_rng(7)

        def table(rows, cols=D):
            return rng.standard_normal((rows, cols)).astype(np.float32) * 0.3

        jsave(emb_dir, "synth", obj, "MF", {
            "user_emb": table(jd.user_num), "item_emb": table(jd.item_num)})
        jsave(emb_dir, "synth", obj, "VBPR", {
            "user_emb": table(jd.user_num, 2 * D),
            "item_emb": table(jd.item_num, 2 * D),
            "user_emb_main_P": table(jd.user_num),
            "item_emb_main_Q": table(jd.item_num),
            "user_emb_aux": table(jd.user_num),
            "item_emb_aux": table(jd.item_num),
            "W": table(KW["content_dim"])})
        out[obj] = (jd, td, emb_dir)
    return out


def to_numpy(tree):
    return None if tree is None else jax.tree_util.tree_map(np.asarray, tree)


def make_pair(envs, model, obj, monkeypatch=None, **kw):
    """(JAX trainer, port trainer) from the same data and bus, the port's
    weights carried from the JAX trainer's (GoRec: its k-means start
    rows, recorded from the JAX draw)."""
    jd, td, emb_dir = envs[obj]
    flags = {**COMMON, **small_flags(model), "model": model,
             "cold_object": obj, "emb_dir": emb_dir, **kw}
    extra = {}
    if model == "GoRec":
        keys = []
        real = jgorec.kmeans

        def recording(key, x, k, *a, **k2):
            keys.append((key, x.shape[0], k))
            return real(key, x, k, *a, **k2)

        monkeypatch.setattr(jgorec, "kmeans", recording)
    jm = jfactory(JConfig(jargs(**flags), jd))
    if model == "GoRec":
        key, n, k = keys[0]
        extra = {"init_state": to_numpy(jm.net_state),
                 "kmeans_init": np.asarray(jax.random.choice(
                     key, n, shape=(k,), replace=False))}
    tm = TRAINERS[model](Config(default_args(**flags, device="cpu"), td),
                         init_params=to_numpy(jm.params), **extra)
    return jm, tm


def batch_stream(tm, rng):
    if tm.model_name == "LARA":
        return pairwise_batches_with_neg_users(tm.data, tm.batch_size, rng)
    if tm.model_name == "CLCRec":
        return pairwise_batches_multi_neg(tm.data, tm.batch_size, rng,
                                          tm.num_neg, tm.pool)
    return pairwise_batches(tm.data, tm.batch_size, rng)


def first_batch(tm, seed=3):
    return next(iter(batch_stream(tm, np.random.default_rng(seed))))


def assert_close(got, want, what, rtol=RTOL):
    """Within ``rtol`` of the tensor's largest magnitude (or of
    SCALE_FLOOR where all its values are smaller)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, SCALE_FLOOR)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=what)


def port_value(tensor, transposed, grad=False):
    t = tensor.grad if grad else tensor
    if t is None:  # a frozen weight: JAX's gradient is 0
        return np.zeros(tuple(tensor.shape)[::-1] if transposed
                        else tuple(tensor.shape), np.float32)
    v = t.detach().numpy()
    return v.T if transposed else v


def assert_slots(tm, tree, grad=False, kinds=("params", "state")):
    for path, tensor, transposed in tm.model.jax_slots():
        if path[0] in kinds:
            assert_close(port_value(tensor, transposed, grad),
                         jax_value(tree, path), "/".join(map(str, path)))


def jax_tables(jm):
    state = getattr(jm, "net_state", None)
    return jm.forward_tables(jm.params, *(() if state is None else (state,)))


def injected(jm, tm, batch, key):
    """The JAX loss of ``params`` and the port's loss keywords, with the
    JAX package's draws of ``key`` handed to the port."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    n = len(batch["user"])
    name = tm.model_name
    if name == "AGNN":
        keys = jax.random.split(key, 5)
        keep = 1.0 - tm.drop
        masks = [torch.tensor(np.asarray(jax.random.bernoulli(
            k, keep, (n, 2 * D)))) for k in keys[:4]]
        normal = torch.tensor(np.asarray(jax.random.normal(keys[4], (n, D))))
        return (lambda p: jm.loss_fn(p, jb, key),
                {"draws": {"masks": masks, "normal": normal}})
    if name == "GoRec":
        k1, k2, k3 = jax.random.split(key, 3)
        draws = {"z": jax.random.normal(k1, (n, D)),
                 "zgc": jax.random.normal(k2, (n, D)),
                 "keep": jax.random.bernoulli(k3, 1.0 - tm.drop_rate,
                                              (n, tm.content_dim))}
        draws = {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}
        return (lambda p: jm.loss_fn(p, jm.net_state, jb, key),
                {"draws": draws})
    if name == "CLCRec":
        flat = n * (1 + tm.num_neg)
        ri = np.random.default_rng(9).integers(
            0, flat, int(flat * tm.num_sample))
        assert np.unique(ri).size < ri.size  # rows repeat
        return (lambda p: jm.loss_fn(p, jb, key, rand_index=jnp.asarray(ri)),
                {"rand_index": torch.from_numpy(ri)})
    return lambda p: jm.loss_fn(p, jb, key), {}


@pytest.mark.parametrize("model,obj", CASES)
def test_tables_loss_and_gradients_match_jax(envs, monkeypatch, model, obj):
    """The eval tables of the carried weights, then one batch: the loss,
    every gradient and (GoRec) the running statistics after it."""
    # MetaEmbedding's inner step at lr / 10: a large lr makes the
    # second-order part of its gradient stand out of the tolerance
    lr = {"lr": 50.0} if model == "MetaEmbedding" else {}
    jm, tm = make_pair(envs, model, obj, monkeypatch, **lr)
    module = type(tm.model).from_jax_params(
        to_numpy(jm.params), to_numpy(getattr(jm, "net_state", None)),
        device="cpu")
    for (pa, a, _), (pb, b, _) in zip(module.jax_slots(),
                                      tm.model.jax_slots()):
        assert pa == pb and torch.equal(a, b)
    for got, want, side in zip((tm.user_emb, tm.item_emb), jax_tables(jm),
                               "ui"):
        assert_close(got.numpy(), want, f"{side} table")
    if model == "GoRec":
        assert np.array_equal(tm.cluster_label.numpy(), jm.cluster_label)
    batch = first_batch(tm)
    jloss_fn, kw = injected(jm, tm, batch, jax.random.PRNGKey(11))
    if model == "GoRec":
        (jloss, jstate), jgrads = jax.value_and_grad(
            jloss_fn, has_aux=True)(jm.params)
    else:
        (jloss, jgrads), jstate = jax.value_and_grad(jloss_fn)(
            jm.params), None
    tm.model.zero_grad()
    loss = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()}, **kw)
    loss.backward()
    assert_close(loss.item(), float(jloss), "loss")
    tree = {"params": to_numpy(jgrads), "state": to_numpy(jstate)}
    assert_slots(tm, tree, grad=True, kinds=("params",))
    if jstate is not None:
        assert_slots(tm, tree, kinds=("state",))


def test_metaembedding_gradient_is_second_order(envs):
    """Without the inner step's graph (a first-order step) the loss is the
    same and the gradient is not: the test above holds the second-order
    one."""
    jm, tm = make_pair(envs, "MetaEmbedding", "item", lr=50.0)
    batch = {k: torch.from_numpy(v) for k, v in first_batch(tm).items()}
    grads = []
    for create_graph in (True, False):
        real = torch.autograd.grad

        def inner(out, inp, cg=create_graph, **kw):
            kw.update(create_graph=cg, retain_graph=True)
            return real(out, inp, **kw)

        torch.autograd.grad = inner
        try:
            tm.model.zero_grad()
            loss = tm.loss(batch)
            loss.backward()
        finally:
            torch.autograd.grad = real
        grads.append((loss.item(), tm.model.dense.weight.grad.clone()))
    assert grads[0][0] == grads[1][0]
    gap = (grads[0][1] - grads[1][1]).abs().max() / grads[0][1].abs().max()
    assert gap > 100 * RTOL, gap


@pytest.mark.parametrize("model", ["CLCRec"])
def test_item_cold_only_models_raise_under_user_cold(envs, model):
    jd, td, emb_dir = envs["user"]
    flags = {**COMMON, **small_flags(model), "model": model,
             "cold_object": "user", "emb_dir": emb_dir}
    with pytest.raises(ValueError, match="only supports item cold-start"):
        model_factory(Config(default_args(**flags, device="cpu"), td))
    with pytest.raises(ValueError, match="only supports item cold-start"):
        jfactory(JConfig(jargs(**flags), jd))


def test_knn_cold_rows_are_the_mean_of_the_content_neighbours(envs):
    """KNN's cold rows: the mean of the warm rows its content search
    picked, the same ids as the JAX package's search."""
    jm, tm = make_pair(envs, "KNN", "item")
    np.testing.assert_array_equal(tm.neighbor_ids.numpy(),
                                  np.asarray(jm._neighbor_ids))
    cold = tm.cold_idx
    want = tm.model.item_emb[tm.neighbor_ids].mean(dim=1)
    assert torch.equal(tm.item_emb[cold], want.detach())


@pytest.mark.parametrize("obj", ["item", "user"])
def test_agnn_neighbours_match_jax(envs, monkeypatch, obj):
    jm, tm = make_pair(envs, "AGNN", obj, monkeypatch)
    np.testing.assert_array_equal(tm.knn_item.numpy(),
                                  np.asarray(jm.knn_item))
    np.testing.assert_array_equal(tm.knn_user.numpy(),
                                  np.asarray(jm.knn_user))


def test_cosine_knn_warm_matches_jax_with_self_rows_and_padding():
    """Warm rows drop themselves, and fewer warm rows than k pad with the
    last kept id; zero rows tie everywhere (lowest ids first). Each row
    holds four entries of +-1 (norm 2), so the cosines are exact and the
    ties are the same in both packages."""
    from coldrec_tpu.models.agnn import cosine_knn_warm as jknn
    from coldrec_tpu_torch.models.agnn import cosine_knn_warm

    rng = np.random.default_rng(4)
    feats = np.zeros((60, 8), np.float32)
    for row in feats:
        row[rng.choice(8, 4, replace=False)] = rng.choice([-1.0, 1.0], 4)
    feats[[3, 40]] = 0.0
    for warm, k in ((np.arange(0, 60, 2), 5), (np.array([1, 3, 7]), 5),
                    (np.array([9]), 3)):
        np.testing.assert_array_equal(
            cosine_knn_warm(feats, warm, k, device="cpu"),
            jknn(feats, warm, k))
