"""The six cold-start models of the port against the JAX package, on the CPU.

Each case builds the JAX trainer and the port's from the same numpy data
and the same backbone bus (random tables written once), carries the JAX
trainer's parameters (and BatchNorm state) across with ``init_params`` /
``init_state``, and feeds both the same numpy batches. DropoutNet's dropped
rows are the masks the JAX package draws from its key, handed to the
port's loss. Losses and gradients agree within ``RTOL`` of each tensor's
largest magnitude (float32 sums in another order). The multi-step checks
are in ``test_torch_cold_steps.py`` and ``test_torch_cold_train.py``.
ALDI is item-cold only; its user case raises in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coldrec_tpu.config import default_args as jargs
from coldrec_tpu.data.synthetic import synthetic_dataset as jsynth
from coldrec_tpu.models import model_factory as jfactory
from coldrec_tpu.runtime.checkpoints import save_embeddings as jsave
from coldrec_tpu.runtime.trainer import Config as JConfig
from coldrec_tpu_torch.config import default_args
from coldrec_tpu_torch.data.sampler import pairwise_batches
from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from coldrec_tpu_torch.models import TRAINERS, model_factory
from coldrec_tpu_torch.models.aldi import aldi_item_frequency
from coldrec_tpu_torch.models.common import (
    MaskedBatchNorm1d, dropout, jax_value,
)
from coldrec_tpu_torch.runtime.trainer import Config
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

RTOL = 1e-6
SCALE_FLOOR = 1e-2
# Adam divides each gradient by the root of its running square, so a
# relative difference of ~1e-6 in a small gradient element moves its weight
# by up to ~1e-5 of the tensor's scale within a few steps; an element whose
# gradient is near 0 (within rounding) moves by up to lr a step in either
# direction, so FLIP_FRACTION of a tensor's elements may differ by up to
# Adam's bound, 2 * lr * steps
WEIGHT_RTOL = 1e-5
FLIP_FRACTION = 0.01
MODELS = ("DropoutNet", "GAR", "ALDI", "DeepMusic", "DUIF", "Heater")
CASES = [(m, obj) for m in MODELS for obj in ("item", "user")
         if (m, obj) != ("ALDI", "user")]
KW = dict(n_users=70, n_items=80, n_inter=1400, content_dim=12, seed=31)
# narrow widths for the CPU: every model's own flags, cut down
SMALL = dict(dropoutnet_hidden1=16, dropoutnet_hidden2=8, aldi_hidden=16,
             heater_mlp_hidden=16, tws=1)
COMMON = dict(dataset="synth", bs=256, emb_size=16, seed=5, save_emb=False,
              early_stop=10)


def small_flags(model):
    """The model's own flags of SMALL (the others would be refused)."""
    return {k: v for k, v in SMALL.items() if k in default_args(
        model=model).__dict__}


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    """Per cold object: the JAX and port datasets (equal, bit for bit) and
    an emb dir holding random MF tables on the bus."""
    out = {}
    for obj in ("item", "user"):
        jd = jsynth(cold_object=obj, **KW)[0]
        td = synthetic_dataset(cold_object=obj, **KW)[0]
        emb_dir = str(tmp_path_factory.mktemp(f"emb_{obj}"))
        rng = np.random.default_rng(7)
        jsave(emb_dir, "synth", obj, "MF", {
            "user_emb": rng.standard_normal((jd.user_num, 16)).astype(
                np.float32) * 0.3,
            "item_emb": rng.standard_normal((jd.item_num, 16)).astype(
                np.float32) * 0.3})
        out[obj] = (jd, td, emb_dir)
    return out


def to_numpy(tree):
    return None if tree is None else jax.tree_util.tree_map(np.asarray, tree)


def make_pair(envs, model, obj, **kw):
    """(JAX trainer, port trainer) from the same data and bus, the port's
    weights carried from the JAX trainer's."""
    jd, td, emb_dir = envs[obj]
    flags = {**COMMON, **small_flags(model), "model": model,
             "cold_object": obj, "emb_dir": emb_dir, **kw}
    jm = jfactory(JConfig(jargs(**flags), jd))
    tm = TRAINERS[model](
        Config(default_args(**flags, device="cpu"), td),
        init_params=to_numpy(jm.params),
        init_state=to_numpy(getattr(jm, "net_state", None)))
    return jm, tm


def jax_masks(key, n, rate):
    """The rows the JAX DropoutNet drops in the pos and neg passes of the
    step with ``key`` (dropoutnet.py: ``_encode_pairs``)."""
    n_zero = int(n * rate)
    masks = []
    for k in jax.random.split(key):
        perm = jax.random.permutation(k, n)
        masks.append(torch.from_numpy(np.array(
            jnp.ones((n,)).at[perm[:n_zero]].set(0.0))))
    return tuple(masks)


def step_kw(tm, key, n):
    if isinstance(tm, TRAINERS["DropoutNet"]):
        return {"masks": jax_masks(key, n, tm.n_dropout)}
    return {}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_close(got, want, rtol, what):
    """Within ``rtol`` of the tensor's largest magnitude, or of SCALE_FLOOR
    where all its values are smaller (e.g. the gradient of a bias ahead of
    a BatchNorm, zero up to rounding noise of ~1e-10 in both packages)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, SCALE_FLOOR)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=what)


def port_value(tensor, transposed, grad=False):
    t = tensor.grad if grad else tensor
    if t is None:  # a weight the loss does not reach: JAX's gradient is 0
        return np.zeros(tuple(tensor.shape)[::-1] if transposed
                        else tuple(tensor.shape), np.float32)
    v = t.detach().numpy()
    return v.T if transposed else v


def assert_slots(tm, tree, rtol, grad=False, kinds=("params", "state")):
    for path, tensor, transposed in tm.model.jax_slots():
        if path[0] not in kinds:
            continue
        assert_close(port_value(tensor, transposed, grad),
                     jax_value(tree, path), rtol, "/".join(map(str, path)))


def noise_walked(path):
    """A Linear bias right ahead of a BatchNorm: its exact gradient is 0,
    so in both packages Adam moves it by ~lr a step on rounding noise of
    either sign (DropoutNet's tower blocks, ALDI's fc1)."""
    return path[-1] == "b" and path[-2] in ("lin", "fc1")


def assert_weights(tm, params, steps):
    """The port's weights against the JAX ``params``: within WEIGHT_RTOL
    but for FLIP_FRACTION of each tensor, and those within Adam's bound;
    the noise-walked biases are left out."""
    tree = {"params": to_numpy(params)}
    for path, tensor, transposed in tm.model.jax_slots():
        if path[0] != "params" or noise_walked(path):
            continue
        got = port_value(tensor, transposed)
        want = jax_value(tree, path)
        diff = np.abs(got - want)
        beyond = diff > WEIGHT_RTOL * max(np.abs(want).max(), SCALE_FLOOR)
        name = "/".join(map(str, path))
        assert beyond.mean() <= FLIP_FRACTION, (name, beyond.sum())
        assert diff.max() <= 2 * tm.lr * steps, (name, diff.max())


def assert_tables_from_jax(jm, tm):
    """The port's eval tables of the JAX trainer's weights and state equal
    the JAX trainer's eval tables."""
    state = getattr(jm, "net_state", None)
    tm.model.load_jax(to_numpy(jm.params), to_numpy(state))
    tm.refresh_tables()
    for got, want in zip((tm.user_emb, tm.item_emb), jm.forward_tables(
            jm.params, *(() if state is None else (state,)))):
        assert_close(got.numpy(), np.asarray(want), RTOL, "eval table")


def first_batch(tm, seed=3):
    return next(iter(pairwise_batches(tm.data, tm.batch_size,
                                      np.random.default_rng(seed))))


@pytest.mark.parametrize("model,obj", CASES)
def test_loss_and_gradients_match_jax(envs, model, obj):
    """One batch: loss, every gradient and the running statistics after
    it agree."""
    jm, tm = make_pair(envs, model, obj)
    # from_jax_params alone (shapes read off the JAX tree) holds the
    # weights and state the trainer carried across
    module = type(tm.model).from_jax_params(
        to_numpy(jm.params), to_numpy(getattr(jm, "net_state", None)),
        device="cpu")
    for (pa, a, _), (pb, b, _) in zip(module.jax_slots(),
                                      tm.model.jax_slots()):
        assert pa == pb and torch.equal(a, b)
    batch = first_batch(tm)
    key = jax.random.PRNGKey(11)
    if getattr(jm, "stateful", False):
        (jloss, jstate), jgrads = jax.value_and_grad(
            jm.loss_fn, has_aux=True)(jm.params, jm.net_state,
                                      jax_batch(batch), key)
    else:
        jloss, jgrads = jax.value_and_grad(jm.loss_fn)(
            jm.params, jax_batch(batch), key)
        jstate = None
    tm.model.zero_grad()
    loss = tm.loss(torch_batch(batch), **step_kw(tm, key, len(batch["user"])))
    loss.backward()
    assert_close(loss.item(), float(jloss), RTOL, "loss")
    tree = {"params": to_numpy(jgrads), "state": to_numpy(jstate)}
    assert_slots(tm, tree, RTOL, grad=True, kinds=("params",))
    if jstate is not None:  # the running statistics after one step
        assert_slots(tm, tree, RTOL, kinds=("state",))


def test_aldi_is_item_cold_only(envs):
    _, td, emb_dir = envs["user"]
    args = default_args(**COMMON, model="ALDI", cold_object="user",
                        emb_dir=emb_dir, device="cpu")
    with pytest.raises(ValueError, match="only supports item cold-start"):
        model_factory(Config(args, td))
    jd = envs["user"][0]
    with pytest.raises(ValueError, match="only supports item cold-start"):
        jfactory(JConfig(jargs(**{**COMMON, "model": "ALDI",
                                  "cold_object": "user",
                                  "emb_dir": emb_dir}), jd))


# DUIF is a joint model: it reads no bus
@pytest.mark.parametrize("model", [m for m in MODELS if m != "DUIF"])
def test_missing_bus_names_the_npz(envs, model, tmp_path):
    _, td, _ = envs["item"]
    args = default_args(**COMMON, model=model, emb_dir=str(tmp_path),
                        device="cpu")
    with pytest.raises(FileNotFoundError, match="synth_cold_item_MF_emb.npz"):
        model_factory(Config(args, td))


def test_masked_batchnorm_matches_jax():
    """Weighted statistics, the unbiased running variance and eval mode,
    against ``batchnorm_apply`` of the JAX package."""
    from coldrec_tpu.models.common import batchnorm_apply

    rng = np.random.default_rng(0)
    x = rng.standard_normal((12, 5)).astype(np.float32)
    w = np.r_[np.ones(9), np.zeros(3)].astype(np.float32)
    bn = MaskedBatchNorm1d(5, momentum=0.01, eps=1e-3)
    with torch.no_grad():
        bn.scale.copy_(torch.linspace(0.5, 1.5, 5))
        bn.bias.copy_(torch.linspace(-1, 1, 5))
    params = {"scale": jnp.asarray(bn.scale.detach().numpy()),
              "bias": jnp.asarray(bn.bias.detach().numpy())}
    state = {"mean": jnp.zeros(5), "var": jnp.ones(5)}
    for weight in (w, None):
        y = bn(torch.from_numpy(x),
               None if weight is None else torch.from_numpy(weight))
        jy, state = batchnorm_apply(
            params, state, jnp.asarray(x), True, momentum=0.01, eps=1e-3,
            weight=None if weight is None else jnp.asarray(weight))
        assert_close(y.detach().numpy(), np.asarray(jy), RTOL, "train")
        assert_close(bn.running_var.numpy(), np.asarray(state["var"]), RTOL,
                     "running var")
    bn.eval()
    jy, _ = batchnorm_apply(params, state, jnp.asarray(x), False,
                            momentum=0.01, eps=1e-3)
    assert_close(bn(torch.from_numpy(x)).detach().numpy(), np.asarray(jy),
                 RTOL, "eval")


def test_dropout_keeps_and_scales():
    x = torch.ones(4000)
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, 0.25, True, gen)
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    assert dropout(x, 0.25, False) is x


def test_aldi_item_frequency_matches_jax(envs):
    from coldrec_tpu.models.aldi import aldi_item_frequency as jfreq

    jd, td, _ = envs["item"]
    np.testing.assert_array_equal(aldi_item_frequency(td), jfreq(jd))
