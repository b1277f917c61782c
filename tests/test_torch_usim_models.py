"""USIM in the port against the JAX package, on the CPU.

Both trainers are built from the same numpy data (60 users x 80 items, 12
content columns, d = 8) and the same bus (random MF tables); the port
carries the JAX model's actor, critic, targets and mapper across with
``init_params`` (both Adam states start at zero). Each pure function gets
the same inputs on both sides: the top-k and the support columns are held
exactly, the logits' reductions, the reward and the log-probs within
``RTOL`` (1e-6) of each tensor's largest magnitude. A whole batch step runs
on JAX's own draws, replayed from its key schedule (one discarded split
per rollout, one split per step, ``split(sk, 3)`` for the negatives, the
exclusion uniform and the Gumbel noise, one split for the termination
times), on the dense and on the chunked PPO path: the rollout actions
equal, the weights and Adam's moments within ``STEP_RTOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coldrec_tpu.config import default_args as jargs
from coldrec_tpu.data.synthetic import synthetic_dataset as jsynth
from coldrec_tpu.models import model_factory as jfactory
from coldrec_tpu.models import usim as jusim
from coldrec_tpu.runtime.checkpoints import save_embeddings as jsave
from coldrec_tpu.runtime.trainer import Config as JConfig
from coldrec_tpu_torch.config import default_args
from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from coldrec_tpu_torch.models import TRAINERS
from coldrec_tpu_torch.models import usim as tusim
from coldrec_tpu_torch.runtime.trainer import Config
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

D = 8
RTOL = 1e-6
# one batch step (3 rollouts, 5 PPO iterations, the termination step):
# float32 sums in another order, carried through 6 Adam steps
STEP_RTOL = 1e-5
KW = dict(n_users=60, n_items=80, n_inter=1200, content_dim=12, seed=31)
FLAGS = dict(model="USIM", dataset="synth", cold_object="item", bs=16,
             emb_size=D, seed=5, save_emb=False, usim_max_time=3, usim_k=4,
             usim_content_hidden=10, early_stop=10)
NETS = ("actor", "critic", "target_actor", "target_critic", "mapper")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The JAX and port datasets (equal, bit for bit) and an emb dir
    holding random MF tables."""
    jd = jsynth(cold_object="item", **KW)[0]
    td = synthetic_dataset(cold_object="item", **KW)[0]
    emb_dir = str(tmp_path_factory.mktemp("usim_emb"))
    rng = np.random.default_rng(7)
    jsave(emb_dir, "synth", "item", "MF", {
        "user_emb": rng.standard_normal((jd.user_num, D)).astype(
            np.float32) * 0.3,
        "item_emb": rng.standard_normal((jd.item_num, D)).astype(
            np.float32) * 0.3})
    return jd, td, emb_dir


@pytest.fixture(scope="module")
def pair(env):
    """One (JAX, port) pair for the tests that change no weights."""
    return make_pair(env)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_nets(jm) -> dict:
    return {name: to_numpy(getattr(jm, name)) for name in NETS}


def make_pair(env, **kw):
    """(JAX trainer, port trainer) on the same data and bus, the port's
    nets carried from the JAX trainer's."""
    jd, _, emb_dir = env
    jm = jfactory(JConfig(jargs(**{**FLAGS, "emb_dir": emb_dir, **kw}),
                          jd))
    return jm, port_of(env, jm, **kw)


def port_of(env, jm, **kw):
    """A new port trainer holding the JAX trainer's initial nets."""
    _, td, emb_dir = env
    args = default_args(**{**FLAGS, "emb_dir": emb_dir, "device": "cpu",
                           **kw})
    return TRAINERS["USIM"](Config(args, td), init_params=jax_nets(jm))


def jax_draws(jm, b, key) -> dict:
    """The port's ``draws`` of JAX's ``_batch_step`` key: the key schedule
    of its rollout scans replayed."""
    n_user, k, steps = jm.n_user, jm.k, jm.max_time
    c = min(k, n_user) + k + 1
    neg, unif, gumbel = [], [], []
    for _ in range(tusim.ROLLOUTS):
        key, _sub = jax.random.split(key)
        for _ in range(steps):
            key, sk = jax.random.split(key)
            k1, k2, k3 = jax.random.split(sk, 3)
            neg.append(jax.random.randint(k1, (b, k), 0, n_user - 1))
            unif.append(jax.random.uniform(k2, (b,)))
            gumbel.append(jax.random.gumbel(k3, (b, c)))
    key, sk = jax.random.split(key)
    rand_t = jax.random.randint(sk, (b,), 0, steps)
    lead = (tusim.ROLLOUTS, steps, b)

    def stack(xs, tail=()):
        return torch.tensor(np.stack([np.asarray(x) for x in xs]).reshape(
            lead + tail))

    return {"neg": stack(neg, (k,)), "unif": stack(unif),
            "gumbel": stack(gumbel, (c,)), "rand_t": torch.tensor(
                np.asarray(rand_t))}


def jax_batch_step(jm, batch, key):
    """JAX's jitted ``_batch_step`` on ``batch``; returns its outputs and
    the rollout actions (3, max_time, B), read by an ordered callback."""
    actions = []
    sample = jm._sample_mask

    def recording(*a, **kw):
        out = sample(*a, **kw)
        jax.debug.callback(lambda x: actions.append(np.asarray(x)), out[0],
                           ordered=True)
        return out

    jm._sample_mask = recording
    try:
        out = jax.jit(jm._batch_step)(
            jm.actor, jm.actor_state, jm.critic, jm.critic_state,
            jm.target_actor, jm.target_critic, jnp.asarray(batch["items"]),
            jnp.asarray(batch["weight"]), key)
        jax.block_until_ready(out)
    finally:
        jm._sample_mask = sample
    b = batch["items"].shape[0]
    return out, np.stack(actions).reshape(tusim.ROLLOUTS, jm.max_time, b)


def assert_close(got, want, what, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: max rel err {err:.3e} > {rtol}"


def assert_net(module, jparams, what, rtol):
    """A ModuleDict of Linear layers against JAX's {"w": (in, out), "b"}."""
    for name, layer in module.items():
        assert_close(layer.weight.detach().numpy().T, jparams[name]["w"],
                     f"{what}/{name}/w", rtol)
        assert_close(layer.bias.detach().numpy(), jparams[name]["b"],
                     f"{what}/{name}/b", rtol)


def adam_moments(state):
    """optax's Adam (mu, nu) trees of a chain's state."""
    for part in jax.tree_util.tree_leaves(
            state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(part, "mu"):
            return part.mu, part.nu
    raise AssertionError("no Adam state")


def assert_adam(opt, module, jstate, what, rtol):
    mu, nu = adam_moments(jstate)
    for name, layer in module.items():
        for attr, key in (("weight", "w"), ("bias", "b")):
            st = opt.state[getattr(layer, attr)]
            for slot, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
                got = st[slot].numpy()
                assert_close(got.T if attr == "weight" else got,
                             tree[name][key], f"{what} {slot} {name}/{key}",
                             rtol)


def index_sets(rng, t, k, nu):
    """pos, user, neg and masked-argmax index sets as the sampler makes
    them, with overlaps (pos ∧ user on half the rows), duplicates across
    sets and an exclusion that hits a candidate."""
    pos = np.stack([rng.choice(nu, k, replace=False) for _ in range(t)])
    usr = np.stack([rng.choice(nu - 1, k, replace=False) for _ in range(t)])
    usr[: t // 2, 0] = pos[: t // 2, 0]
    neg = np.concatenate([rng.integers(0, nu - 1, (t, k)),
                          np.full((t, 1), nu - 1)], axis=1)
    neg[:, 0] = pos[:, 1]
    mam = rng.integers(0, nu, t)
    mam[0] = pos[0, 0]
    mam[1] = nu - 1
    return [x.astype(np.int32) for x in (pos, usr, neg, mam)]


# ----------------------------------------------------------- pure functions
@pytest.mark.parametrize("width", [13, 16, 50, 67])
def test_stream_topk_matches_the_jax_scan(width):
    """At seg 8 a width above 16 takes JAX's scan merge; on integer values
    (ties everywhere) the ids are JAX's exactly, lowest index first."""
    rng = np.random.default_rng(width)
    x = rng.integers(-3, 4, (9, width)).astype(np.float32)
    for k in (1, 5, 8):  # the scan form takes k <= seg
        jv, ji = jusim._stream_topk(jnp.asarray(x), k, seg=8)
        tv, ti = tusim._stream_topk(torch.tensor(x), k, seg=8)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_support_columns_keep_flags_exact(pair):
    jm, tm = pair
    rng = np.random.default_rng(0)
    idxs = index_sets(rng, 24, jm.k, jm.n_user)
    jc, jk = jax.jit(jm._support_columns)(*map(jnp.asarray, idxs))
    tc, tk = tm.model._support_columns(*(torch.tensor(x).long()
                                         for x in idxs))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert 0 < tk.sum() < tk.numel()


def test_logits_reward_and_log_probs_match_jax(pair):
    """``_map_content``, ``_z_lse``, ``_sp_at``, ``_target_topk`` (with the
    stop row), ``_reward`` (done rows zeroed) and ``_log_probs_masked`` (in-
    and out-of-support actions) on the same inputs."""
    jm, tm = pair
    m = tm.model
    rng = np.random.default_rng(1)
    t, nu = 24, jm.n_user
    states = rng.standard_normal((t, D + 1)).astype(np.float32)
    js, ts = jnp.asarray(states), torch.tensor(states)
    content = rng.standard_normal((t, KW["content_dim"])).astype(np.float32)
    assert_close(m._map_content(torch.tensor(content)).detach().numpy(),
                 jax.jit(jm._map_content)(jnp.asarray(content)),
                 "map_content")
    jz, jl, je = jax.jit(jm._z_lse)(jm.actor, js)
    tz, tl, te = m._z_lse(m.actor, ts)
    for got, want, what in ((tz, jz, "z"), (tl, jl, "lse"), (te, je, "end")):
        assert_close(got.detach().numpy(), want, what)
    idxs = index_sets(rng, t, jm.k, nu)
    tidx = [torch.tensor(x).long() for x in idxs]
    jc, _ = jax.jit(jm._support_columns)(*map(jnp.asarray, idxs))
    tc, _ = m._support_columns(*tidx)
    assert_close(m._sp_at(tc, tz, tl, te).detach().numpy(),
                 jax.jit(jm._sp_at)(jc, jz, jl, je), "sp_at")
    actions = np.where(np.arange(t) % 3 == 0, idxs[3], idxs[0][:, 0])
    actions[2] = nu - 1  # the stop action
    lp_t = m._log_probs_masked(m.actor, ts, torch.tensor(actions).long(),
                               tidx).detach().numpy()
    lp_j = np.asarray(jax.jit(jm._log_probs_masked)(
        jm.actor, js, jnp.asarray(actions.astype(np.int32)),
        tuple(map(jnp.asarray, idxs))))
    assert_close(lp_t, lp_j, "log_probs")
    assert (lp_j < -40).any()  # an excluded action floors to log(1e-20)

    items = rng.choice(jm.data.item_num, t, replace=False)
    item_j = jm.item_table[jnp.asarray(items)]
    item_t = m.item_table[torch.tensor(items)]
    jtop = jax.jit(jm._target_topk)(item_j)
    ttop = m._target_topk(item_t)
    np.testing.assert_array_equal(ttop[1].numpy(), np.asarray(jtop[1]))
    assert_close(ttop[0].numpy(), jtop[0], "target top-k values")
    state = rng.standard_normal((t, D)).astype(np.float32) * 0.3
    dones = np.arange(t) % 4 == 0
    act = rng.integers(0, nu, t)
    jr = jax.jit(jm._reward)(item_j, jnp.asarray(state), jnp.asarray(act),
                    jnp.asarray(dones))
    tr = m._reward(item_t, torch.tensor(state), torch.tensor(act),
                   torch.tensor(dones))
    assert_close(tr.numpy(), jr, "reward")
    assert (tr.numpy()[dones] == 0).all()


def test_support_form_matches_the_mask_plane(pair):
    """The port's support-column log-probs equal the reference's plane
    formulation (``_rebuild_mask`` and ``_probs``), and its plane equals
    JAX's bit for bit."""
    _, tm = pair
    m = tm.model
    rng = np.random.default_rng(2)
    t, nu = 24, m.n_user
    idxs = index_sets(rng, t, m.k, nu)
    tidx = [torch.tensor(x).long() for x in idxs]
    plane = tusim.USIM._rebuild_mask(nu, *tidx)
    np.testing.assert_array_equal(
        plane.numpy(), np.asarray(jusim.USIM._rebuild_mask(
            nu, *map(jnp.asarray, idxs))))
    states = torch.tensor(rng.standard_normal((t, D + 1)).astype(np.float32))
    actions = tidx[0][:, 0]
    with torch.no_grad():
        lp = m._log_probs_masked(m.actor, states, actions, tidx)
        sp = tusim._probs(m.actor, m.user_table, states)
        mp = sp * plane
        mp = mp / mp.sum(dim=-1, keepdim=True).clamp_min(1e-12)
        lp_plane = torch.log(mp.gather(1, actions[:, None])[:, 0]
                             .clamp_min(1e-20))
    assert_close(lp.numpy(), lp_plane.numpy(), "support vs plane", 1e-5)


def jax_greedy_actions(jm, content):
    """JAX's ``_infer`` step by step, its actions kept (its final state is
    checked against ``_infer``'s own)."""

    @jax.jit
    def greedy(actor, content):
        state = jm._map_content(content)
        dones = jnp.zeros(content.shape[0], bool)
        st = jnp.full(content.shape[0], float(jm.max_time))
        actions = []
        for _ in range(jm.max_time):
            z, lse, end = jm._z_lse(actor, jnp.concatenate(
                [state, st[:, None]], 1))
            best = end[:, 0] * jnp.exp(jnp.max(z, axis=1) - lse)
            a = jnp.where(best >= end[:, 1], jnp.argmax(z, axis=1),
                          jm.n_user - 1)
            state = state + jm.user_ext[a] * (1.0 - dones.astype(
                jnp.float32))[:, None] * jm.rate
            dones = dones | (a == jm.n_user - 1)
            st = st - 1
            actions.append(a)
        return state, jnp.stack(actions, axis=1)

    state, actions = greedy(jm.actor, content)
    np.testing.assert_allclose(np.asarray(state),
                               np.asarray(jm._infer_jit(jm.actor, content)),
                               rtol=0, atol=1e-7)
    return np.asarray(actions)


@pytest.mark.parametrize("blk", [4096, 5])
def test_infer_and_eval_tables_match_jax(pair, blk, monkeypatch):
    """The greedy rollout of the cold items, in one call and in chunks of
    ``blk`` (both packages chunked alike): actions equal, states and eval
    tables within RTOL; unclassified items score 0."""
    monkeypatch.setattr(jusim.USIM, "_infer_blk", blk)
    monkeypatch.setattr(tusim.USIMTrainer, "_infer_blk", blk)
    jm, tm = pair
    m = tm.model
    cold = np.asarray(jm.cold_idx)
    assert cold.shape[0] > blk or blk == 4096
    content = m.content[torch.tensor(cold)]
    state, actions = m._infer(m.actor, content, with_actions=True)
    want = jax_greedy_actions(jm, jm.content[jnp.asarray(cold)])
    np.testing.assert_array_equal(actions.numpy(), want)
    ju, ji = jm._eval_tables()
    tu, ti = tm._eval_tables()
    assert_close(tu.numpy(), ju, "user table")
    assert_close(ti.numpy(), ji, "item table")
    assert_close(ti.numpy()[cold], state.numpy(), "cold rows")


@pytest.mark.parametrize("path", ["dense", "chunked"])
def test_batch_step_matches_jax(env, pair, path, monkeypatch):
    """One whole batch step on JAX's replayed draws: the same rollout
    actions, then the actor, critic, targets and both Adam states within
    STEP_RTOL. ``chunked`` forces the chunked PPO path in both packages
    (T = 3 * 3 * 16 transitions in chunks of 16)."""
    if path == "chunked":
        monkeypatch.setattr(jusim.USIM, "_DENSE_OPT_ELEMS", 0)
        monkeypatch.setattr(tusim.USIM, "_DENSE_OPT_ELEMS", 0)
    jm = pair[0]  # its _batch_step is a pure function of its arguments
    tm = port_of(env, jm)
    tm.host_rng = np.random.default_rng(3)
    batch = next(iter(tm.batches()))
    assert batch["weight"].sum() > 0
    key = jax.random.PRNGKey(11)
    out, jactions = jax_batch_step(jm, batch, key)
    draws = jax_draws(jm, batch["items"].shape[0], key)
    loss = tm.train_step(tm.upload(batch), draws=draws)
    res = tm.last_step
    np.testing.assert_array_equal(res["actions"].numpy(), jactions)
    assert (jactions == jm.n_user - 1).any()  # some envs stop
    assert np.isfinite(res["losses"].numpy()).all() and np.isfinite(
        float(loss))
    actor, a_state, critic, c_state, t_actor, t_critic = out
    m = tm.model
    for module, jparams, what in ((m.actor, actor, "actor"),
                                  (m.critic, critic, "critic"),
                                  (m.target_actor, t_actor, "target_actor"),
                                  (m.target_critic, t_critic,
                                   "target_critic")):
        assert_net(module, to_numpy(jparams), what, STEP_RTOL)
    assert_adam(tm.actor_opt, m.actor, to_numpy(a_state), "actor",
                STEP_RTOL)
    assert_adam(tm.critic_opt, m.critic, to_numpy(c_state), "critic",
                STEP_RTOL)
    assert_net(m.mapper, to_numpy(jm.mapper), "mapper (frozen)", 0.0)
    assert tm.critic_opt.state[m.critic["fc1"].weight]["step"] == 6


def test_replayed_gumbel_argmax_is_jax_categorical():
    """``jax.random.categorical(key, logits)`` is ``argmax(logits +
    gumbel(key, logits.shape))``: the port's sampling on JAX's noise."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((64, 9)).astype(np.float32)
    logits[:, 3] = np.log(1e-20)
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.categorical(key, jnp.asarray(logits)))
        g = torch.tensor(np.asarray(jax.random.gumbel(key, logits.shape)))
        got = (torch.tensor(logits) + g).argmax(dim=1).numpy()
        np.testing.assert_array_equal(got, want)


def test_draws_have_the_step_shapes(pair):
    """The production draws: shapes and ranges of one batch's."""
    _, tm = pair
    m = tm.model
    d = tm.draw(16)
    lead = (tusim.ROLLOUTS, m.max_time, 16)
    assert d["neg"].shape == lead + (m.k,)
    assert d["gumbel"].shape == lead + (m.cands_width,)
    assert d["unif"].shape == lead and d["rand_t"].shape == (16,)
    assert 0 <= int(d["neg"].min()) and int(d["neg"].max()) < m.n_user - 1
    assert 0 <= int(d["rand_t"].min()) and int(
        d["rand_t"].max()) < m.max_time
    assert torch.isfinite(d["gumbel"]).all()


def test_logsumexp_product_matches_autograd():
    """``LogSumExpProduct`` against ``torch.logsumexp`` of the product and
    its autograd gradient (float64), and ``_row_lse`` against
    ``torch.logsumexp``, ``amax`` and ``argmax`` (ties: first index)."""
    rng = np.random.default_rng(5)
    emb = torch.tensor(rng.standard_normal((7, 5)), requires_grad=True)
    table = torch.tensor(rng.standard_normal((11, 5)))
    g = torch.tensor(rng.standard_normal(7))
    got = tusim.LogSumExpProduct.apply(emb, table)
    (got * g).sum().backward()
    grad = emb.grad.clone()
    emb.grad = None
    want = torch.logsumexp(emb @ table.T, dim=1)
    (want * g).sum().backward()
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(grad, emb.grad, rtol=1e-12, atol=1e-12)
    z = torch.tensor(rng.integers(-3, 4, (9, 13)).astype(np.float32))
    lse, zmax, arg = tusim._row_lse(z)
    assert torch.equal(lse, torch.logsumexp(z, dim=1))
    assert torch.equal(zmax, z.amax(dim=1))
    assert torch.equal(arg, torch.tensor(
        [int(np.argmax(r)) for r in z.numpy()]))
