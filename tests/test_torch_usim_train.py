"""USIM trained in the port against the JAX package, on the CPU (set-up:
``test_torch_usim_models.py``).

Both trainers run 3 epochs from the JAX model's initial nets on the same
batch stream (both draw the item order from ``--seed``, bit for bit). The
JAX run's key of every batch step is recorded and its draws replayed into
the port's step. The eval tables of every epoch agree within
``DRIFT_RTOL`` of their scale (Adam carries float32 rounding differences
forward), and the validation metrics, the best epoch and the epochs run
are the same, with early stopping on (patience 1) and off; so are the
final nets, within ``DRIFT_RTOL``.
"""
import jax
import numpy as np
import pytest

from test_torch_usim_models import (  # noqa: F401  (env is a fixture)
    assert_close, assert_net, env, jax_draws, jax_nets, make_pair,
)
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

DRIFT_RTOL = 1e-4


def run_both(jm, tm):
    """Train the JAX trainer, recording each step's key and each epoch's
    eval tables, then the port's trainer on the JAX draws; returns the
    JAX tables of every epoch and the port's."""
    keys, jtables, ttables = [], [], []
    step, jeval = jm._train_step, jm._eval_tables

    def recording(*args):
        keys.append(args[-1])
        return step(*args)

    def jax_tables():
        out = jeval()
        jtables.append(tuple(np.asarray(x) for x in out))
        return out

    jm._train_step, jm._eval_tables = recording, jax_tables
    jm.train()
    b = tm.batch_size
    draws = iter([jax_draws(jm, b, k) for k in keys])
    tm.draw = lambda n: next(draws)
    teval = tm._eval_tables

    def port_tables():
        out = teval()
        ttables.append(tuple(x.clone().numpy() for x in out))
        return out

    tm._eval_tables = port_tables
    tm.train()
    assert next(draws, None) is None  # every JAX step was replayed
    return jtables, ttables


@pytest.mark.parametrize("early_stop", [10, 1])
def test_three_epochs_match_jax(env, early_stop):
    jm, tm = make_pair(env, epochs=3, early_stop=early_stop)
    init = jax_nets(jm)
    jtables, ttables = run_both(jm, tm)
    assert len(ttables) == len(jtables) >= 2
    for (ju, ji), (tu, ti) in zip(jtables, ttables):
        assert_close(tu, ju, "user table", DRIFT_RTOL)
        assert_close(ti, ji, "item table", DRIFT_RTOL)
    assert tm.epochs_ran == jm.epochs_ran
    if early_stop == 10:
        assert tm.epochs_ran == 3
    assert tm.best_performance[0] == jm.best_performance[0]
    for name, value in jm.best_performance[1].items():
        assert tm.best_performance[1][name] == pytest.approx(value,
                                                             abs=1e-9), name
    assert_close(tm.item_emb.numpy(), np.asarray(jm.item_emb), "best table",
                 DRIFT_RTOL)
    final = jax_nets(jm)
    for net in ("actor", "critic", "target_actor", "target_critic"):
        assert_net(getattr(tm.model, net), final[net], net, DRIFT_RTOL)
    moved = init["actor"]["map"]["w"] - final["actor"]["map"]["w"]
    assert np.abs(moved).max() > 1e-4  # PPO moved the actor
    jax.clear_caches()
