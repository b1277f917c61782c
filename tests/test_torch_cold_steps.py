"""Several steps of the six cold-start models in the port against the JAX
package, on the CPU (set-up and tolerances: ``test_torch_cold_models.py``).

``STEPS`` Adam steps from carried weights on the same batches (DropoutNet
fed the JAX package's masks): the losses agree within ``RTOL``; the weights
within ``WEIGHT_RTOL`` but for Adam's near-zero-gradient elements, except
the Linear biases right ahead of a BatchNorm, whose exact gradient is 0 and
which Adam moves on rounding noise in both packages; the eval tables of the
JAX trainer's final weights agree within ``RTOL``. The BatchNorm running
statistics after ``STEPS`` steps agree within ``RTOL``.
"""
import jax
import numpy as np
import pytest

from coldrec_tpu_torch.data.sampler import pairwise_batches
from test_torch_cold_models import (  # noqa: F401  (envs is a fixture)
    CASES, RTOL, assert_slots, assert_close, assert_tables_from_jax,
    assert_weights, envs, jax_batch, make_pair, step_kw, to_numpy,
    torch_batch,
)
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

STEPS = 5


def jax_steps(jm, batches, keys, before=None):
    """The JAX trainer's steps on numpy batches; ``before(i)`` runs ahead
    of step i. Returns the losses."""
    losses = []
    stateful = getattr(jm, "stateful", False)
    for i, (batch, key) in enumerate(zip(batches, keys)):
        if before is not None:
            before(i)
        args = (jm.params, jm.opt_state) + ((jm.net_state,) if stateful
                                            else ())
        extra = (key,) if getattr(jm, "uses_rng_in_loss", False) else ()
        out = jm._step(*args, jax_batch(batch), *extra)
        jm.params, jm.opt_state = out[0], out[1]
        if stateful:
            jm.net_state = out[2]
        losses.append(float(out[-1]))
    return losses


@pytest.mark.parametrize("model,obj", CASES)
def test_adam_steps_match_jax(envs, model, obj):
    """STEPS steps of both trainers: the losses agree, and every weight but
    the noise-walked biases; then, from the JAX trainer's weights and
    state, the eval tables."""
    jm, tm = make_pair(envs, model, obj)
    batches = list(zip(range(STEPS), pairwise_batches(
        tm.data, tm.batch_size, np.random.default_rng(4))))
    batches = [b for _, b in batches]
    keys = [jax.random.PRNGKey(100 + i) for i in range(STEPS)]
    jlosses = jax_steps(jm, batches, keys)
    for i, (batch, key) in enumerate(zip(batches, keys)):
        loss = tm.train_step(torch_batch(batch),
                             **step_kw(tm, key, len(batch["user"])))
        assert_close(loss.item(), jlosses[i], RTOL, f"loss {i}")
    assert_weights(tm, jm.params, STEPS)
    assert_tables_from_jax(jm, tm)


@pytest.mark.parametrize("model,obj", [c for c in CASES
                                       if c[0] in ("DropoutNet", "ALDI")])
def test_running_stats_match_jax(envs, model, obj):
    """BatchNorm running statistics after STEPS steps, every tower call
    updating them (DropoutNet's towers and ALDI's item tower twice a step),
    with the port's weights set to the JAX trainer's ahead of each step (so
    the noise-walked biases, which the running means carry, agree)."""
    jm, tm = make_pair(envs, model, obj)
    batches = [b for _, b in zip(range(STEPS), pairwise_batches(
        tm.data, tm.batch_size, np.random.default_rng(6)))]
    keys = [jax.random.PRNGKey(200 + i) for i in range(STEPS)]

    def port_step(i):
        tm.model.load_jax(to_numpy(jm.params))
        tm.train_step(torch_batch(batches[i]),
                      **step_kw(tm, keys[i], len(batches[i]["user"])))

    jax_steps(jm, batches, keys, before=port_step)
    assert_slots(tm, {"state": to_numpy(jm.net_state)}, RTOL,
                 kinds=("state",))
