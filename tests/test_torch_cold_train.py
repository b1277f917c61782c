"""Three epochs of each cold-start model in the port against the JAX
package (set-up: ``test_torch_cold_models.py``).

Both trainers start from the JAX trainer's weights, see the same batch
stream (the host samplers agree bit for bit) and, for DropoutNet, the rows
the JAX package drops at each step (its keys recorded around its step).
Per-batch losses agree within ``LOSS_RTOL``, the best epoch and the epochs
run are the same. The weights and the best eval tables agree as in
``test_torch_cold_steps.py`` and within ``TABLE_RTOL``, except DropoutNet's
and ALDI's: a Linear bias right ahead of a BatchNorm has an exact gradient
of 0 and Adam walks it on rounding noise (by ~lr a step, either sign) in
both packages. Eval mode subtracts running means that lag behind that walk,
so those tables differ by more (up to ~6e-4 of their scale here), and the
port's tables of the JAX trainer's final weights and state are held
instead; and Adam carries the two trajectories apart (DropoutNet's weights
by up to ~4e-4 of a tensor's scale, ~2e-4 in norm, after 12 steps here), so
their weights are held in norm within ``NORM_RTOL`` (the losses, which the
walk does not reach, stay within ``LOSS_RTOL``).
"""
import numpy as np
import pytest

from coldrec_tpu_torch.models.common import jax_value
from test_torch_cold_models import (  # noqa: F401  (envs is a fixture)
    CASES, assert_close, assert_tables_from_jax, assert_weights,
    envs, jax_masks, make_pair, noise_walked, port_value, to_numpy,
)
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

EPOCHS = 3
LOSS_RTOL = 1e-5
TABLE_RTOL = 1e-5
NORM_RTOL = 1e-3
NOISE_WALKED = ("DropoutNet", "ALDI")


def record_jax(jm):
    """Wrap the JAX trainer's step: its losses and, for DropoutNet, the
    masks of each step's key."""
    losses, masks, step = [], [], jm._step

    def recording(*args):
        out = step(*args)
        losses.append(float(out[-1]))
        if getattr(jm, "uses_rng_in_loss", False):
            batch, key = args[-2], args[-1]
            masks.append(jax_masks(key, batch["user"].shape[0],
                                   jm.n_dropout))
        return out

    jm._step = recording
    return losses, masks


@pytest.mark.parametrize("model,obj", CASES)
def test_three_epochs_match_jax(envs, model, obj):
    jm, tm = make_pair(envs, model, obj, epochs=EPOCHS)
    jlosses, masks = record_jax(jm)
    jm.run()
    if masks:
        tm.draw_masks = lambda n: masks.pop(0)
    tm.run()
    tl = [x for s in tm.epoch_stats for x in s["losses"]]
    assert len(tl) == len(jlosses) == EPOCHS * tm.epoch_stats[0]["batches"]
    np.testing.assert_allclose(tl, jlosses, rtol=LOSS_RTOL)
    assert not masks  # every step took the JAX package's rows
    assert tm.best_performance[0] == jm.best_performance[0]
    assert tm.epochs_ran == jm.epochs_ran == EPOCHS
    if model in NOISE_WALKED:
        tree = {"params": to_numpy(jm.params)}
        for path, tensor, transposed in tm.model.jax_slots():
            if path[0] == "params" and not noise_walked(path):
                want = jax_value(tree, path)
                gap = np.linalg.norm(port_value(tensor, transposed) - want)
                assert gap <= NORM_RTOL * np.linalg.norm(want), path
        assert_tables_from_jax(jm, tm)
        return
    assert_weights(tm, jm.params, len(tl))
    for got, want in ((tm.user_emb, jm.user_emb), (tm.item_emb,
                                                    jm.item_emb)):
        assert_close(got.numpy(), np.asarray(want), TABLE_RTOL, "table")
    for k, v in jm.best_performance[1].items():
        assert abs(tm.best_performance[1][k] - v) <= 1e-6, k
