"""Training runs of the reconstruction-family cold models in the port
against the JAX package, on the CPU (set-up: ``test_torch_recon_models.py``).

Each model trains 3 epochs through both trainers from shared weights on the
same batch stream (both draw it from ``--seed``, bit for bit). Where the
loss draws (M2VAE, CGRC, FSGNN), the JAX run's key of every step is
recorded and its draws handed to the port's step, and M2VAE's eval draw of
every epoch likewise. The batch losses agree within ``RTOL``, the best
tables and the final weights within ``DRIFT_RTOL`` of their scale (Adam
carries float32 rounding differences forward), and the best epoch is the
same. M2VAE runs with its coupled weight decay (0.1, added to the
gradient before Adam's moments, as optax's chain); CCFCRec also runs on the
MF bus under ``--pretrain`` without ``--pretrain_update``, where neither
package's tables move.
"""
import jax
import numpy as np
import pytest
import torch

from coldrec_tpu_torch.models.common import jax_value
from test_torch_content_models import RTOL, assert_close, to_numpy
from test_torch_recon_models import (  # noqa: F401  (envs is a fixture)
    MODELS, ZERO_GRADIENT, envs, jax_draws, make_pair,
)
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

# The weights whose exact gradient is 0 (ZERO_GRADIENT) are left out of
# the weight comparison: Adam walks them by ~lr a step on float32 noise of
# either sign, differently in each package; their effect on the losses and
# tables is nil, and those are compared.
DRIFT_RTOL = 1e-4


def run_both(jm, tm):
    """Train the JAX trainer, recording each step's loss and key (and
    M2VAE's eval key of every epoch), then the port's trainer with the
    JAX draws; returns the JAX losses."""
    losses, keys, eval_keys = [], [], []
    step = jm._step

    def recording(*args):
        out = step(*args)
        losses.append(float(out[-1]))
        if jm.uses_rng_in_loss:
            keys.append(args[-1])
        return out

    jm._step = recording
    if tm.model_name == "M2VAE":
        hook = jm.epoch_hook

        def recording_hook(epoch):
            hook(epoch)
            # a copy: the step donates the state that holds the key
            eval_keys.append(np.asarray(jm.net_state["eval_key"]))

        jm.epoch_hook = recording_hook
    jm.run()
    draws = iter([jax_draws(jm, tm, tm.batch_size, k) for k in keys])
    tm.draw = lambda *a: next(draws)
    if tm.model_name == "M2VAE":
        normals = iter([torch.tensor(np.asarray(jax.random.normal(
            k, (tm.cold_idx.shape[0], tm.d)))) for k in eval_keys])
        tm.eval_normal = lambda n: next(normals)
    tm.run()
    return losses


def assert_runs_match(jm, tm, jlosses):
    tl = [x for s in tm.epoch_stats for x in s["losses"]]
    assert len(tl) == len(jlosses) > 0
    assert_close(tl, jlosses, "losses", RTOL)
    for got, want in ((tm.user_emb, jm.user_emb), (tm.item_emb, jm.item_emb)):
        assert_close(got.numpy(), np.asarray(want), "best table", DRIFT_RTOL)
    jparams = to_numpy(jm.params)
    for path, tensor, transposed in tm.model.jax_slots():
        if path[0] != "params" or path in ZERO_GRADIENT:
            continue
        got = tensor.detach().numpy()
        assert_close(got.T if transposed else got,
                     jax_value({"params": jparams}, path),
                     "/".join(map(str, path)), DRIFT_RTOL)
    assert tm.best_performance[0] == jm.best_performance[0]
    assert tm.epochs_ran == jm.epochs_ran == 3


@pytest.mark.parametrize("model,obj", [(m, "item") for m in MODELS]
                         + [("FSGNN", "user")])
def test_three_epochs_match_jax(envs, model, obj):
    jm, tm = make_pair(envs, model, obj, epochs=3)
    if model == "M2VAE":
        assert tm.optimizer.defaults["weight_decay"] == 0.1
    assert_runs_match(jm, tm, run_both(jm, tm))


def test_ccfcrec_pretrain_without_update_keeps_the_tables(envs):
    """Under ``--pretrain`` the tables come from the MF bus; without
    ``--pretrain_update`` they take no gradient and stay out of Adam, and
    after 3 epochs both packages still hold the bus tables."""
    from coldrec_tpu_torch.runtime.checkpoints import load_embeddings

    jm, tm = make_pair(envs, "CCFCRec", "item", epochs=3, pretrain=True)
    bus = load_embeddings(envs["item"][2], "synth", "item", "MF")
    m = tm.model
    assert not m.user_embedding.requires_grad
    trained = {id(p) for g in tm.optimizer.param_groups for p in g["params"]}
    assert id(m.user_embedding) not in trained
    assert_runs_match(jm, tm, run_both(jm, tm))
    for name, key in (("user_embedding", "user_emb"),
                      ("item_embedding", "item_emb")):
        np.testing.assert_array_equal(getattr(m, name).detach().numpy(),
                                      bus[key])
        np.testing.assert_array_equal(np.asarray(jm.params[name]), bus[key])
