"""Training runs of the content-feature cold models in the port against the
JAX package, on the CPU (set-up: ``test_torch_content_models.py``).

The models whose loss draws nothing (KNN under both backbones, VBPR, AMR,
MTPR, MetaEmbedding, LARA) train 3 epochs through both trainers from
shared weights on the same batch stream (both draw it from ``--seed``, bit
for bit): the batch losses agree within ``RTOL``, the best tables and the
final weights within ``DRIFT_RTOL`` (below), and the best epoch is the
same. The CLI runs are in ``test_torch_content_cli.py``.
"""
import numpy as np
import pytest

from coldrec_tpu_torch.models.common import jax_value
from test_torch_content_models import (  # noqa: F401  (envs is a fixture)
    RTOL, assert_close, envs, make_pair, to_numpy,
)
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

QUIET = ("KNN", "VBPR", "AMR", "MTPR", "MetaEmbedding", "LARA")
# Adagrad (lr 0.05) and Adam carry float32 rounding differences forward:
# after 3 epochs (30 steps) elements of MTPR's weights and tables sit up
# to ~1.7e-5 of their scale apart (W: 9 of 256 elements beyond 1e-5) while
# its losses stay within 1.4e-6. The losses are held to RTOL, the weights
# and tables to DRIFT_RTOL of their scale.
DRIFT_RTOL = 1e-4


def _recording(jm):
    losses, step = [], jm._step

    def rec(*args):
        out = step(*args)
        losses.append(float(out[-1]))
        return out

    jm._step = rec
    return losses


@pytest.mark.parametrize("model,backbone", [(m, "MF") for m in QUIET]
                         + [("KNN", "LightGCN")])
def test_three_epochs_match_jax(envs, model, backbone):
    jm, tm = make_pair(envs, model, "item", epochs=3, backbone=backbone)
    jlosses = _recording(jm)
    jm.run()
    tm.run()
    tl = [x for s in tm.epoch_stats for x in s["losses"]]
    assert len(tl) == len(jlosses) > 0
    assert_close(tl, jlosses, "losses", RTOL)
    for got, want in ((tm.user_emb, jm.user_emb), (tm.item_emb, jm.item_emb)):
        assert_close(got.numpy(), np.asarray(want), "best table", DRIFT_RTOL)
    jparams = to_numpy(jm.params)
    for path, tensor, transposed in tm.model.jax_slots():
        got = tensor.detach().numpy()
        assert_close(got.T if transposed else got,
                     jax_value({"params": jparams}, path),
                     "/".join(map(str, path)), DRIFT_RTOL)
    assert tm.best_performance[0] == jm.best_performance[0]
    assert tm.epochs_ran == jm.epochs_ran == 3
