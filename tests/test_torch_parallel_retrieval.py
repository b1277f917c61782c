"""``sharded_retrieval_topk`` of the port (``coldrec_tpu_torch/parallel``)
on 2 and 4 real gloo ranks against the JAX package's on a 1x2 and a 1x4
CPU device mesh (its kernel in interpret mode), id-exact, on the three cases
of ``tests/test_sharding.py``: rated rejection with a fifth of the items
excluded, a planted top set that overflows one lane class of one shard (the
ghost must flag it and the per-shard overfetch fallback return it), and a
candidate pool thinner than k with pad columns in every shard (no pad id
may alias a real item). The fixture is ``test_torch_parallel_ops.run_both``.
"""
import numpy as np
import pytest

from test_torch_parallel_ops import RETRIEVAL, WIDTHS, run_both
from test_torch_threads import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("parallel_retrieval"),
                    "retrieval")


@pytest.mark.parametrize("m", WIDTHS)
@pytest.mark.parametrize("case", RETRIEVAL)
def test_sharded_retrieval_ids_exact(results, m, case):
    port, ref, inp = results[m]
    np.testing.assert_array_equal(port[f"{case}_ids"], ref[f"{case}_ids"])
    np.testing.assert_allclose(port[f"{case}_vals"], ref[f"{case}_vals"],
                               rtol=1e-5, atol=1e-5)
    n_items = inp[f"{case}_items"].shape[0]
    if case == "pad":  # the two real candidates first, no aliased pad id
        keep = set(np.flatnonzero(~inp["pad_excl"]).tolist())
        assert all(set(row[:2].tolist()) == keep
                   for row in port["pad_ids"])
        assert (port["pad_ids"] < n_items).all()
    if case == "collision":
        assert set(port["collision_ids"][0, :10].tolist()) == set(
            range(0, 10 * 128, 128))
