"""Port three-way (all / cold / warm) test vs the JAX package: the lists
must equal the JAX ``EvalSweep.run_pallas`` lists (interpret mode) with
equal metrics, and the kernel and plain backends must agree. Integer-valued
tables keep every score exact in both frameworks."""
import numpy as np
import pytest

from coldrec_tpu.data.synthetic import synthetic_dataset as jsynth
from coldrec_tpu.runtime.eval import EvalSweep as JEvalSweep
from coldrec_tpu.utils.metrics import ranking_evaluation as jrank
from coldrec_tpu_torch.data.synthetic import synthetic_dataset as tsynth
from coldrec_tpu_torch.runtime.trainer import SETTING_SPLITS, three_way_test
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

D = 8


@pytest.fixture(scope="module")
def setup():
    kw = dict(n_users=80, n_items=300, n_inter=2500, cold_object="item",
              seed=11)
    jd, _ = jsynth(**kw)
    td, _ = tsynth(**kw)
    rng = np.random.default_rng(3)
    ue = rng.integers(-3, 4, (jd.user_num, D)).astype(np.float32)
    ie = rng.integers(-3, 4, (jd.item_num, D)).astype(np.float32)
    return jd, td, ue, ie


@pytest.mark.parametrize("batch_size", [16, 2048])
def test_three_way_test_matches_jax_pallas_sweep(setup, batch_size):
    jd, td, ue, ie = setup
    res = three_way_test(td, ue, ie, topN=(5, 10), batch_size=batch_size,
                         device="cpu", verbose=False)
    sweep = JEvalSweep(jd, "item", batch_size, 10)
    for test_type in ("all", "cold", "warm"):
        split = SETTING_SPLITS[(test_type, "test")]
        assert sweep.pallas_supported(split, test_type)
        jrec = sweep.run_pallas(split, test_type, ue, ie, interpret=True)
        np.testing.assert_array_equal(res[test_type]["rec"], jrec)
        es = jd.eval_splits[split]
        _, jperf = jrank(es.indptr, es.items, jrec, [5, 10], jd.item_num)
        assert res[test_type]["performance"] == jperf


def test_three_way_test_plain_backend_agrees(setup):
    _, td, ue, ie = setup
    a = three_way_test(td, ue, ie, device="cpu", verbose=False)
    b = three_way_test(td, ue, ie, backend="plain", device="cpu",
                       verbose=False)
    for test_type in ("all", "cold", "warm"):
        np.testing.assert_array_equal(a[test_type]["rec"],
                                      b[test_type]["rec"])
    with pytest.raises(ValueError):
        three_way_test(td, ue, ie, backend="xla", device="cpu")
