"""The bf16 mode of the retrieval sweep in the port against the JAX
package's ``bf16=True`` path (Pallas in interpret mode), on the CPU.

The contract is the exact top-k of the bf16-rounded scores (bf16 operands,
fp32 sums). A product of two bf16 values is exact in fp32, so the two
packages differ only in the order of the fp32 sums: lists are id-equal
except at near-ties (top scores within ``GAP_REL`` of each other), and on
integer tables exact in bf16 (every sum exact) they are id-equal and the
values bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coldrec_tpu.config import default_args as jargs
from coldrec_tpu.data.synthetic import synthetic_dataset as jsynth
from coldrec_tpu.models import model_factory as jfactory
from coldrec_tpu.ops.pallas.retrieval import retrieval_topk as jtopk
from coldrec_tpu.runtime.checkpoints import save_embeddings as jsave
from coldrec_tpu.runtime.eval import masked_topk as jmasked_topk
from coldrec_tpu.runtime.serving import RetrievalServer as JServer
from coldrec_tpu.runtime.trainer import Config as JConfig
from coldrec_tpu_torch.config import default_args
from coldrec_tpu_torch.data.synthetic import synthetic_dataset
from coldrec_tpu_torch.models.mf import MFTrainer
from coldrec_tpu_torch.ops.cuda import retrieval as tret
from coldrec_tpu_torch.runtime.serving import RetrievalServer as TServer
from coldrec_tpu_torch.runtime.trainer import (
    Config, eval_backend, rec_lists,
)
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

GAP_REL = 1e-5


def _bf16(x):
    return tret.bf16_round(torch.from_numpy(np.array(x))).numpy()


def _assert_lists_agree(ue, ie, a, b, users=None):
    """Id-equal rows, except rows whose scores (of the bf16-rounded tables)
    at the two lists agree within GAP_REL of the row's top score."""
    users = np.arange(len(a)) if users is None else users
    ub, ib = _bf16(ue), _bf16(ie)
    for r in np.flatnonzero((a != b).any(axis=1)):
        sa, sb = ib[a[r]] @ ub[users[r]], ib[b[r]] @ ub[users[r]]
        scale = max(np.abs(sa).max(), np.abs(sb).max())
        np.testing.assert_allclose(sa, sb, atol=GAP_REL * scale)


def _inputs(rng, n_users=32, n_items=384, d=16, max_rated=8, ints=False):
    """The shape of the JAX package's bf16 test
    (tests/test_pallas_retrieval.py::test_bf16_mode_matches_bf16_oracle)."""
    if ints:  # |x| <= 64: exact in bf16, and every sum exact in fp32
        ue = rng.integers(-64, 65, (n_users, d)).astype(np.float32)
        ie = rng.integers(-64, 65, (n_items, d)).astype(np.float32)
    else:
        ue = rng.standard_normal((n_users, d)).astype(np.float32)
        ie = rng.standard_normal((n_items, d)).astype(np.float32)
    rated = np.full((n_users, max_rated), n_items, dtype=np.int32)
    for u in range(n_users):
        nr = rng.integers(0, max_rated)
        rated[u, :nr] = rng.choice(n_items, nr, replace=False)
    excluded = np.zeros(n_items, dtype=bool)
    excluded[rng.choice(n_items, n_items // 4, replace=False)] = True
    return ue, ie, rated, excluded


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_retrieval_topk_bf16_matches_jax(seed):
    ue, ie, rated, excluded = _inputs(np.random.default_rng(seed))
    k = 8
    jv, ji = jtopk(ue, ie, rated, excluded, k, tile_u=16, block_i=128,
                   interpret=True, bf16=True)
    tv, ti = tret.retrieval_topk(ue, ie, rated, excluded, k, device="cpu",
                                 bf16=True)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
    _assert_lists_agree(ue, ie, ti, ji)
    # the exact top-k of the bf16-rounded scores (the JAX package's oracle)
    scores = jnp.dot(jnp.asarray(ue).astype(jnp.bfloat16),
                     jnp.asarray(ie).astype(jnp.bfloat16).T,
                     preferred_element_type=jnp.float32)
    _, oi = jmasked_topk(scores, jnp.asarray(rated), jnp.asarray(excluded), k)
    _assert_lists_agree(ue, ie, ti, np.asarray(oi))


@pytest.mark.parametrize("n_items", [384, 1000])
def test_retrieval_topk_bf16_integer_tables_id_exact(n_items):
    ue, ie, rated, excluded = _inputs(np.random.default_rng(5),
                                      n_items=n_items, ints=True)
    jv, ji = jtopk(ue, ie, rated, excluded, 10, tile_u=16, block_i=128,
                   interpret=True, bf16=True)
    tv, ti = tret.retrieval_topk(ue, ie, rated, excluded, 10, device="cpu",
                                 bf16=True)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)


def test_bf16_mode_rounds_the_operands():
    """On N(0,1) tables the bf16 lists are the rounded scores' top-k, and
    some row differs from the fp32 lists (the mode is applied)."""
    ue, ie, rated, excluded = _inputs(np.random.default_rng(9), n_users=64)
    _, bi = tret.retrieval_topk(ue, ie, rated, excluded, 8, device="cpu",
                                bf16=True)
    _, fi = tret.retrieval_topk(ue, ie, rated, excluded, 8, device="cpu")
    assert (bi != fi).any()
    scores = _bf16(ue) @ _bf16(ie).T
    scores[:, excluded] = -np.inf
    for u in range(len(ue)):
        scores[u, rated[u][rated[u] < len(ie)]] = -np.inf
    oracle = np.argsort(-scores, axis=1, kind="stable")[:, :8]
    _assert_lists_agree(ue, ie, bi, oracle)


def test_exact_fallback_rounds_as_the_kernel():
    """A flagged row goes to ``_exact_rows``, which in bf16 mode scores the
    rounded operands: every row through it equals the kernel path's."""
    ue, ie, rated, excluded = _inputs(np.random.default_rng(3))
    rows = torch.arange(len(ue))
    fv, fi = tret._exact_rows(torch.as_tensor(ue)[rows], torch.as_tensor(ie),
                              torch.as_tensor(rated).long(),
                              torch.as_tensor(excluded), 8, bf16=True)
    tv, ti = tret.retrieval_topk(ue, ie, rated, excluded, 8, device="cpu",
                                 bf16=True)
    np.testing.assert_allclose(fv, tv, rtol=0, atol=1e-5)
    _assert_lists_agree(ue, ie, fi, ti)


KW = dict(n_users=70, n_items=300, n_inter=1400, cold_object="item", seed=71)


@pytest.fixture(scope="module")
def datasets():
    return jsynth(**KW)[0], synthetic_dataset(**KW)[0]


def test_eval_backend_pallas_bf16_matches_jax(datasets):
    """``--eval_backend pallas_bf16``: validation and test lists of shared
    tables through the bf16 route equal the JAX trainer's."""
    jd, td = datasets
    common = dict(model="MF", dataset="synth", bs=256, emb_size=16, seed=5,
                  save_emb=False, eval_backend="pallas_bf16")
    jm = jfactory(JConfig(jargs(**common), jd))
    init = {k: np.asarray(v) for k, v in jm.params.items()}
    tm = MFTrainer(Config(default_args(**common, device="cpu"), td),
                   init_params=init)
    assert eval_backend("pallas_bf16") == tm.eval_backend == "kernel_bf16"
    ue, ie = init["user_emb"], init["item_emb"]
    for setting in ("all", "cold", "warm"):
        for phase, split in (("valid", "val"), ("test", "test")):
            name = {"all": "overall", "cold": "cold", "warm": "warm"}[setting]
            users = td.eval_splits[f"{name}_{split}"].users
            _assert_lists_agree(ue, ie, getattr(tm, phase)(setting),
                                getattr(jm, phase)(setting), users)
    # the bf16 route is a route of its own: fp32 lists differ somewhere
    fp32 = [rec_lists(tm.sweep, "test", s, tm.user_emb, tm.item_emb)
            for s in ("all", "cold", "warm")]
    bf16 = [tm.test(s) for s in ("all", "cold", "warm")]
    assert any((a != b).any() for a, b in zip(fp32, bf16))


def test_server_topk_bf16_matches_jax(datasets, tmp_path):
    jd, td = datasets
    rng = np.random.default_rng(2)
    ue = rng.standard_normal((td.user_num, 16)).astype(np.float32)
    ie = rng.standard_normal((td.item_num, 16)).astype(np.float32)
    jsave(str(tmp_path), "synth", "item", "MF", {"user_emb": ue,
                                                 "item_emb": ie})
    jsrv = JServer.from_checkpoint(str(tmp_path), "synth", "item", "MF",
                                   dataset=jd)
    tsrv = TServer.from_checkpoint(str(tmp_path), "synth", "item", "MF",
                                   dataset=td, device="cpu")
    uids = np.arange(0, td.user_num, 3)
    jv, ji = jsrv.topk(uids, 10, bf16=True, interpret=True)
    tv, ti = tsrv.topk(uids, 10, bf16=True)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
    _assert_lists_agree(ue, ie, ti, ji, uids)
    _, fi = tsrv.topk(uids, 10)
    assert (fi != ti).any()
