"""Port serving vs the JAX package on shared tables: ``RetrievalServer``
answers must equal the JAX server's (mapped and raw ids, rated and
candidate masks, the heavy-rated route). Integer-valued tables keep every
score exact in both frameworks."""
import numpy as np
import pytest

from coldrec_tpu.data.synthetic import synthetic_dataset as jsynth
from coldrec_tpu.runtime.checkpoints import save_embeddings as jsave
from coldrec_tpu.runtime.serving import RetrievalServer as JServer
from coldrec_tpu_torch.data.synthetic import synthetic_dataset as tsynth
from coldrec_tpu_torch.runtime.serving import RetrievalServer as TServer
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

K = 7
D = 8


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    kw = dict(n_users=80, n_items=300, n_inter=2500, cold_object="item",
              seed=11)
    jd, _ = jsynth(**kw)
    td, _ = tsynth(**kw)
    rng = np.random.default_rng(3)
    ue = rng.integers(-3, 4, (jd.user_num, D)).astype(np.float32)
    ie = rng.integers(-3, 4, (jd.item_num, D)).astype(np.float32)
    emb_dir = str(tmp_path_factory.mktemp("emb"))
    jsave(emb_dir, "synth", "item", "MF", {"user_emb": ue, "item_emb": ie})
    return jd, td, ue, ie, emb_dir


def test_server_from_jax_checkpoint_matches_jax(setup):
    jd, td, ue, ie, emb_dir = setup
    jsrv = JServer.from_checkpoint(emb_dir, "synth", "item", "MF", dataset=jd)
    tsrv = TServer.from_checkpoint(emb_dir, "synth", "item", "MF",
                                   dataset=td, device="cpu")
    uids = np.random.default_rng(4).integers(0, jd.user_num, 33)
    jv, ji = jsrv.topk(uids, K, interpret=True)
    tv, ti = tsrv.topk(uids, K)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    for r, u in enumerate(uids):
        assert not set(ti[r]) & set(td.user_rated_slice(int(u)).tolist())


def test_server_candidate_mask_without_rated(setup):
    jd, td, ue, ie, _ = setup
    banned = np.arange(0, jd.item_num, 3)
    jsrv = JServer(ue, ie, dataset=jd, exclude_items=banned)
    tsrv = TServer(ue, ie, dataset=td, exclude_items=banned, device="cpu")
    uids = np.arange(16)
    _, ji = jsrv.topk(uids, K, exclude_rated=False, interpret=True)
    _, ti = tsrv.topk(uids, K, exclude_rated=False)
    np.testing.assert_array_equal(ti, ji)
    assert not set(ti.ravel().tolist()) & set(banned.tolist())


def test_server_raw_ids_match_jax(setup):
    jd, td, ue, ie, _ = setup
    jsrv = JServer(ue, ie, dataset=jd)
    tsrv = TServer(ue, ie, dataset=td, device="cpu")
    raw_users = td.id2user[[0, 5, 17, 40]]
    _, ji = jsrv.topk(raw_users, K, raw_ids=True, interpret=True)
    _, ti = tsrv.topk(raw_users, K, raw_ids=True)
    np.testing.assert_array_equal(ti, ji)
    _, mapped = tsrv.topk(td.map_users(raw_users), K)
    np.testing.assert_array_equal(ti, td.id2item[mapped])
    with pytest.raises(ValueError):
        TServer(ue, ie, device="cpu").topk(raw_users, K, raw_ids=True)


def test_server_heavy_rated_route_matches_jax():
    """A user with more than 1024 - k rated items leaves the kernel path
    (k + R > 1024) in both packages; the lists still agree."""
    rng = np.random.default_rng(6)
    n_items = 3000
    heavy = np.stack([np.zeros(2500, np.int64),
                      rng.choice(n_items, 2500, replace=False)], axis=1)
    rest = np.stack([rng.integers(1, 60, 3000),
                     rng.integers(0, n_items, 3000)], axis=1)
    extra = np.stack([rng.integers(0, 60, n_items), np.arange(n_items)], 1)
    pairs = np.concatenate([heavy, rest, extra]).astype(np.int64)
    from coldrec_tpu.data import builder as jb, split as js
    from coldrec_tpu_torch.data import builder as tb, split as ts

    def build(split, builder):
        r = split.cold_start_split(pairs, cold_object="item", seed=2)
        return builder.ColdStartDataset(
            training=r.warm_train, warm_val=r.warm_val, cold_val=r.cold_val,
            overall_val=r.overall_val, warm_test=r.warm_test,
            cold_test=r.cold_test, overall_test=r.overall_test,
            user_num=r.user_num, item_num=r.item_num, warm_user=r.warm_user,
            warm_item=r.warm_item, cold_user=r.cold_user,
            cold_item=r.cold_item)

    jd, td = build(js, jb), build(ts, tb)
    assert td.max_rated + K > 1024
    ue = rng.integers(-3, 4, (td.user_num, D)).astype(np.float32)
    ie = rng.integers(-3, 4, (td.item_num, D)).astype(np.float32)
    uids = np.arange(12)
    _, ji = JServer(ue, ie, dataset=jd).topk(uids, K, interpret=True)
    _, ti = TServer(ue, ie, dataset=td, device="cpu").topk(uids, K)
    np.testing.assert_array_equal(ti, ji)
