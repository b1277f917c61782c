"""Port host layer vs the JAX package: bit-identical splits, id remap,
eval-split ground truth, rated masks, candidate masks, metrics, the split
directory round trip, the npz checkpoint bus and the MF weight carrier."""
import os

import numpy as np
import pytest
import torch

from coldrec_tpu.data import builder as jbuilder
from coldrec_tpu.data import split as jsplit
from coldrec_tpu.data import synthetic as jsynth
from coldrec_tpu.runtime import checkpoints as jckpt
from coldrec_tpu.utils import metrics as jmetrics
from coldrec_tpu_torch.data import builder as tbuilder
from coldrec_tpu_torch.data import loader as tloader
from coldrec_tpu_torch.data import split as tsplit
from coldrec_tpu_torch.data import synthetic as tsynth
from coldrec_tpu_torch.runtime import checkpoints as tckpt
from coldrec_tpu_torch.utils import metrics as tmetrics
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

SPLIT_FIELDS = ("warm_train", "warm_val", "warm_test", "cold_val",
                "cold_test", "overall_val", "overall_test", "warm_user",
                "warm_item", "cold_user", "cold_item")


def _datasets(cold_object, seed=5):
    kw = dict(n_users=120, n_items=90, n_inter=3000, cold_object=cold_object,
              seed=seed)
    return jsynth.synthetic_dataset(**kw), tsynth.synthetic_dataset(**kw)


@pytest.mark.parametrize("cold_object", ["item", "user"])
def test_split_bit_identical(cold_object):
    pairs = jsynth.synthetic_interactions(150, 100, 4000, seed=3)
    np.testing.assert_array_equal(
        pairs, tsynth.synthetic_interactions(150, 100, 4000, seed=3))
    a = jsplit.cold_start_split(pairs, cold_object=cold_object, seed=9)
    b = tsplit.cold_start_split(pairs, cold_object=cold_object, seed=9)
    for f in SPLIT_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.user_num, a.item_num) == (b.user_num, b.item_num)


@pytest.mark.parametrize("cold_object", ["item", "user"])
def test_dataset_remap_and_eval_splits_identical(cold_object):
    (jd, _), (td, _) = _datasets(cold_object)
    np.testing.assert_array_equal(jd.id2user, td.id2user)
    np.testing.assert_array_equal(jd.id2item, td.id2item)
    for name in jbuilder.SPLIT_ORDER:
        np.testing.assert_array_equal(jd.splits[name], td.splits[name])
    for name in jbuilder.EVAL_SPLITS:
        a, b = jd.eval_splits[name], td.eval_splits[name]
        np.testing.assert_array_equal(a.users, b.users)
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.items, b.items)
    for attr in ("train_indptr", "train_items_sorted", "mapped_warm_user_idx",
                 "mapped_warm_item_idx", "mapped_cold_user_idx",
                 "mapped_cold_item_idx"):
        np.testing.assert_array_equal(getattr(jd, attr), getattr(td, attr))
    content = "user_content" if cold_object == "user" else "item_content"
    np.testing.assert_array_equal(getattr(jd, content), getattr(td, content))
    raw = jd.id2user[[0, 3, 7]]
    np.testing.assert_array_equal(jd.map_users(raw), td.map_users(raw))
    with pytest.raises(KeyError):
        td.map_users(np.array([10 ** 6]))


def test_rated_padded_and_candidate_mask_identical():
    (jd, _), (td, _) = _datasets("item")
    users = np.arange(jd.user_num, dtype=np.int32)[::-1]
    np.testing.assert_array_equal(jd.rated_padded(users),
                                  td.rated_padded(users))
    for data_type in ("all", "cold", "warm"):
        a = jd.candidate_mask("item", data_type)
        b = td.candidate_mask("item", data_type)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert td.candidate_mask("user", "warm") is None


def test_ranking_evaluation_identical(rng):
    n_users, n_items = 60, 80
    counts = rng.integers(0, 6, n_users)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    items = np.concatenate(
        [rng.choice(n_items, c, replace=False) for c in counts])
    rec = np.stack([rng.permutation(n_items)[:20] for _ in range(n_users)])
    a = jmetrics.ranking_evaluation(indptr, items, rec, [5, 10, 20], n_items)
    b = tmetrics.ranking_evaluation(indptr, items, rec, [5, 10, 20], n_items)
    assert a == b


def test_split_dir_round_trip(tmp_path):
    """A split directory the JAX package writes loads in the port (its C++
    parser) into the dataset the JAX package builds in memory."""
    pairs = jsynth.synthetic_interactions(100, 70, 2500, seed=4)
    res = jsplit.cold_start_split(pairs, cold_object="item", seed=1)
    jsplit.write_split_dir(res, str(tmp_path), "demo", "item")
    content = np.random.default_rng(2).standard_normal(
        (res.item_num, 6)).astype(np.float32)
    np.save(tmp_path / "demo" / "demo_item_content.npy", content)
    td = tbuilder.ColdStartDataset.from_split_dir(str(tmp_path), "demo",
                                                  "item")
    np.testing.assert_array_equal(
        tloader.load_interaction_csv(
            str(tmp_path / "demo" / "cold_item" / "warm_train.csv")),
        res.warm_train)
    jd = jbuilder.ColdStartDataset(
        training=res.warm_train, warm_val=res.warm_val, cold_val=res.cold_val,
        overall_val=res.overall_val, warm_test=res.warm_test,
        cold_test=res.cold_test, overall_test=res.overall_test,
        user_num=res.user_num, item_num=res.item_num,
        warm_user=res.warm_user, warm_item=res.warm_item,
        cold_user=res.cold_user, cold_item=res.cold_item,
        item_content=content,
    )
    np.testing.assert_array_equal(jd.id2item, td.id2item)
    np.testing.assert_array_equal(jd.item_content, td.item_content)
    users = np.arange(jd.user_num)
    np.testing.assert_array_equal(jd.rated_padded(users),
                                  td.rated_padded(users))


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_bus_jax_writes_port_reads(tmp_path, rng, fmt):
    tensors = {
        "user_emb": rng.standard_normal((7, 4)).astype(np.float32),
        "item_emb": rng.standard_normal((9, 4)).astype(np.float32),
        "W": rng.standard_normal((3, 4)).astype(np.float32),
    }
    jckpt.save_embeddings(str(tmp_path), "ds", "item", "MF", tensors,
                          fmt=fmt)
    got = tckpt.load_embeddings(str(tmp_path), "ds", "item", "MF")
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        np.testing.assert_array_equal(got[k], v)


def test_bus_port_writes_jax_reads(tmp_path, rng):
    ue = torch.as_tensor(rng.standard_normal((5, 3)).astype(np.float32))
    ie = rng.standard_normal((6, 3)).astype(np.float32)
    path = tckpt.save_embeddings(str(tmp_path), "ds", "user", "MF",
                                 {"user_emb": ue, "item_emb": ie}, fmt="both")
    assert os.path.basename(path) == "ds_cold_user_MF_emb.npz"
    got = jckpt.load_embeddings(str(tmp_path), "ds", "user", "MF")
    np.testing.assert_array_equal(got["user_emb"], ue.numpy())
    np.testing.assert_array_equal(got["item_emb"], ie)
    os.remove(path)  # the .pt files alone still serve both packages
    got = tckpt.load_embeddings(str(tmp_path), "ds", "user", "MF")
    np.testing.assert_array_equal(got["item_emb"], ie)
    with pytest.raises(FileNotFoundError):
        tckpt.load_embeddings(str(tmp_path), "ds", "item", "MF")
    with pytest.raises(ValueError):
        tckpt.save_embeddings(str(tmp_path), "ds", "item", "MF", {}, fmt="h5")


def test_mf_from_jax_params_reproduces_tables():
    from coldrec_tpu.config import default_args
    from coldrec_tpu.models import model_factory
    from coldrec_tpu.runtime.trainer import Config
    from coldrec_tpu_torch.models.mf import MF

    data, _ = jsynth.synthetic_dataset(n_users=50, n_items=40, n_inter=900,
                                       seed=2)
    args = default_args(model="MF", dataset="synth", epochs=0, emb_size=8,
                        seed=3)
    jmf = model_factory(Config(args, data))
    params = {k: np.asarray(v) for k, v in jmf.params.items()}
    mf = MF.from_jax_params(params, device="cpu")
    ue, ie = mf.forward_tables()
    np.testing.assert_array_equal(ue.detach().numpy(), params["user_emb"])
    np.testing.assert_array_equal(ie.detach().numpy(), params["item_emb"])
    users = np.array([0, 4, 9], np.int32)
    ju, ji = (np.asarray(t) for t in jmf.forward_tables(jmf.params))
    np.testing.assert_allclose(
        (ue[torch.as_tensor(users).long()] @ ie.T).detach().numpy(),
        ju[users] @ ji.T, rtol=1e-6, atol=1e-7)


def test_mf_init_is_seeded_xavier():
    from coldrec_tpu_torch.models.mf import MF

    a = MF(300, 500, emb_size=16, seed=1, device="cpu")
    b = MF(300, 500, emb_size=16, seed=1, device="cpu")
    torch.testing.assert_close(a.item_emb, b.item_emb, rtol=0, atol=0)
    for table, rows in ((a.user_emb.detach(), 300), (a.item_emb.detach(), 500)):
        limit = float(np.sqrt(6.0 / (rows + 16)))
        assert table.shape == (rows, 16)
        assert float(table.abs().max()) <= limit
        assert float(table.abs().max()) > 0.9 * limit
