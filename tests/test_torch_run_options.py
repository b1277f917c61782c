"""``main.run``'s options for a caller in the same process, on the CPU:
``epoch_steps`` cuts every epoch to its first batches (the same batches,
in the same order, as the whole epoch's), ``data`` hands the run a split
already read (the same results as reading it from the directory), and
``on_model``'s trainer keeps its final three-way test.
"""
import numpy as np
import pytest

from coldrec_tpu_torch import main as tmain
from coldrec_tpu_torch.config import make_args
from coldrec_tpu_torch.data.builder import ColdStartDataset
from coldrec_tpu_torch.data.split import cold_start_split, write_split_dir
from coldrec_tpu_torch.data.synthetic import synthetic_interactions
from coldrec_tpu_torch.runtime.trainer import three_way_test
from test_torch_threads import torch_threads  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    pairs = synthetic_interactions(90, 110, 2200, seed=41)
    res = cold_start_split(pairs, cold_object="item", seed=42)
    write_split_dir(res, str(root), "synthds", "item")
    np.save(root / "synthds" / "synthds_item_content.npy",
            np.random.default_rng(0).standard_normal(
                (res.item_num, 8)).astype(np.float32))
    return str(root)


def _run(split_dir, tmp_path, model, **kw):
    """The CLI's run of ``model``, 2 epochs; returns (payload, trainer)."""
    args = make_args([
        "--model", model, "--dataset", "synthds", "--cold_object", "item",
        "--data_dir", split_dir, "--epochs", "2", "--bs", "256",
        "--emb_size", "8", "--seed", "3", "--save_emb", "false",
        "--result_file", str(tmp_path / "result.txt"), "--device", "cpu"])
    made = []
    payload = tmain.run(args, on_model=made.append, **kw)
    return payload, made[-1]


@pytest.mark.parametrize("model", ["MF", "LightGCN"])
def test_epoch_steps_trains_the_first_batches_of_every_epoch(
        split_dir, tmp_path, model):
    """Every epoch of the cut run trains 3 batches; its first epoch's
    losses are the whole run's first 3, bit for bit; 0 trains whole
    epochs."""
    _, whole = _run(split_dir, tmp_path, model)
    _, cut = _run(split_dir, tmp_path, model, epoch_steps=3)
    _, zero = _run(split_dir, tmp_path, model, epoch_steps=0)
    n = whole.epoch_stats[0]["batches"]
    assert n > 3
    assert [s["batches"] for s in cut.epoch_stats] == [3, 3]
    assert [s["batches"] for s in zero.epoch_stats] == [n, n]
    assert cut.epoch_stats[0]["losses"] == whole.epoch_stats[0]["losses"][:3]
    assert zero.epoch_stats[1]["losses"] == whole.epoch_stats[1]["losses"]


def test_data_read_once_gives_the_run_of_the_split_dir(split_dir, tmp_path):
    """The run handed the split already read equals the run that reads
    it: the same metrics and tables."""
    data = ColdStartDataset.from_split_dir(split_dir, "synthds", "item")
    got, tg = _run(split_dir, tmp_path, "MF", data=data)
    ref, tr = _run(split_dir, tmp_path, "MF")
    assert tg.data is data
    assert got["metrics"] == ref["metrics"]
    np.testing.assert_array_equal(tg.user_emb.numpy(), tr.user_emb.numpy())
    np.testing.assert_array_equal(tg.item_emb.numpy(), tr.item_emb.numpy())


def test_run_keeps_its_three_way_test(split_dir, tmp_path):
    """The trainer keeps its final three-way test: the lists of its tables
    (those of the bus), whose metrics are the ones it reports."""
    _, tm = _run(split_dir, tmp_path, "MF")
    again = three_way_test(tm.data, tm.user_emb, tm.item_emb, topN=tm.topN,
                           backend=tm.eval_backend, device=tm.device,
                           verbose=False)
    for setting, res in again.items():
        np.testing.assert_array_equal(tm.test_results[setting]["rec"],
                                      res["rec"])
    assert tm.test_results["all"]["performance"] == tm.overall_test_results
