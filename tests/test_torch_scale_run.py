"""The port's ``scale_run`` tool held against the JAX package's
``tools/scale_run.py``: the same dataset bytes, the same CLI flags and
backbone-first rule, the same JSON line; its XING build equal to the
tracked JAX dataset. (The tool's runs on the CPU: phase scale's
rehearsal, ``tests/test_torch_scale_phase.py``.)"""
import hashlib
import io
import json
import pickle
import subprocess
from pathlib import Path

import numpy as np
import pytest
import scale_run as jax_scale_run  # tools/ is on sys.path (conftest.py)
from test_torch_threads import torch_threads  # noqa: F401  (autouse)

from coldrec_tpu_torch.data.split import int_csv_bytes
from coldrec_tpu_torch.tools import scale_run as sr

REPO = Path(__file__).resolve().parents[1]
TRACKED = REPO / "tools" / "xing_workdir" / "data" / "xing"
TINY = dict(n_users=300, n_items=200, n_inter=3000, content_dim=16)
JAX_GLOBALS = ("SHAPE", "WORKDIR", "N_USERS", "N_ITEMS", "N_INTER",
               "CONTENT_DIM", "DATASET")
# The numpy whose Generator streams reproduce the tracked XING dataset.
# numpy's streams are not fixed across its releases: under numpy 2.3.5
# ``Generator.zipf`` draws the item ranks otherwise, and the same seeds
# split XING into 2,523,660 warm-train pairs, not 2,524,304.
TRACKED_NUMPY = "2.0.2"


def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _jax_at(monkeypatch, workdir, shape="tiny", counts=TINY):
    """The JAX tool's globals pointed at ``workdir`` and ``counts`` (and
    restored after the test, whatever its ``main`` sets)."""
    for name in JAX_GLOBALS:
        monkeypatch.setattr(jax_scale_run, name, getattr(jax_scale_run, name))
    values = dict(SHAPE=shape, WORKDIR=str(workdir), DATASET=shape,
                  N_USERS=counts["n_users"], N_ITEMS=counts["n_items"],
                  N_INTER=counts["n_inter"],
                  CONTENT_DIM=counts["content_dim"])
    for name, value in values.items():
        monkeypatch.setattr(jax_scale_run, name, value)


def test_shapes_are_the_jax_tools():
    assert sr.SHAPES == jax_scale_run.SHAPES
    assert sr.WARM == jax_scale_run.WARM


@pytest.mark.parametrize("cold_object", ["item", "user"])
def test_tiny_dataset_byte_identical_to_jax_tool(tmp_path, monkeypatch,
                                                 cold_object):
    _jax_at(monkeypatch, tmp_path / "jax")
    jax_scale_run.build_dataset(cold_object=cold_object)
    monkeypatch.setitem(sr.SHAPES, "tiny", TINY)
    stats = sr.build_dataset(str(tmp_path / "port"), "tiny", cold_object)
    assert stats["seconds"] >= 0
    jax_files, port_files = (_files(tmp_path / d) for d in ("jax", "port"))
    assert len(port_files) == 9  # 7 CSVs, info_dict.pkl, the content
    assert port_files == jax_files
    # built once: the marker is there, nothing is written again
    assert sr.build_dataset(str(tmp_path / "port"), "tiny",
                            cold_object) is None


def test_xing_build_equals_tracked_jax_dataset():
    """The XING tier in memory (106,881 x 20,519, content 2,738) against
    the JAX tool's tracked output: info_dict.pkl, the content's sha256 and
    every CSV byte for byte, under the numpy that reproduces it (the
    tiny-shape test above holds the two builds to each other under any
    numpy)."""
    if not (TRACKED / "cold_item" / "info_dict.pkl").exists():
        pytest.skip("tools/xing_workdir is absent from this checkout")
    if np.__version__ != TRACKED_NUMPY:
        pytest.skip(f"the tracked dataset is numpy {TRACKED_NUMPY}'s draw; "
                    f"numpy {np.__version__} may draw another")
    pairs, res, content = sr.build_split("xing")
    assert (pickle.dumps(res.info_dict(), protocol=4)
            == (TRACKED / "cold_item" / "info_dict.pkl").read_bytes())
    buf = io.BytesIO()
    np.save(buf, content)
    tracked = TRACKED / "xing_item_content.npy"
    assert (hashlib.sha256(buf.getvalue()).hexdigest()
            == hashlib.sha256(tracked.read_bytes()).hexdigest())
    for name, arr in (("warm_train", res.warm_train),
                      ("warm_val", res.warm_val),
                      ("warm_test", res.warm_test),
                      ("cold_item_val", res.cold_val),
                      ("cold_item_test", res.cold_test),
                      ("overall_val", res.overall_val),
                      ("overall_test", res.overall_test)):
        assert (b"user,item\n" + int_csv_bytes(arr)
                == (TRACKED / "cold_item" / f"{name}.csv").read_bytes()), name
    # every split goes through the kernel: no user beyond its candidates
    assert np.bincount(res.warm_train[:, 0]).max() == 46
    assert -(-res.warm_train.shape[0] // 4096) == 617


def _stub_runs(monkeypatch, calls):
    """``subprocess.run`` (both tools call it) records its command and
    succeeds."""
    def run(cmd, cwd=None):
        calls.append(list(cmd))
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", run)


def test_run_model_flags_and_json_line_match_jax_tool(tmp_path, monkeypatch,
                                                      capsys):
    """One run of each tool with the CLI stubbed: the same flags to the
    CLI (the program aside), the same JSON line, parsed from the same
    result file."""
    calls = []
    _stub_runs(monkeypatch, calls)
    _jax_at(monkeypatch, tmp_path)
    payload = {"efficiency": {"seconds_per_completed_epoch_mean": 1.25}}
    results = tmp_path / "results"
    results.mkdir()
    (results / "GAR.json").write_text(
        "=== ColdRec Run Result ===\n--- JSON (machine-readable) ---\n"
        + json.dumps(payload, indent=2) + "\n")
    jax_scale_run.run_model("GAR", 3, ["--lr", "0.01"], "item")
    jax_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    line = sr.run_model(str(tmp_path), "tiny", "GAR", 3, ["--lr", "0.01"],
                        "item")
    port_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_cmd, port_cmd = calls
    assert jax_cmd[1].endswith("main.py")
    assert port_cmd[1:3] == ["-m", "coldrec_tpu_torch.main"]
    assert port_cmd[3:] == jax_cmd[2:]
    assert set(port_line) == set(jax_line) == {
        "scale_run", "epochs", "wall_seconds", "sec_per_epoch"}
    assert port_line == line
    assert port_line["sec_per_epoch"] == jax_line["sec_per_epoch"] == 1.25
    assert (port_line["scale_run"], port_line["epochs"]) == ("GAR", 3)


def test_failed_run_exits_like_jax_tool(tmp_path, monkeypatch):
    monkeypatch.setattr(subprocess, "run", lambda cmd, cwd=None:
                        subprocess.CompletedProcess(cmd, 3))
    _jax_at(monkeypatch, tmp_path)
    with pytest.raises(SystemExit, match="GAR run failed rc=3"):
        jax_scale_run.run_model("GAR", 1, [], "item")
    with pytest.raises(SystemExit, match="GAR run failed rc=3"):
        sr.run_model(str(tmp_path), "tiny", "GAR", 1, [], "item")


@pytest.mark.parametrize("model,bus", [("MF", False), ("DropoutNet", False),
                                       ("DropoutNet", True)])
def test_backbone_first_rule_matches_jax_tool(tmp_path, monkeypatch, model,
                                              bus):
    """With the runs and the build stubbed: the runs each tool asks for
    (model, epochs, flags), the port's with ``--device`` added to both."""
    jax_calls, port_calls = [], []
    _jax_at(monkeypatch, tmp_path / "jax")
    monkeypatch.setattr(jax_scale_run, "_set_shape", lambda shape: None)
    monkeypatch.setattr(jax_scale_run, "build_dataset",
                        lambda cold_object="item", seed=7: None)
    monkeypatch.setattr(jax_scale_run, "run_model",
                        lambda *a: jax_calls.append(a) or {})
    monkeypatch.setattr(sr, "build_dataset", lambda *a, **k: None)
    monkeypatch.setattr(sr, "run_model",
                        lambda *a: port_calls.append(a) or {})
    if bus:
        for side in ("jax", "port"):
            emb = tmp_path / side / "emb"
            emb.mkdir(parents=True)
            (emb / "xing_cold_item_MF_emb.npz").write_bytes(b"")
            (emb / "tiny_cold_item_MF_emb.npz").write_bytes(b"")
    argv = ["--model", model, "--epochs", "2", "--backbone_epochs", "3",
            "--shape", "xing", "--lr", "0.01"]
    monkeypatch.setattr("sys.argv", ["scale_run.py", *argv])
    monkeypatch.setattr(jax_scale_run, "DATASET", "xing")
    jax_scale_run.main()
    sr.main(argv + ["--workdir", str(tmp_path / "port"), "--device", "cpu"])
    expect = [(m, e, list(flags)) for m, e, flags, _ in jax_calls]
    got = [(m, e, [f for f in flags if f not in ("--device", "cpu")])
           for _, _, m, e, flags, _ in port_calls]
    assert got == expect
    assert len(got) == (1 if bus or model in sr.WARM else 2)
    assert all(flags[-2:] == ["--device", "cpu"]
               for *_, flags, _ in port_calls)
