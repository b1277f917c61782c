"""Interaction CSV IO (the port's copy of ``coldrec_tpu/data/loader.py``).

Protocol parity: the reference loader (ColdRec util/loader.py:22-33) skips the
header line, coerces user/item ids to int, and forces every rating to 1.0.
Here interactions are represented as an (N, 2) int64 numpy array of raw
``(user, item)`` ids; the implicit rating of 1.0 is a convention of the whole
pipeline, never stored.

Parsing is the host library's C++ parser (``native.parse_interactions_native``,
a copy of the JAX package's), as the JAX loader parses wherever its library
loads. Where the parser and ``np.loadtxt`` read a file differently (a ``-``
or ``.`` in an id, a CR before the newline, blank lines) the arrays follow
the parser. There is no ``np.loadtxt`` fallback: the host library is built
from source at first use, and a failed build raises.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np


def load_interaction_csv(path: str) -> np.ndarray:
    """Load a ``user,item[,...]`` CSV (header skipped) -> (N, 2) int64 array."""
    from .. import native

    out = native.parse_interactions_native(path)
    if out.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    return out


SPLIT_FILES = (
    "warm_train",
    "warm_val",
    "warm_test",
    "overall_val",
    "overall_test",
)


def load_split_dir(
    data_dir: str, dataset: str, cold_object: str
) -> Dict[str, object]:
    """Load the 7 split CSVs + info_dict + content for one prepared dataset.

    Mirrors the file layout the reference CLI consumes (ColdRec main.py:28-53):
    ``<data_dir>/<dataset>/cold_<obj>/{warm_train,warm_val,warm_test,
    cold_<obj>_val,cold_<obj>_test,overall_val,overall_test}.csv`` plus
    ``info_dict.pkl`` and ``<data_dir>/<dataset>/<dataset>_<obj>_content.npy``.
    """
    base = os.path.join(data_dir, dataset, f"cold_{cold_object}")
    splits = {}
    for name in SPLIT_FILES:
        splits[name] = load_interaction_csv(os.path.join(base, f"{name}.csv"))
    splits["cold_val"] = load_interaction_csv(
        os.path.join(base, f"cold_{cold_object}_val.csv")
    )
    splits["cold_test"] = load_interaction_csv(
        os.path.join(base, f"cold_{cold_object}_test.csv")
    )
    with open(os.path.join(base, "info_dict.pkl"), "rb") as f:
        info = pickle.load(f)

    user_content: Optional[np.ndarray] = None
    item_content: Optional[np.ndarray] = None
    content_path = os.path.join(
        data_dir, dataset, f"{dataset}_{cold_object}_content.npy"
    )
    if cold_object == "user":
        user_content = np.load(content_path)
    else:
        item_content = np.load(content_path)

    return {
        "training": splits["warm_train"],
        "warm_val": splits["warm_val"],
        "warm_test": splits["warm_test"],
        "cold_val": splits["cold_val"],
        "cold_test": splits["cold_test"],
        "overall_val": splits["overall_val"],
        "overall_test": splits["overall_test"],
        "user_num": int(info["user_num"]),
        "item_num": int(info["item_num"]),
        "warm_user": np.asarray(info["warm_user"], dtype=np.int64),
        "warm_item": np.asarray(info["warm_item"], dtype=np.int64),
        "cold_user": np.asarray(info["cold_user"], dtype=np.int64),
        "cold_item": np.asarray(info["cold_item"], dtype=np.int64),
        "user_content": user_content,
        "item_content": item_content,
    }
