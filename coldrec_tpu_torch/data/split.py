"""Offline warm/cold split protocol (library + CLI).

The port's own copy of ``coldrec_tpu/data/split.py``: numpy only, so the
same pairs and seed give bit-identical splits in both packages.

Rebuild of the reference's one-time dataset prep (ColdRec data/split.py and
data/convert.py) as pure functions over numpy arrays:

  * group interactions by the cold object, shuffle groups, take
    ``warm_ratio`` of groups as warm (split.py:66-74);
  * split warm records 0.8/0.1/0.1 into train/val/test (split.py:84-91) with
    the "leakage repair" pass that moves val/test records whose user or item
    never appears in train back into train (split.py:94-124);
  * split cold groups 50/50 into cold-val / cold-test **by group**
    (split.py:144-151);
  * overall val/test = concat(cold, warm) filtered to warm-side entities
    present in both (convert.py:60-72);
  * emit the info arrays (warm/cold user/item ids, counts) that the reference
    pickles into ``info_dict.pkl`` (convert.py:116-143).

The reference performs these steps with pandas groupby + python set algebra;
this rebuild uses vectorized numpy throughout but preserves the record-level
semantics (group membership, repair rules, filters). RNG streams differ, so
concrete splits are not bit-identical to a reference run — the protocol is.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass
class SplitResult:
    warm_train: np.ndarray
    warm_val: np.ndarray
    warm_test: np.ndarray
    cold_val: np.ndarray
    cold_test: np.ndarray
    overall_val: np.ndarray
    overall_test: np.ndarray
    user_num: int
    item_num: int
    warm_user: np.ndarray
    warm_item: np.ndarray
    cold_user: np.ndarray
    cold_item: np.ndarray

    def info_dict(self) -> Dict[str, object]:
        """The reference's info_dict.pkl payload (convert.py:116-143 subset)."""
        return {
            "user_num": self.user_num,
            "item_num": self.item_num,
            "user_array": np.arange(self.user_num, dtype=np.int32),
            "item_array": np.arange(self.item_num, dtype=np.int32),
            "warm_user": self.warm_user.astype(np.int32),
            "warm_item": self.warm_item.astype(np.int32),
            "cold_user": self.cold_user.astype(np.int32),
            "cold_item": self.cold_item.astype(np.int32),
        }


def _dedup(pairs: np.ndarray) -> np.ndarray:
    """Drop duplicate (user, item) pairs keeping first occurrence."""
    key = pairs[:, 0].astype(np.int64) * (pairs[:, 1].max(initial=0) + 1) + pairs[:, 1]
    _, idx = np.unique(key, return_index=True)
    idx.sort()
    return pairs[idx]


def _leakage_repair(
    pairs: np.ndarray, train_mask: np.ndarray, move_mask: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Move records from a held-out subset into train if their user or item is
    absent from train (split.py:94-124). Two passes: users then items."""
    for col in (0, 1):
        train_entities = np.unique(pairs[train_mask, col])
        held = np.where(move_mask)[0]
        missing = held[~np.isin(pairs[held, col], train_entities)]
        move_mask[missing] = False
        train_mask[missing] = True
    return train_mask, move_mask


def cold_start_split(
    pairs: np.ndarray,
    cold_object: str = "item",
    warm_ratio: float = 0.8,
    warm_split=(0.8, 0.1, 0.1),
    cold_split=(0.5, 0.5),
    seed: int = 42,
) -> SplitResult:
    pairs = _dedup(np.asarray(pairs, dtype=np.int64).reshape(-1, 2))
    rng = np.random.default_rng(seed)
    user_num = int(pairs[:, 0].max()) + 1
    item_num = int(pairs[:, 1].max()) + 1
    obj_col = 1 if cold_object == "item" else 0

    # ---- warm/cold group split (split.py:66-74) ----
    obj_ids = np.unique(pairs[:, obj_col])
    rng.shuffle(obj_ids)
    n_warm_group = int(warm_ratio * len(obj_ids))
    warm_objs = obj_ids[:n_warm_group]
    warm_obj_set = np.zeros(max(user_num, item_num), dtype=bool)
    warm_obj_set[warm_objs] = True
    is_warm = warm_obj_set[pairs[:, obj_col]]
    warm_pairs_idx = np.where(is_warm)[0]
    cold_pairs_idx = np.where(~is_warm)[0]

    # ---- warm subset 0.8/0.1/0.1 with leakage repair (split.py:84-124) ----
    n_warm = warm_pairs_idx.shape[0]
    n_val = int(warm_split[1] * n_warm)
    n_test = int(warm_split[2] * n_warm)
    perm = rng.permutation(n_warm)
    shuffled = warm_pairs_idx[perm]
    n_train = n_warm - n_val - n_test
    role = np.zeros(pairs.shape[0], dtype=np.int8)  # 0 other,1 train,2 val,3 test
    role[shuffled[:n_train]] = 1
    role[shuffled[n_train : n_train + n_val]] = 2
    role[shuffled[n_warm - n_test :]] = 3

    train_mask = role == 1
    val_mask = role == 2
    train_mask, val_mask = _leakage_repair(pairs, train_mask, val_mask)
    test_mask = role == 3
    train_mask, test_mask = _leakage_repair(pairs, train_mask, test_mask)

    warm_train = pairs[train_mask]
    warm_val = pairs[val_mask]
    warm_test = pairs[test_mask]

    # ---- cold subset 50/50 by group (split.py:144-151) ----
    cold_pairs = pairs[cold_pairs_idx]
    cold_objs = np.unique(cold_pairs[:, obj_col])
    rng.shuffle(cold_objs)
    n_cval_group = int(cold_split[0] * len(cold_objs))
    cval_objs = np.zeros(max(user_num, item_num), dtype=bool)
    cval_objs[cold_objs[:n_cval_group]] = True
    in_cval = cval_objs[cold_pairs[:, obj_col]]
    cold_val = cold_pairs[in_cval]
    cold_test = cold_pairs[~in_cval]

    # ---- overall val/test (convert.py:60-72) ----
    warm_col = 0 if cold_object == "item" else 1
    ov_shared = np.intersect1d(cold_val[:, warm_col], warm_val[:, warm_col])
    overall_val = np.concatenate([cold_val, warm_val])
    overall_val = overall_val[np.isin(overall_val[:, warm_col], ov_shared)]
    ot_shared = np.intersect1d(cold_test[:, warm_col], warm_test[:, warm_col])
    overall_test = np.concatenate([cold_test, warm_test])
    overall_test = overall_test[np.isin(overall_test[:, warm_col], ot_shared)]

    return SplitResult(
        warm_train=warm_train,
        warm_val=warm_val,
        warm_test=warm_test,
        cold_val=cold_val,
        cold_test=cold_test,
        overall_val=overall_val,
        overall_test=overall_test,
        user_num=user_num,
        item_num=item_num,
        warm_user=np.unique(warm_train[:, 0]),
        warm_item=np.unique(warm_train[:, 1]),
        cold_user=np.unique(cold_pairs[:, 0]),
        cold_item=np.unique(cold_pairs[:, 1]),
    )


def int_csv_bytes(arr) -> bytes:
    """The bytes ``np.savetxt(f, arr, fmt="%d", delimiter=",")`` writes for
    an integer (or bool) array, one row a line (a 1-D array as one column),
    from whole-array numpy operations: every cell is written right-aligned
    in the widest cell's places and followed by its comma (a row's last
    cell by the newline), and the places left of each cell's text are
    dropped. ``np.savetxt`` formats row by row in Python, ~4 µs a row."""
    a = np.asarray(arr)
    if a.ndim == 1:
        a = a[:, None]
    if a.ndim != 2:
        raise ValueError(f"a 1-D or 2-D array, got shape {a.shape}")
    if a.dtype.kind not in "biu":
        raise TypeError(f"an integer array, got {a.dtype}")
    n, m = a.shape
    if n == 0 or m == 0:
        return b"\n" * n
    if a.dtype.kind == "u":
        mag, neg = a.astype(np.uint64).ravel(), np.zeros(n * m, bool)
    else:
        s = a.astype(np.int64).ravel()
        neg = s < 0
        # -(-2**63) wraps to itself; as uint64 it is 2**63, the magnitude
        mag = np.where(neg, -s, s).astype(np.uint64)
    top = int(mag.max())
    kind = (np.int32 if top < 2**31 else np.int64 if top < 2**63
            else np.uint64)
    mag = mag.astype(kind)
    wide = len(str(top)) + bool(neg.any())
    # one plane per place (then the separator), cells along the rows
    planes = np.empty((wide + 1, n * m), np.uint8)
    planes[wide].reshape(n, m)[:] = ord(",")
    planes[wide].reshape(n, m)[:, -1] = ord("\n")
    left, ten = mag, kind(10)
    for place in range(wide - 1, -1, -1):
        q = left // ten
        planes[place] = (left - q * ten).astype(np.uint8) + ord("0")
        left = q
    digits = np.ones(n * m, np.int64)
    for place in range(1, len(str(top))):
        digits += mag >= kind(10 ** place)
    start = wide - digits - neg  # each cell's first place
    sign = np.flatnonzero(neg)
    planes[start[sign], sign] = ord("-")
    chars = np.ascontiguousarray(planes.T)  # (cells, places + separator)
    keep = np.arange(wide + 1)[None, :] >= np.arange(wide + 1)[:, None]
    return chars[keep[start]].tobytes()


def write_split_dir(
    result: SplitResult, data_dir: str, dataset: str, cold_object: str
) -> str:
    """Write the 7 CSVs + info_dict.pkl in the reference file layout, each
    CSV byte for byte what ``np.savetxt(fmt="%d", delimiter=",")`` writes
    (:func:`int_csv_bytes`)."""
    base = os.path.join(data_dir, dataset, f"cold_{cold_object}")
    os.makedirs(base, exist_ok=True)

    def _write(name: str, arr: np.ndarray):
        path = os.path.join(base, f"{name}.csv")
        with open(path, "wb") as f:
            f.write(b"user,item\n")
            f.write(int_csv_bytes(arr))

    _write("warm_train", result.warm_train)
    _write("warm_val", result.warm_val)
    _write("warm_test", result.warm_test)
    _write(f"cold_{cold_object}_val", result.cold_val)
    _write(f"cold_{cold_object}_test", result.cold_test)
    _write("overall_val", result.overall_val)
    _write("overall_test", result.overall_test)
    with open(os.path.join(base, "info_dict.pkl"), "wb") as f:
        pickle.dump(result.info_dict(), f, protocol=4)
    return base


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="ColdRec-protocol dataset split")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--datadir", type=str, default="./data")
    p.add_argument("--warm_ratio", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--cold_object", type=str, default="item", choices=["user", "item"])
    args = p.parse_args(argv)
    src = os.path.join(args.datadir, args.dataset, f"{args.dataset}.csv")
    pairs = np.loadtxt(src, delimiter=",", skiprows=1, usecols=(0, 1), dtype=np.int64)
    res = cold_start_split(
        pairs, cold_object=args.cold_object, warm_ratio=args.warm_ratio, seed=args.seed
    )
    out = write_split_dir(res, args.datadir, args.dataset, args.cold_object)
    print(f"split written to {out}")


if __name__ == "__main__":
    main()
