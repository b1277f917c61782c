"""ColdStartDataset — the central host-side data object.

The port's copy of ``coldrec_tpu/data/builder.py``.

A vectorized, static-shape rebuild of the reference's ``ColdStartDataBuilder``
(ColdRec util/databuilder.py:6-385). Protocol-critical semantics preserved:

  * **First-seen id remap** (databuilder.py:90-218): raw user/item ids are
    mapped to dense contiguous ids in order of first appearance while
    scanning the splits in the fixed order
    train -> warm_val -> warm_test -> cold_val -> cold_test ->
    overall_val -> overall_test. Here the scan is a vectorized
    ``np.unique(return_index)`` + stable argsort instead of python dicts.
  * **Content remap** (databuilder.py:45-71): content rows are permuted into
    mapped-id order. Divergence (documented): rows for entities never seen in
    any split are zero-filled; the reference leaves them uninitialized
    (``np.empty``), which is nondeterministic garbage.
  * **Graphs** (databuilder.py:220-275): symmetric-normalized bipartite
    adjacency D^-1/2 (A+A^T) D^-1/2 over (user_num+item_num) nodes and the
    user x item interaction CSR, emitted as row-sorted COO index/value
    arrays (``ops/spmm.py`` turns them into the ELL + COO device layout).
  * **Warm/cold id arrays** (databuilder.py:76-83): both raw ("source") and
    mapped index arrays; unknown ids raise, matching get_user_id_list.

Everything here is host-side numpy and scipy — one-time preprocessing, bit
for bit the JAX package's. Tensors are produced on demand by the
runtime/eval layers and ``ops/spmm.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp

# Reference iteration order of generate_set (databuilder.py:90-218).
SPLIT_ORDER = (
    "training",
    "warm_val",
    "warm_test",
    "cold_val",
    "cold_test",
    "overall_val",
    "overall_test",
)

EVAL_SPLITS = (
    "warm_val",
    "warm_test",
    "cold_val",
    "cold_test",
    "overall_val",
    "overall_test",
)


def first_seen_order(ids: np.ndarray) -> np.ndarray:
    """Unique values of ``ids`` in order of first appearance."""
    if ids.size == 0:
        return ids.copy()
    uniq, first_idx = np.unique(ids, return_index=True)
    return uniq[np.argsort(first_idx, kind="stable")]


@dataclass
class EvalSplit:
    """Ground-truth of one evaluation split in mapped-id space.

    ``users`` preserves the reference's per-split dict insertion order
    (first appearance within that split's records). ``indptr``/``items``
    form a CSR over those users; item lists are unique per user.
    """

    users: np.ndarray  # (n_users,) mapped user ids, first-seen order
    indptr: np.ndarray  # (n_users + 1,)
    items: np.ndarray  # (nnz,) mapped item ids

    @property
    def n_users(self) -> int:
        return int(self.users.shape[0])

    @property
    def n_interactions(self) -> int:
        return int(self.items.shape[0])

    def gt_counts(self) -> np.ndarray:
        return np.diff(self.indptr)


def _build_eval_split(pairs: np.ndarray) -> EvalSplit:
    """CSR ground truth keyed by first-seen user order, unique items per user."""
    if pairs.shape[0] == 0:
        return EvalSplit(
            users=np.zeros(0, np.int64),
            indptr=np.zeros(1, np.int64),
            items=np.zeros(0, np.int64),
        )
    users_order = first_seen_order(pairs[:, 0])
    # rank of each user in first-seen order
    order_pos = np.empty(int(users_order.max()) + 1, dtype=np.int64)
    order_pos[users_order] = np.arange(users_order.shape[0])
    row = order_pos[pairs[:, 0]]
    # unique (row, item) pairs; duplicates collapse as in dict-of-dict storage
    key = row * (pairs[:, 1].max() + 1) + pairs[:, 1]
    _, uniq_idx = np.unique(key, return_index=True)
    uniq_idx.sort()
    row_u = row[uniq_idx]
    items_u = pairs[uniq_idx, 1]
    sort = np.argsort(row_u, kind="stable")
    row_s, items_s = row_u[sort], items_u[sort]
    counts = np.bincount(row_s, minlength=users_order.shape[0])
    indptr = np.zeros(users_order.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return EvalSplit(users=users_order, indptr=indptr, items=items_s.astype(np.int64))


@dataclass
class SparseGraphHost:
    """COO sparse matrix as flat arrays (host-side, ready for device)."""

    rows: np.ndarray  # int32
    cols: np.ndarray  # int32
    vals: np.ndarray  # float32
    shape: Tuple[int, int]

    @classmethod
    def from_scipy(cls, mat: sp.spmatrix) -> "SparseGraphHost":
        coo = mat.tocoo()
        # rows ascending (stable), as the device layout expects
        order = np.argsort(coo.row, kind="stable")
        return cls(
            rows=coo.row[order].astype(np.int32),
            cols=coo.col[order].astype(np.int32),
            vals=coo.data[order].astype(np.float32),
            shape=tuple(mat.shape),
        )

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])


class ColdStartDataset:
    """Mapped-id dataset with the eval, rated-mask and graph structures."""

    def __init__(
        self,
        training: np.ndarray,
        warm_val: np.ndarray,
        cold_val: np.ndarray,
        overall_val: np.ndarray,
        warm_test: np.ndarray,
        cold_test: np.ndarray,
        overall_test: np.ndarray,
        user_num: int,
        item_num: int,
        warm_user: np.ndarray,
        warm_item: np.ndarray,
        cold_user: np.ndarray,
        cold_item: np.ndarray,
        user_content: Optional[np.ndarray] = None,
        item_content: Optional[np.ndarray] = None,
    ):
        self.user_num = int(user_num)
        self.item_num = int(item_num)
        raw_splits: Dict[str, np.ndarray] = {
            "training": np.asarray(training, dtype=np.int64).reshape(-1, 2),
            "warm_val": np.asarray(warm_val, dtype=np.int64).reshape(-1, 2),
            "warm_test": np.asarray(warm_test, dtype=np.int64).reshape(-1, 2),
            "cold_val": np.asarray(cold_val, dtype=np.int64).reshape(-1, 2),
            "cold_test": np.asarray(cold_test, dtype=np.int64).reshape(-1, 2),
            "overall_val": np.asarray(overall_val, dtype=np.int64).reshape(-1, 2),
            "overall_test": np.asarray(overall_test, dtype=np.int64).reshape(-1, 2),
        }
        self.raw_splits = raw_splits

        # ---- first-seen id remap over the fixed split order ----
        all_users = np.concatenate([raw_splits[s][:, 0] for s in SPLIT_ORDER])
        all_items = np.concatenate([raw_splits[s][:, 1] for s in SPLIT_ORDER])
        self._user_order = first_seen_order(all_users)  # raw ids, mapped order
        self._item_order = first_seen_order(all_items)
        self.n_seen_users = int(self._user_order.shape[0])
        self.n_seen_items = int(self._item_order.shape[0])

        max_raw_u = int(max(all_users.max(initial=0), self.user_num - 1))
        max_raw_i = int(max(all_items.max(initial=0), self.item_num - 1))
        self._user_map = np.full(max_raw_u + 1, -1, dtype=np.int64)
        self._user_map[self._user_order] = np.arange(self.n_seen_users)
        self._item_map = np.full(max_raw_i + 1, -1, dtype=np.int64)
        self._item_map[self._item_order] = np.arange(self.n_seen_items)

        # mapped splits
        self.splits: Dict[str, np.ndarray] = {}
        for name in SPLIT_ORDER:
            pairs = raw_splits[name]
            mapped = np.stack(
                [self._user_map[pairs[:, 0]], self._item_map[pairs[:, 1]]], axis=1
            )
            self.splits[name] = mapped.astype(np.int64)
        self.train_pairs = self.splits["training"]
        self.n_train = int(self.train_pairs.shape[0])

        # ---- content remap (databuilder.py:45-71); unseen rows zeroed ----
        self.user_content = self._remap_content(
            user_content, self._user_order, self.user_num
        )
        self.item_content = self._remap_content(
            item_content, self._item_order, self.item_num
        )
        self.user_content_dim = (
            int(self.user_content.shape[1]) if self.user_content is not None else 0
        )
        self.item_content_dim = (
            int(self.item_content.shape[1]) if self.item_content is not None else 0
        )

        # ---- warm/cold id arrays, raw + mapped (databuilder.py:76-83) ----
        self.source_warm_user_idx = np.asarray(warm_user, dtype=np.int64)
        self.source_warm_item_idx = np.asarray(warm_item, dtype=np.int64)
        self.source_cold_user_idx = np.asarray(cold_user, dtype=np.int64)
        self.source_cold_item_idx = np.asarray(cold_item, dtype=np.int64)
        self.mapped_warm_user_idx = self.map_users(self.source_warm_user_idx)
        self.mapped_warm_item_idx = self.map_items(self.source_warm_item_idx)
        self.mapped_cold_user_idx = self.map_users(self.source_cold_user_idx)
        self.mapped_cold_item_idx = self.map_items(self.source_cold_item_idx)

        # ---- training CSR by user (sorted items) for rated-mask/rejection ----
        tp = self.train_pairs
        order = np.lexsort((tp[:, 1], tp[:, 0]))
        tu, ti = tp[order, 0], tp[order, 1]
        counts = np.bincount(tu, minlength=self.user_num)
        self.train_indptr = np.zeros(self.user_num + 1, dtype=np.int64)
        np.cumsum(counts, out=self.train_indptr[1:])
        self.train_items_sorted = ti.astype(np.int64)
        self.max_rated = int(counts.max(initial=0))

        # ---- eval splits ----
        self.eval_splits: Dict[str, EvalSplit] = {
            name: _build_eval_split(self.splits[name]) for name in EVAL_SPLITS
        }

        # ---- graphs (lazy) ----
        self._norm_adj: Optional[SparseGraphHost] = None
        self._interaction: Optional[sp.csr_matrix] = None

    # ------------------------------------------------------------------ ids
    @staticmethod
    def _remap_content(content, order, num) -> Optional[np.ndarray]:
        if content is None:
            return None
        content = np.asarray(content, dtype=np.float32)
        n_buf = max(num, content.shape[0], int(order.shape[0]))
        out = np.zeros((n_buf, content.shape[1]), dtype=np.float32)
        np.take(content, order, axis=0, out=out[:order.shape[0]])
        return out

    def map_users(self, raw: np.ndarray) -> np.ndarray:
        raw = np.asarray(raw, dtype=np.int64)
        oob = (raw < 0) | (raw >= self._user_map.shape[0])
        if oob.any():
            raise KeyError(f"user {raw[oob][0]} not in current id table")
        mapped = self._user_map[raw]
        if (mapped < 0).any():
            bad = raw[mapped < 0][0]
            raise KeyError(f"user {bad} not in current id table")
        return mapped

    def map_items(self, raw: np.ndarray) -> np.ndarray:
        raw = np.asarray(raw, dtype=np.int64)
        oob = (raw < 0) | (raw >= self._item_map.shape[0])
        if oob.any():
            raise KeyError(f"item {raw[oob][0]} not in current id table")
        mapped = self._item_map[raw]
        if (mapped < 0).any():
            bad = raw[mapped < 0][0]
            raise KeyError(f"item {bad} not in current id table")
        return mapped

    @property
    def id2user(self) -> np.ndarray:
        """mapped id -> raw user id."""
        return self._user_order

    @property
    def id2item(self) -> np.ndarray:
        return self._item_order

    # ------------------------------------------------------------ membership
    def user_rated_slice(self, uid: int) -> np.ndarray:
        """Sorted mapped item ids the (mapped) user interacted with in train."""
        return self.train_items_sorted[
            self.train_indptr[uid] : self.train_indptr[uid + 1]
        ]

    def is_rated(self, uids: np.ndarray, iids: np.ndarray) -> np.ndarray:
        """Vectorized membership test: did user u rate item i in training?"""
        uids = np.asarray(uids, dtype=np.int64)
        iids = np.asarray(iids, dtype=np.int64)
        # global searchsorted: offset items into disjoint per-user key spaces;
        # O(n log E) using one sorted key array built once.
        if not hasattr(self, "_train_keys"):
            rows = np.repeat(
                np.arange(self.user_num), np.diff(self.train_indptr)
            ).astype(np.int64)
            self._train_keys = rows * (self.item_num + 1) + self.train_items_sorted
        if self._train_keys.size == 0:
            return np.zeros(uids.shape, dtype=bool)
        keys = uids * (self.item_num + 1) + iids
        pos = np.minimum(
            np.searchsorted(self._train_keys, keys), self._train_keys.shape[0] - 1
        )
        return self._train_keys[pos] == keys

    # ---------------------------------------------------------------- graphs
    @property
    def interaction_csr(self) -> sp.csr_matrix:
        """User x item training interaction matrix (databuilder.py:265-275)."""
        if self._interaction is None:
            tp = self.train_pairs
            self._interaction = sp.csr_matrix(
                (
                    np.ones(tp.shape[0], dtype=np.float32),
                    (tp[:, 0], tp[:, 1]),
                ),
                shape=(self.user_num, self.item_num),
            )
        return self._interaction

    def bipartite_adjacency(self, self_connection: bool = False) -> sp.csr_matrix:
        """(U+I)x(U+I) bipartite adjacency (databuilder.py:220-234)."""
        n = self.user_num + self.item_num
        tp = self.train_pairs
        a = sp.csr_matrix(
            (
                np.ones(tp.shape[0], dtype=np.float32),
                (tp[:, 0], tp[:, 1] + self.user_num),
            ),
            shape=(n, n),
        )
        adj = a + a.T
        if self_connection:
            adj = adj + sp.eye(n, dtype=np.float32, format="csr")
        return adj

    @staticmethod
    def normalize_graph(adj: sp.spmatrix) -> sp.csr_matrix:
        """Symmetric D^-1/2 A D^-1/2 (square) or row D^-1 A
        (databuilder.py:236-254); a row of degree 0 keeps 0."""
        rowsum = np.asarray(adj.sum(1)).flatten()
        if adj.shape[0] == adj.shape[1]:
            d_inv = np.zeros_like(rowsum, dtype=np.float32)
            np.power(rowsum, -0.5, out=d_inv, where=rowsum != 0)
            d = sp.diags(d_inv)
            return (d @ adj @ d).tocsr()
        d_inv = np.zeros_like(rowsum, dtype=np.float32)
        np.power(rowsum, -1.0, out=d_inv, where=rowsum != 0)
        return (sp.diags(d_inv) @ adj).tocsr()

    @property
    def norm_adj(self) -> SparseGraphHost:
        """Normalized bipartite adjacency as row-sorted COO arrays."""
        if self._norm_adj is None:
            self._norm_adj = SparseGraphHost.from_scipy(
                self.normalize_graph(self.bipartite_adjacency())
            )
        return self._norm_adj

    # ------------------------------------------------------------------ eval
    def rated_padded(self, eval_users: np.ndarray) -> np.ndarray:
        """(n_users, max_rated) mapped rated-item ids padded with item_num.

        Scattering -1e9 at a padded index of ``item_num`` into a score matrix
        widened by one dummy column reproduces the reference's per-user rated
        masking (BaseRecommender.py:175-177) with a static shape.
        """
        eval_users = np.asarray(eval_users, dtype=np.int64)
        n = eval_users.shape[0]
        width = max(self.max_rated, 1)
        out = np.full((n, width), self.item_num, dtype=np.int32)
        starts = self.train_indptr[eval_users]
        counts = self.train_indptr[eval_users + 1] - starts
        total = int(counts.sum())
        if total:
            rows = np.repeat(np.arange(n), counts)
            within = np.arange(total) - np.repeat(
                np.cumsum(counts) - counts, counts
            )
            flat = self.train_items_sorted[np.repeat(starts, counts) + within]
            out[rows, within] = flat
        return out

    def candidate_mask(self, cold_object: str, data_type: str) -> Optional[np.ndarray]:
        """Item ids to exclude for a given eval setting (BaseRecommender.py:130-143).

        Under item cold-start: 'warm' eval masks cold items, 'cold' eval masks
        warm items, 'all' masks nothing. User cold-start has no item mask.
        """
        if cold_object != "item":
            return None
        if data_type == "warm":
            return self.mapped_cold_item_idx.astype(np.int32)
        if data_type == "cold":
            return self.mapped_warm_item_idx.astype(np.int32)
        return None

    # ------------------------------------------------------------- size info
    def training_size(self) -> Tuple[int, int, int]:
        return self.n_seen_users, self.n_seen_items, self.n_train

    @classmethod
    def from_split_dir(cls, data_dir: str, dataset: str, cold_object: str):
        from .loader import load_split_dir

        d = load_split_dir(data_dir, dataset, cold_object)
        return cls(
            training=d["training"],
            warm_val=d["warm_val"],
            cold_val=d["cold_val"],
            overall_val=d["overall_val"],
            warm_test=d["warm_test"],
            cold_test=d["cold_test"],
            overall_test=d["overall_test"],
            user_num=d["user_num"],
            item_num=d["item_num"],
            warm_user=d["warm_user"],
            warm_item=d["warm_item"],
            cold_user=d["cold_user"],
            cold_item=d["cold_item"],
            user_content=d["user_content"],
            item_content=d["item_content"],
        )
