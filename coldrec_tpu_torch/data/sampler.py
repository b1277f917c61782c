"""Host-side BPR batches with static shapes (the port's copy of ``_pad``,
``sample_negatives``, ``pairwise_batches``,
``pairwise_batches_with_neg_users`` (LARA), ``warm_item_pool``,
``pairwise_batches_multi_neg`` (CLCRec) and ``ccfcrec_batches`` (CCFCRec,
M2VAE) from ``coldrec_tpu/data/sampler.py``;
reference ColdRec util/utils.py:123-233).

  * every batch has exactly ``batch_size`` rows; the final partial batch is
    padded and carries a float ``weight`` vector (1.0 real / 0.0 pad), so
    the weighted losses equal the reference's mean over the real rows;
  * negatives are uniform over the *seen* item table (the reference samples
    from ``data.item.keys()``, utils.py:128), rejected against the training
    CSR until clean (utils.py:141-153);
  * all randomness flows through an explicit numpy Generator, consumed in
    the JAX package's order: one ``permutation`` per epoch, then per batch
    one ``integers(0, 2**63 - 1)`` seed for the native sampler, or the
    numpy rejection loop's draws. The same seed therefore gives the same
    batches in both packages.

``sampler="native"`` (the default) draws with the port's C++ sampler
(:mod:`coldrec_tpu_torch.native`), as the JAX package does whenever its
native library loads; ``"numpy"`` is its pure-numpy path. A native build
that fails raises: the two samplers draw different negatives.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from .builder import ColdStartDataset

SAMPLERS = ("native", "numpy")


def _pad(arr: np.ndarray, batch_size: int, fill=0) -> np.ndarray:
    n = arr.shape[0]
    if n == batch_size:
        return arr
    pad_shape = (batch_size - n,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)])


def sample_negatives(
    data: ColdStartDataset,
    users: np.ndarray,
    rng: np.random.Generator,
    n_negs: int = 1,
    pool: Optional[np.ndarray] = None,
    max_rounds: int = 200,
    sampler: str = "native",
) -> np.ndarray:
    """Uniform negatives with rejection against training positives: every
    returned item is not rated by its user in training. ``pool``
    optionally restricts the candidate item ids; default is all seen
    items."""
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler {sampler!r} not in {SAMPLERS}")
    total = users.shape[0] * n_negs
    u_rep = np.repeat(users, n_negs)
    if sampler == "native":
        from ..native import sample_negatives_native

        negs = sample_negatives_native(
            data.train_indptr,
            data.train_items_sorted,
            u_rep,
            data.n_seen_items,
            int(rng.integers(0, 2**63 - 1)),
            pool=pool,
        )
        if n_negs == 1:
            return negs
        return negs.reshape(users.shape[0], n_negs)
    if pool is None:
        negs = rng.integers(0, data.n_seen_items, size=total, dtype=np.int64)
    else:
        negs = pool[rng.integers(0, pool.shape[0], size=total)]
    bad = data.is_rated(u_rep, negs)
    rounds = 0
    while bad.any():
        idx = np.where(bad)[0]
        if pool is None:
            negs[idx] = rng.integers(0, data.n_seen_items, size=idx.shape[0])
        else:
            negs[idx] = pool[rng.integers(0, pool.shape[0], size=idx.shape[0])]
        bad[idx] = data.is_rated(u_rep[idx], negs[idx])
        rounds += 1
        if rounds > max_rounds:
            raise RuntimeError(
                "negative sampling failed to converge; candidate pool too small"
            )
    if n_negs == 1:
        return negs
    return negs.reshape(users.shape[0], n_negs)


def pairwise_batches(
    data: ColdStartDataset,
    batch_size: int,
    rng: np.random.Generator,
    n_negs: int = 1,
    sampler: str = "native",
) -> Iterator[Dict[str, np.ndarray]]:
    """BPR triplet batches (utils.py:123-157): shuffled positives + 1 rejected
    negative per positive. Yields {user, pos_item, neg_item, weight}."""
    perm = rng.permutation(data.n_train)
    pairs = data.train_pairs[perm]
    for start in range(0, data.n_train, batch_size):
        chunk = pairs[start : start + batch_size]
        users = chunk[:, 0]
        negs = sample_negatives(data, users, rng, n_negs=n_negs,
                                sampler=sampler)
        n = chunk.shape[0]
        w = np.ones(n, dtype=np.float32)
        yield {
            "user": _pad(users.astype(np.int32), batch_size),
            "pos_item": _pad(chunk[:, 1].astype(np.int32), batch_size),
            "neg_item": _pad(negs.astype(np.int32), batch_size),
            "weight": _pad(w, batch_size, fill=0.0),
        }


def _negative_users(data: ColdStartDataset, items: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
    """One seen user per item who did not rate it in training, drawn
    uniformly and redrawn until clean (numpy, in the JAX package's order
    of draws)."""
    neg_users = rng.integers(0, data.n_seen_users, size=items.shape[0])
    bad = data.is_rated(neg_users, items)
    while bad.any():
        idx = np.where(bad)[0]
        neg_users[idx] = rng.integers(0, data.n_seen_users,
                                      size=idx.shape[0])
        bad[idx] = data.is_rated(neg_users[idx], items[idx])
    return neg_users


def pairwise_batches_with_neg_users(
    data: ColdStartDataset,
    batch_size: int,
    rng: np.random.Generator,
    sampler: str = "native",
) -> Iterator[Dict[str, np.ndarray]]:
    """LARA batches (utils.py:160-188): each positive (u, i) with a
    negative item for the user and a negative user for the item (a seen
    user who did not rate it in training, rejection-sampled with numpy).
    Yields {user, pos_item, neg_item, neg_user, weight}."""
    perm = rng.permutation(data.n_train)
    pairs = data.train_pairs[perm]
    for start in range(0, data.n_train, batch_size):
        chunk = pairs[start: start + batch_size]
        users, items = chunk[:, 0], chunk[:, 1]
        neg_items = sample_negatives(data, users, rng, sampler=sampler)
        neg_users = _negative_users(data, items, rng)
        n = chunk.shape[0]
        yield {
            "user": _pad(users.astype(np.int32), batch_size),
            "pos_item": _pad(items.astype(np.int32), batch_size),
            "neg_item": _pad(neg_items.astype(np.int32), batch_size),
            "neg_user": _pad(neg_users.astype(np.int32), batch_size),
            "weight": _pad(np.ones(n, np.float32), batch_size, fill=0.0),
        }


def warm_item_pool(data: ColdStartDataset) -> np.ndarray:
    """Seen items minus cold items: the CLCRec / CCFCRec negative pool
    (utils.py:196-209)."""
    cold = np.zeros(data.n_seen_items, dtype=bool)
    cold[data.mapped_cold_item_idx[
        data.mapped_cold_item_idx < data.n_seen_items]] = True
    pool = np.where(~cold)[0].astype(np.int64)
    if pool.size == 0:
        raise ValueError(
            "warm-item negative pool is empty; check cold_item split")
    return pool


def pairwise_batches_multi_neg(
    data: ColdStartDataset,
    batch_size: int,
    rng: np.random.Generator,
    n_negs: int,
    pool: Optional[np.ndarray] = None,
    sampler: str = "native",
) -> Iterator[Dict[str, np.ndarray]]:
    """CLCRec batches (utils.py:191-233): each positive with ``n_negs``
    negatives from ``pool`` (the warm items), rejected against the user's
    training positives. Yields {user, pos_item, neg_items (B, n_negs),
    weight}."""
    perm = rng.permutation(data.n_train)
    pairs = data.train_pairs[perm]
    for start in range(0, data.n_train, batch_size):
        chunk = pairs[start: start + batch_size]
        users = chunk[:, 0]
        negs = sample_negatives(data, users, rng, n_negs=n_negs, pool=pool,
                                sampler=sampler)
        n = chunk.shape[0]
        yield {
            "user": _pad(users.astype(np.int32), batch_size),
            "pos_item": _pad(chunk[:, 1].astype(np.int32), batch_size),
            "neg_items": _pad(negs.astype(np.int32), batch_size),
            "weight": _pad(np.ones(n, np.float32), batch_size, fill=0.0),
        }


def ccfcrec_batches(
    data: ColdStartDataset,
    batch_size: int,
    rng: np.random.Generator,
    positive_number: int,
    negative_number: int,
    self_neg_number: int,
    pool: Optional[np.ndarray] = None,
    sampler: str = "native",
) -> Iterator[Dict[str, np.ndarray]]:
    """CCFCRec / M2VAE batches (utils.py:237-300): each positive pair with
    a negative user (not a rater of the item), P co-occurring positives
    (the user's training items, drawn with replacement), a P x N grid of
    warm-pool negatives and S warm-pool self-negatives, each rejected
    against the user's training positives. Yields {user, pos_item,
    neg_user, pos_grid (B, P), neg_grid (B, P, N), self_negs (B, S),
    weight}."""
    if pool is None:
        pool = warm_item_pool(data)
    perm = rng.permutation(data.n_train)
    pairs = data.train_pairs[perm]
    deg = np.diff(data.train_indptr)
    for start in range(0, data.n_train, batch_size):
        chunk = pairs[start: start + batch_size]
        users, items = chunk[:, 0], chunk[:, 1]
        n = chunk.shape[0]
        starts = data.train_indptr[users]
        cnt = np.maximum(deg[users], 1)
        r = rng.random((n, positive_number))
        pos_grid = data.train_items_sorted[
            starts[:, None] + (r * cnt[:, None]).astype(np.int64)]
        neg_users = _negative_users(data, items, rng)
        neg_grid = sample_negatives(
            data, np.repeat(users, negative_number * positive_number), rng,
            pool=pool, sampler=sampler,
        ).reshape(n, positive_number, negative_number)
        self_negs = sample_negatives(
            data, np.repeat(users, self_neg_number), rng, pool=pool,
            sampler=sampler,
        ).reshape(n, self_neg_number)
        yield {
            "user": _pad(users.astype(np.int32), batch_size),
            "pos_item": _pad(items.astype(np.int32), batch_size),
            "neg_user": _pad(neg_users.astype(np.int32), batch_size),
            "pos_grid": _pad(pos_grid.astype(np.int32), batch_size),
            "neg_grid": _pad(neg_grid.astype(np.int32), batch_size),
            "self_negs": _pad(self_negs.astype(np.int32), batch_size),
            "weight": _pad(np.ones(n, np.float32), batch_size, fill=0.0),
        }
