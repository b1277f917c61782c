"""Synthetic dataset generation for tests and ``chip_smoke.py``.

The port's copy of ``synthetic_interactions``, ``latent_interactions``,
``latent_content`` and ``synthetic_dataset`` from
``coldrec_tpu/data/synthetic.py``: numpy only, in the same order of draws,
so a seed gives the same dataset in both packages, bit for bit.

Generates an implicit-feedback interaction log with a skewed (zipf-like)
item popularity distribution, runs it through the real split protocol
(:mod:`coldrec_tpu_torch.data.split`), and builds a :class:`ColdStartDataset` —
so every test exercises the production protocol path end to end.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .builder import ColdStartDataset
from .split import SplitResult, cold_start_split


def synthetic_interactions(
    n_users: int,
    n_items: int,
    n_inter: int,
    seed: int = 0,
    zipf_a: float = 1.1,
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, size=n_inter)
    # zipf-ish popularity over items
    ranks = rng.zipf(zipf_a, size=n_inter) % n_items
    pairs = np.stack([users, ranks], axis=1).astype(np.int64)
    # guarantee every user and item appears at least once
    extra_u = np.stack(
        [np.arange(n_users), rng.integers(0, n_items, n_users)], axis=1
    )
    extra_i = np.stack(
        [rng.integers(0, n_users, n_items), np.arange(n_items)], axis=1
    )
    return np.concatenate([pairs, extra_u, extra_i]).astype(np.int64)


def latent_interactions(
    n_users: int,
    n_items: int,
    nnz: int,
    seed: int = 0,
    rank: int = 16,
    alpha: float = 3.0,
    pop_exponent: float = 1.0,
    degree_a: float = 1.6,
    min_degree: int = 5,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Latent-factor interaction sampler producing EXACTLY ``nnz`` unique pairs.

    Used for the faithful-statistics parity tiers (mlfull/xing): the plain
    zipf sampler in :func:`synthetic_interactions` loses a large, popularity-
    dependent fraction of draws to (user, item) dedup, so a tier that must
    match a real dataset's published interaction count (e.g. MovieLens-1M's
    1,000,209 — reference data/README.md:8) cannot hit it. Here each user u
    draws ``deg_u`` items *without replacement* from a softmax preference
    distribution ``alpha * (U_u . V_i) + pop_i`` via Gumbel top-k, with
    power-law user degrees summing exactly to ``nnz``.

    Crucially the item latent factors ``V`` are returned so content can be
    generated as a (noisy linear) view of them — making cold-start metrics
    carry REAL signal instead of being draws from the random-ranking null
    (the round-3 weakness of the independent-content generator: every cold
    cell was noise-dominated, see tools/cold_noise_analysis.py).

    Returns ``(pairs, user_factors, item_factors)``.
    """
    rng = np.random.default_rng(seed)
    uf = (rng.standard_normal((n_users, rank)) / np.sqrt(rank)).astype(np.float32)
    vf = (rng.standard_normal((n_items, rank)) / np.sqrt(rank)).astype(np.float32)
    # zipf-like popularity logit assigned to a random item permutation
    pop = (-pop_exponent * np.log(rng.permutation(n_items) + 1.0)).astype(
        np.float32
    )

    # ---- per-user degrees: pareto-ish, exact-sum nnz ----
    cap = min(n_items, max(min_degree + 1, int(0.6 * n_items)))
    if not n_users * min_degree <= nnz <= n_users * cap:
        # without this the exact-sum adjust loop below spins forever on an
        # empty donor/recipient pool (rng.choice(empty, size=0) is a no-op)
        raise ValueError(
            f"nnz={nnz} outside the achievable range "
            f"[{n_users * min_degree}, {n_users * cap}] for "
            f"n_users={n_users}, min_degree={min_degree}, cap={cap}"
        )
    w = rng.pareto(degree_a, n_users) + 1.0
    deg = np.clip(
        np.floor(w / w.sum() * nnz).astype(np.int64), min_degree, cap
    )
    diff = int(nnz - deg.sum())
    while diff != 0:
        if diff > 0:
            room = np.flatnonzero(deg < cap)
            take = rng.choice(room, size=min(diff, room.size), replace=False)
            deg[take] += 1
            diff -= take.size
        else:
            rich = np.flatnonzero(deg > min_degree)
            take = rng.choice(rich, size=min(-diff, rich.size), replace=False)
            deg[take] -= 1
            diff += take.size

    offsets = np.concatenate([[0], np.cumsum(deg)])
    users_out = np.repeat(np.arange(n_users, dtype=np.int64), deg)
    items_out = np.empty(int(deg.sum()), dtype=np.int64)
    # chunk the (users, items) logit plane to bound memory at xing scale
    chunk = max(1, int(2**26) // n_items)
    for s in range(0, n_users, chunk):
        e = min(n_users, s + chunk)
        logits = alpha * (uf[s:e] @ vf.T) + pop[None, :]
        logits += rng.gumbel(size=logits.shape).astype(np.float32)
        kmax = int(deg[s:e].max())
        top = np.argpartition(-logits, kmax - 1, axis=1)[:, :kmax]
        tl = np.take_along_axis(logits, top, axis=1)
        order = np.argsort(-tl, axis=1)
        top = np.take_along_axis(top, order, axis=1)
        for j in range(e - s):
            u = s + j
            items_out[offsets[u]: offsets[u + 1]] = top[j, : deg[u]]

    # item coverage within the exact budget: each missing item replaces the
    # lowest-ranked pick of a distinct heavy user (a missing item is held
    # by no one, so no within-user duplicate can appear). The replaced pick
    # may itself have been that item's ONLY occurrence, so iterate until
    # the count vector has no zeros — the first pass is identical to the
    # single-shot repair (same rng draws), extra passes only run where the
    # single shot would have left newly-uncovered items.
    counts = np.bincount(items_out, minlength=n_items)
    missing = np.flatnonzero(counts == 0)
    for _ in range(100):
        if not missing.size:
            break
        pool = np.flatnonzero(deg > min_degree)
        take = min(missing.size, pool.size)
        if take == 0:
            raise RuntimeError(
                "item-coverage repair has no donor users (all at min_degree)"
            )
        donors = rng.choice(pool, size=take, replace=False)
        slots = offsets[donors + 1] - 1
        np.subtract.at(counts, items_out[slots], 1)
        items_out[slots] = missing[:take]
        counts[missing[:take]] += 1
        missing = np.flatnonzero(counts == 0)
    else:
        raise RuntimeError("item-coverage repair did not converge")
    pairs = np.stack([users_out, items_out], axis=1)
    return pairs, uf, vf


def latent_content(
    factors: np.ndarray,
    content_dim: int,
    seed: int = 0,
    noise: float = 0.7,
) -> np.ndarray:
    """Content matrix as a noisy random linear lift of latent factors.

    Entry variance of the signal term is ~1 (factor rows have unit norm in
    expectation), so ``noise`` is the noise-to-signal std ratio.
    """
    rng = np.random.default_rng(seed)
    rank = factors.shape[1]
    m = rng.standard_normal((rank, content_dim)).astype(np.float32)
    base = factors @ m
    return (base + noise * rng.standard_normal(base.shape)).astype(np.float32)


def synthetic_dataset(
    n_users: int = 200,
    n_items: int = 120,
    n_inter: int = 4000,
    content_dim: int = 16,
    cold_object: str = "item",
    seed: int = 0,
) -> Tuple[ColdStartDataset, SplitResult]:
    pairs = synthetic_interactions(n_users, n_items, n_inter, seed=seed)
    res = cold_start_split(pairs, cold_object=cold_object, seed=seed + 42)
    rng = np.random.default_rng(seed + 1)
    user_content: Optional[np.ndarray] = None
    item_content: Optional[np.ndarray] = None
    if cold_object == "user":
        user_content = rng.standard_normal((res.user_num, content_dim)).astype(
            np.float32
        )
    else:
        item_content = rng.standard_normal((res.item_num, content_dim)).astype(
            np.float32
        )
    data = ColdStartDataset(
        training=res.warm_train,
        warm_val=res.warm_val,
        cold_val=res.cold_val,
        overall_val=res.overall_val,
        warm_test=res.warm_test,
        cold_test=res.cold_test,
        overall_test=res.overall_test,
        user_num=res.user_num,
        item_num=res.item_num,
        warm_user=res.warm_user,
        warm_item=res.warm_item,
        cold_user=res.cold_user,
        cold_item=res.cold_item,
        user_content=user_content,
        item_content=item_content,
    )
    return data, res
