"""k-means (Lloyd iterations) on tensors (the port's copy of
``coldrec_tpu/ops/kmeans.py``; reference: faiss.Kmeans in NCL.py:38-55).

Each iteration is one matmul (pairwise scores), an argmax and a segment
mean; an empty cluster keeps its centroid. The JAX version is XLA, not a
Pallas kernel, so this is plain torch. The initial centroids are ``k``
distinct rows drawn by an explicit ``torch.Generator``, or the rows
``init_idx`` (the tests inject the indices ``jax.random.choice`` drew).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    # argmin ||x - c||^2 == argmax (x.c - ||c||^2 / 2): one matmul
    logits = x @ centroids.T - 0.5 * (centroids * centroids).sum(dim=1)
    return logits.argmax(dim=1)


@torch.no_grad()
def kmeans(
    x: torch.Tensor,
    k: int,
    n_iters: int = 20,
    generator: Optional[torch.Generator] = None,
    init_idx=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (centroids (k, d), assignment (n,)) for x (n, d)."""
    n = x.shape[0]
    if init_idx is None:
        dev = generator.device if generator is not None else x.device
        init_idx = torch.randperm(n, generator=generator, device=dev)[:k]
    if not isinstance(init_idx, torch.Tensor):
        init_idx = torch.from_numpy(np.array(init_idx, np.int64))
    centroids = x[init_idx.to(x.device).long()]
    for _ in range(n_iters):
        a = _assign(x, centroids)
        sums = x.new_zeros((k, x.shape[1])).index_add_(0, a, x)
        counts = torch.bincount(a, minlength=k).to(x.dtype)
        centroids = torch.where(counts[:, None] > 0,
                                sums / counts.clamp_min(1.0)[:, None],
                                centroids)
    return centroids, _assign(x, centroids)
