"""The device mesh: ranks laid out as data x model, and their groups.

The port's counterpart of ``coldrec_tpu/parallel/mesh.py``. Two axes:

  * ``data``: the batch dimension of the pairwise losses; each rank of a
    model column takes one contiguous block of the batch, and gradients are
    summed over the data group;
  * ``model``: the rows of the big embedding tables and the item axis of
    the retrieval sweep.

One rank per mesh position, laid out as the JAX package lays out devices
(``devices[:need].reshape(n_data, n_model)``): rank ``r`` sits at
``(r // n_model, r % n_model)``. :func:`make_mesh` builds the model group
of each data row and the data group of each model column; every rank calls
``new_group`` for every group, in the same order, as torch requires. An
axis of size 1 has no group (``None``): its collectives are the identity.
A (1, 1) mesh is the single-device path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch.distributed as dist

from .distributed import process_count, process_index


@dataclass(frozen=True)
class Mesh:
    """This rank's place in an ``n_data x n_model`` mesh and its groups."""

    n_data: int
    n_model: int
    rank: int
    model_group: Optional[Any] = None  # ranks of this data row
    data_group: Optional[Any] = None  # ranks of this model column

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def parse_mesh(spec: str):
    """``"DxM"`` -> (D, M)."""
    try:
        n_data, n_model = (int(v) for v in str(spec).lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: expected DxM, e.g. 2x2") from None
    if n_data < 1 or n_model < 1:
        raise ValueError(f"--mesh {spec!r}: both axes must be >= 1")
    return n_data, n_model


def make_mesh(n_data: int = 1, n_model: int = 1) -> Mesh:
    """The mesh over every rank of the process group (one rank without
    one); the world size must be ``n_data * n_model``."""
    need = n_data * n_model
    have = process_count()
    if have != need:
        raise ValueError(
            f"mesh ({n_data}x{n_model}) needs {need} processes, have {have}")
    rank = process_index()
    model_group = data_group = None
    if n_model > 1:
        for row in range(n_data):
            g = dist.new_group(list(range(row * n_model, (row + 1) * n_model)))
            if row == rank // n_model:
                model_group = g
    if n_data > 1:
        for col in range(n_model):
            g = dist.new_group(list(range(col, need, n_model)))
            if col == rank % n_model:
                data_group = g
    return Mesh(n_data, n_model, rank, model_group, data_group)


def default_mesh(n_processes: Optional[int] = None) -> Mesh:
    """Mesh over all ranks: the model axis the largest of 8, 4, 2 that
    divides the count, the data axis the rest."""
    n = n_processes or process_count()
    n_model = 1
    for cand in (8, 4, 2):
        if n % cand == 0:
            n_model = cand
            break
    return make_mesh(n // n_model, n_model)


def shards_rows(shape, table_rows, n_model: int) -> bool:
    """The table rule of the JAX package's ``_setup_mesh``: a 2-D leaf
    whose leading dimension is ``user_num`` or ``item_num`` and divisible by
    the model axis is row-sharded over it; every other leaf is
    replicated."""
    return (n_model > 1 and len(shape) == 2 and shape[0] in table_rows
            and shape[0] % n_model == 0)
