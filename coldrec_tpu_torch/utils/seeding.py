"""Deterministic seeding (the port's copy of ``coldrec_tpu/utils/seeding.py``;
reference: util/utils.py:339-348 set_seed).

Seeds Python's ``random``, numpy's global stream and torch's default
generators. The samplers draw from an explicit numpy Generator that each
trainer seeds itself, so the batch stream does not depend on this call.
"""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
