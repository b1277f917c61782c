"""Embedding checkpoint bus (the port's copy of the embedding half of
``coldrec_tpu/runtime/checkpoints.py``).

Warm backbones write ``<emb_dir>/<ds>_cold_<obj>_<model>_emb.npz`` holding at
least ``user_emb`` and ``item_emb``; cold-start models and the serving layer
read it. The file is framework-neutral numpy, so an artifact written by the
JAX package is read here unchanged and the other way round.

The reference's layout (one ``torch.save`` file per tensor, named
``<ds>_cold_<obj>_<model>_<key>.pt``, e.g. ColdRec MF.py:44-46) is written
with ``fmt="pt"``/``"both"`` and read when the npz is absent.

The mid-training train-state checkpoint (:func:`save_train_state`,
:func:`load_train_state`) is the port's own ``torch.save`` file; it does not
read the JAX package's pickle.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def save_train_state(path: str, state: Dict) -> str:
    """Write a mid-training checkpoint: tensors (state dicts included) go to
    the CPU, the rest stays Python values. Written to a temporary file and
    renamed into place, so a preemption mid-write never leaves a torn
    file."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, path)
    return path


def load_train_state(path: str) -> Optional[Dict]:
    """The checkpoint at ``path`` (tensors on the CPU), or None if absent."""
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def _path(emb_dir: str, dataset: str, cold_object: str, model: str) -> str:
    return os.path.join(emb_dir, f"{dataset}_cold_{cold_object}_{model}_emb.npz")


def _pt_prefix(emb_dir: str, dataset: str, cold_object: str, model: str) -> str:
    return os.path.join(emb_dir, f"{dataset}_cold_{cold_object}_{model}_")


def _load_pt_tensor(path: str) -> np.ndarray:
    try:
        t = torch.load(path, map_location="cpu")
    except pickle.UnpicklingError:
        # newer torch defaults weights_only=True, which rejects Parameters
        # saved by some torch versions; these are local bus artifacts
        t = torch.load(path, map_location="cpu", weights_only=False)
    return t.detach().cpu().numpy()


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_embeddings(
    emb_dir: str,
    dataset: str,
    cold_object: str,
    model: str,
    tensors: Dict[str, object],
    fmt: str = "npz",
) -> str:
    """Write the bus artifact from numpy arrays or tensors (any device).
    ``fmt``: "npz" (native), "pt" (the reference's per-tensor layout) or
    "both"."""
    os.makedirs(emb_dir, exist_ok=True)
    path = _path(emb_dir, dataset, cold_object, model)
    if fmt not in ("npz", "pt", "both"):
        raise ValueError(f"unknown emb format {fmt!r} (npz|pt|both)")
    arrays = {k: _to_numpy(v) for k, v in tensors.items()}
    if fmt in ("npz", "both"):
        np.savez(path, **arrays)
    if fmt in ("pt", "both"):
        prefix = _pt_prefix(emb_dir, dataset, cold_object, model)
        for k, v in arrays.items():
            # np.array copy: torch warns on (and may alias) non-writable views
            torch.save(torch.from_numpy(np.array(v)), f"{prefix}{k}.pt")
    if fmt == "pt" and os.path.exists(path):
        # a stale npz would shadow this fresh export (the npz is preferred)
        os.remove(path)
    return path if fmt != "pt" else _pt_prefix(
        emb_dir, dataset, cold_object, model
    )


def load_embeddings(
    emb_dir: str,
    dataset: str,
    cold_object: str,
    model: str,
    required: Optional[tuple] = ("user_emb", "item_emb"),
) -> Dict[str, np.ndarray]:
    """Read the bus artifact as numpy arrays (the npz, else the .pt files)."""
    path = _path(emb_dir, dataset, cold_object, model)
    if os.path.exists(path):
        with np.load(path) as z:
            out = {k: z[k] for k in z.files}
    else:
        prefix = _pt_prefix(emb_dir, dataset, cold_object, model)
        out = {
            os.path.basename(p)[len(os.path.basename(prefix)):-3]:
                _load_pt_tensor(p)
            for p in sorted(glob.glob(prefix + "*.pt"))
        }
        if not out:
            raise FileNotFoundError(
                f"backbone checkpoint not found: {path} (and no reference "
                f"{os.path.basename(prefix)}*.pt files). Train the backbone "
                f"{model} on {dataset} (cold_{cold_object}) first."
            )
    if required:
        missing = [k for k in required if k not in out]
        if missing:
            raise KeyError(f"checkpoint {path} missing tensors {missing}")
    return out
