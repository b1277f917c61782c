"""Per-model flag registry (the port's copy of the MF part of
``coldrec_tpu/config/model_params.py``; reference config/model_param.py).

MF adds no flags of its own. Every other model of the JAX package is refused
with the ROADMAP queue item that brings it to the port.
"""
from __future__ import annotations

import argparse
from typing import Dict

MODEL_PARAM_REGISTRY: Dict[str, dict] = {"MF": {}}

# ROADMAP.md, Queue 1: the item that ports each model of the JAX package
_QUEUE_ITEM = {
    **dict.fromkeys(("DropoutNet", "DeepMusic", "GAR", "Heater", "ALDI",
                     "DUIF"), 3),
    **dict.fromkeys(("LightGCN", "NGCF", "SimGCL", "XSimGCL", "NCL"), 4),
    **dict.fromkeys(("KNN", "AGNN"), 5),
    **dict.fromkeys(("VBPR", "AMR", "MTPR", "LARA", "MetaEmbedding",
                     "CLCRec", "GoRec", "CCFCRec", "M2VAE", "CGRC", "FSGNN",
                     "USIM"), 6),
}


def require_ported(model: str) -> None:
    """Raise ``ValueError`` unless ``model`` runs in the port."""
    if model in MODEL_PARAM_REGISTRY:
        return
    if model in _QUEUE_ITEM:
        raise ValueError(
            f"model {model!r} is not in the PyTorch port yet: ROADMAP.md "
            f"Queue 1, item {_QUEUE_ITEM[model]} brings it. Ported: "
            f"{sorted(MODEL_PARAM_REGISTRY)}")
    raise ValueError(
        f"Invalid model name: {model}. Ported: {sorted(MODEL_PARAM_REGISTRY)}")


def registry_defaults(model: str) -> dict:
    """The model's own flags and defaults, for ``default_args``."""
    require_ported(model)
    return dict(MODEL_PARAM_REGISTRY[model])


def add_model_params(model: str, parser: argparse.ArgumentParser):
    for name, default in registry_defaults(model).items():
        parser.add_argument(f"--{name}", type=type(default), default=default)
    return parser
