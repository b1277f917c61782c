"""Per-model flag registry (the port's copy of the ported models' part of
``coldrec_tpu/config/model_params.py``; reference config/model_param.py).

MF, DeepMusic, DUIF, LightGCN and NGCF add no flags of their own (the
graph backbones' ``--layers`` is a common flag, default 2). Every model of the JAX
package that is not ported yet is refused with the ROADMAP queue item that
brings it to the port.
"""
from __future__ import annotations

import argparse
from typing import Dict

MODEL_PARAM_REGISTRY: Dict[str, dict] = {
    "MF": {},
    "DropoutNet": {
        "n_dropout": 0.5,
        "dropoutnet_hidden1": 200,
        "dropoutnet_hidden2": 100,
    },
    "GAR": {"alpha": 0.05, "beta": 0.1},
    "ALDI": {
        "alpha": 0.9,
        "beta": 0.05,
        "gamma": 0.1,
        "tws": 0,
        "freq_coef_M": 4.0,
        "aldi_hidden": 200,
    },
    "DeepMusic": {},
    "DUIF": {},
    "Heater": {
        "n_expert": 5,
        "n_dropout": 0.5,
        "alpha": 0.5,
        "heater_mlp_hidden": 200,
    },
    "LightGCN": {},
    "NGCF": {},
    "SimGCL": {"cl_rate": 0.5, "tau": 0.2, "eps": 0.1},
    "XSimGCL": {"cl_rate": 0.5, "tau": 0.2, "eps": 0.1, "l_cl": 2},
    "NCL": {
        "tau": 0.2,
        "ssl_reg": 1e-6,
        "proto_reg": 1e-7,
        "alpha": 1.0,
        "hyper_layers": 1,
        "num_clusters": 20,
    },
}

# ROADMAP.md, Queue 1: the item that ports each model of the JAX package
_QUEUE_ITEM = {
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
