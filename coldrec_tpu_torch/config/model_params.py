"""Per-model flag registry (the port's copy of the ported models' part of
``coldrec_tpu/config/model_params.py``; reference config/model_param.py).

MF, DeepMusic, DUIF, LightGCN and NGCF add no flags of their own (the
graph backbones' ``--layers`` is a common flag, default 2). An entry's
``"_overrides"`` sets common flags' defaults for that model (AGNN's, M2VAE's,
CGRC's and FSGNN's lr, bs, emb_size and epochs, as in the reference's
``set_defaults``). Boolean flags
take "true"/"false" (or no value: true); the (lr, wd) pairs of VBPR, AMR and
MTPR take "0.05,0" or "[0.05, 0]". All 26 models of the JAX package are
ported.
"""
from __future__ import annotations

import argparse
import ast
from typing import Dict

MODEL_PARAM_REGISTRY: Dict[str, dict] = {
    "MF": {},
    "KNN": {"knn_num": 5},
    "AGNN": {
        "_overrides": dict(lr=5e-4, bs=4096, emb_size=64, epochs=20),
        "agnn_knn_k": 10,
        "agnn_dropout": 0.5,
        "agnn_rank_weight": 1.0,
        "agnn_align_weight": 1.0,
        "agnn_vae_lambda": 1.0,
        "agnn_attention_size": 50,
        "agnn_clip_norm": 5.0,
        "agnn_finetune": False,
        "agnn_no_backbone": False,
        "agnn_eval_chunk": 512,
    },
    "VBPR": {"p_emb": [0.05, 0.0], "p_ctx": [0.05, 0.01]},
    "AMR": {
        "p_emb": [0.05, 0.0],
        "p_ctx": [0.05, 0.01],
        "eps": 0.1,
        "lmd": 1.0,
    },
    "MTPR": {
        "p_emb": [0.05, 0.0],
        "p_ctx": [0.05, 0.01],
        "p_proj": [0.05, 0.01],
    },
    "MetaEmbedding": {"alpha": 0.5},
    "LARA": {},
    "CLCRec": {
        "num_neg": 128,
        "temp_value": 2.0,
        "lr_lambda": 0.5,
        "num_sample": 0.5,
    },
    "GoRec": {
        "pre_cluster_num": 50,
        "uni_coeff": 5.0,
        "kl_coeff": 10.0,
        "dropout": 0.0,
    },
    "CCFCRec": {
        "positive_number": 5,
        "negative_number": 40,
        "self_neg_number": 40,
        "tau": 0.1,
        "lambda1": 0.6,
        "attr_present_dim": 64,
        "implicit_dim": 64,
        "cat_implicit_dim": 64,
        "pretrain": False,
        "pretrain_update": False,
    },
    "M2VAE": {
        "_overrides": dict(lr=5e-5, bs=4096, emb_size=64, epochs=10),
        "positive_number": 10,
        "negative_number": 40,
        "self_neg_number": 40,
        "attr_present_dim": 64,
        "implicit_dim": 64,
        "cat_implicit_dim": 64,
        "tau": 0.1,
        "m2vae_weight_decay": 0.1,
        "m2vae_kld_weight": 1.0,
        "m2vae_recon_weight": 1.0,
        "m2vae_decouple_weight": 100.0,
        "m2vae_pretrain": False,
        "m2vae_pretrain_update": False,
        "m2vae_attr_mask_neg1": False,
    },
    "CGRC": {
        "_overrides": dict(lr=1e-3, bs=4096, emb_size=64, epochs=500),
        "cgrc_mask_rho": 0.3,
        "cgrc_recon_topk": 20,
        "cgrc_layers_gprime": 2,
        "cgrc_layers_full": 2,
        "cgrc_layers_ghat": 2,
        "cgrc_lambda_e": 1.0,
        "cgrc_tau": 0.5,
        "cgrc_mlp_hidden": 64,
        "cgrc_le_max_edges": 4096,
        "cgrc_ranking_neg_per_user": 32,
    },
    "FSGNN": {
        "_overrides": dict(lr=0.005, reg=0.0005, emb_size=64, epochs=500,
                           bs=4096),
        "fsgnn_lambda_fc": 0.5,
        "fsgnn_mu_sc": 0.5,
        "fsgnn_p_drop": 0.3,
        "fsgnn_gat_hidden": 64,
        "fsgnn_ppr_delta": 0.15,
        "fsgnn_ppr_iter": 30,
        "fsgnn_ppr_topk": 15,
        "fsgnn_knn_k": 15,
        "fsgnn_light_layers": 2,
        "fsgnn_weight_decay": 0.0005,
        "fsgnn_sc_max_edges": 4096,
        "fsgnn_fallback_dim": 32,
        "fsgnn_dropout_cold_side_only": True,
        "fsgnn_id_residual": False,
        "fsgnn_sc_layers": 2,
        "fsgnn_knn_weighted": True,
        "fsgnn_ppr_weighted": True,
        "fsgnn_fc_decoder_layers": 2,
        "fsgnn_lfc_cold_side_only": True,
    },
    "USIM": {
        "actor_lr": 0.0005,
        "critic_lr": 0.001,
        "gamma": 0.99,
        "usim_max_time": 7,
        "usim_transition_rate": 0.05,
        "usim_k": 10,
        "usim_reward_weight": 0.5,
        "usim_reward_cost": 0.2,
        "usim_optimize_batch": 20480,
        "usim_buffer_max_len": 1024,
        "usim_content_hidden": 150,
        "usim_actor_weight_decay": 1e-6,
        "usim_critic_weight_decay": 1e-6,
        "usim_mapper_ckpt": "",
    },
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

def require_ported(model: str) -> None:
    """Raise ``ValueError`` unless ``model`` runs in the port."""
    if model in MODEL_PARAM_REGISTRY:
        return
    raise ValueError(
        f"Invalid model name: {model}. Ported: {sorted(MODEL_PARAM_REGISTRY)}")


def registry_defaults(model: str) -> dict:
    """The model's own flags and its common-flag overrides, with their
    defaults, for ``default_args``."""
    require_ported(model)
    spec = dict(MODEL_PARAM_REGISTRY[model])
    out = dict(spec.pop("_overrides", {}))
    out.update(spec)
    return out


def add_model_params(model: str, parser: argparse.ArgumentParser):
    require_ported(model)
    spec = dict(MODEL_PARAM_REGISTRY[model])
    overrides = spec.pop("_overrides", None)
    if overrides:
        parser.set_defaults(**overrides)
    for name, default in spec.items():
        if isinstance(default, bool):
            parser.add_argument(f"--{name}", type=_str2bool, nargs="?",
                                const=True, default=default)
        elif isinstance(default, list):
            parser.add_argument(f"--{name}", type=_float_pair,
                                default=default)
        else:
            parser.add_argument(f"--{name}", type=type(default),
                                default=default)
    return parser


def _str2bool(v):
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("1", "true", "t", "yes", "y", "on"):
        return True
    if s in ("0", "false", "f", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean value, got {v!r}")


def _float_pair(v):
    """An (lr, wd) optimizer pair from "0.05,0" or "[0.05, 0]"
    (model_param.py:17-33)."""
    if isinstance(v, (list, tuple)):
        values = list(v)
    else:
        s = str(v).strip()
        try:
            parsed = ast.literal_eval(s)
        except (SyntaxError, ValueError):
            parsed = s.split(",")
        values = list(parsed) if isinstance(parsed, (list, tuple)) else [
            parsed]
    if len(values) != 2:
        raise argparse.ArgumentTypeError(f"expected two floats, got {v!r}")
    return [float(values[0]), float(values[1])]
