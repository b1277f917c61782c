from .base import default_args, make_args
from .model_params import MODEL_PARAM_REGISTRY, add_model_params

__all__ = ["default_args", "make_args", "MODEL_PARAM_REGISTRY", "add_model_params"]
