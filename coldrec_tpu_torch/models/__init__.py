"""Model registry (the port's counterpart of ``coldrec_tpu/models/__init__``;
reference: model/__init__.py AVAILABLE_MODELS). MF is the one model ported;
the others raise ``ValueError`` naming the ROADMAP item that brings them."""
from ..config.model_params import require_ported
from .mf import MF, MFTrainer

TRAINERS = {"MF": MFTrainer}

__all__ = ["MF", "MFTrainer", "TRAINERS", "model_factory"]


def model_factory(config):
    """Instantiate a trainer by ``config.args.model`` (reference
    main.py:60-80)."""
    require_ported(config.args.model)
    return TRAINERS[config.args.model](config)
