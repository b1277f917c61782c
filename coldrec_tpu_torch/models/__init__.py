"""Model registry (the port's counterpart of ``coldrec_tpu/models/__init__``;
reference: model/__init__.py AVAILABLE_MODELS). The ported models map to
their trainers; the others raise ``ValueError`` naming the ROADMAP item
that brings them."""
from ..config.model_params import require_ported
from .aldi import ALDITrainer
from .deepmusic import DeepMusicTrainer
from .dropoutnet import DropoutNetTrainer
from .duif import DUIFTrainer
from .gar import GARTrainer
from .heater import HeaterTrainer
from .lightgcn import LightGCNTrainer
from .mf import MF, MFTrainer
from .ncl import NCLTrainer
from .ngcf import NGCFTrainer
from .simgcl import SimGCLTrainer
from .xsimgcl import XSimGCLTrainer

TRAINERS = {
    "MF": MFTrainer,
    "DropoutNet": DropoutNetTrainer,
    "GAR": GARTrainer,
    "ALDI": ALDITrainer,
    "DeepMusic": DeepMusicTrainer,
    "DUIF": DUIFTrainer,
    "Heater": HeaterTrainer,
    "LightGCN": LightGCNTrainer,
    "NGCF": NGCFTrainer,
    "SimGCL": SimGCLTrainer,
    "XSimGCL": XSimGCLTrainer,
    "NCL": NCLTrainer,
}

__all__ = ["MF", "MFTrainer", "TRAINERS", "model_factory"]


def model_factory(config):
    """Instantiate a trainer by ``config.args.model`` (reference
    main.py:60-80)."""
    require_ported(config.args.model)
    return TRAINERS[config.args.model](config)
