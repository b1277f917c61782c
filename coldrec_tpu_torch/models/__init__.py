"""Model registry (the port's counterpart of ``coldrec_tpu/models/__init__``;
reference: model/__init__.py AVAILABLE_MODELS): all 26 models map to their
trainers; any other name raises ``ValueError``."""
from ..config.model_params import require_ported
from .agnn import AGNNTrainer
from .aldi import ALDITrainer
from .amr import AMRTrainer
from .ccfcrec import CCFCRecTrainer
from .cgrc import CGRCTrainer
from .clcrec import CLCRecTrainer
from .deepmusic import DeepMusicTrainer
from .dropoutnet import DropoutNetTrainer
from .duif import DUIFTrainer
from .fsgnn import FSGNNTrainer
from .gar import GARTrainer
from .gorec import GoRecTrainer
from .heater import HeaterTrainer
from .knn import KNNTrainer
from .lara import LARATrainer
from .lightgcn import LightGCNTrainer
from .m2vae import M2VAETrainer
from .metaembedding import MetaEmbeddingTrainer
from .mf import MF, MFTrainer
from .mtpr import MTPRTrainer
from .ncl import NCLTrainer
from .ngcf import NGCFTrainer
from .simgcl import SimGCLTrainer
from .usim import USIMTrainer
from .vbpr import VBPRTrainer
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
    "KNN": KNNTrainer,
    "AGNN": AGNNTrainer,
    "VBPR": VBPRTrainer,
    "AMR": AMRTrainer,
    "MTPR": MTPRTrainer,
    "MetaEmbedding": MetaEmbeddingTrainer,
    "LARA": LARATrainer,
    "CLCRec": CLCRecTrainer,
    "GoRec": GoRecTrainer,
    "CCFCRec": CCFCRecTrainer,
    "M2VAE": M2VAETrainer,
    "CGRC": CGRCTrainer,
    "FSGNN": FSGNNTrainer,
    "USIM": USIMTrainer,
}

__all__ = ["MF", "MFTrainer", "TRAINERS", "model_factory"]


def model_factory(config):
    """Instantiate a trainer by ``config.args.model`` (reference
    main.py:60-80)."""
    require_ported(config.args.model)
    return TRAINERS[config.args.model](config)
