"""Process group, mesh and sharded ops of the port (``torch.distributed``);
the counterpart of ``coldrec_tpu/parallel``."""
from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
