"""coldrec_tpu_torch — the PyTorch/CUDA port of coldrec_tpu for one NVIDIA H100.

The JAX package ``coldrec_tpu`` stays the reference; this package mirrors its
module names so each counterpart is easy to find, and imports neither JAX nor
anything of ``coldrec_tpu``: where it needs a numpy-only module of the JAX
package it keeps its own copy.

Layers (the main path, ``python -m coldrec_tpu_torch.main --model MF``):
  - ``main``     the CLI: runs, seeds, aggregation, the result file.
  - ``config``   the JAX CLI's flags and defaults, plus ``--device``.
  - ``models``   ``MF`` (tables, BPR + L2 loss) and ``MFTrainer`` on the
                 shared warm-backbone loop (Adam, per-epoch validation,
                 early stop, train-state resume, the embedding bus); the
                 graph backbones (LightGCN, NGCF, SimGCL, XSimGCL, NCL) and
                 the cold-start models on the same loop.
  - ``data``     host-side split protocol, id remap, eval-split ground truth,
                 BPR batches from the native negative sampler (``native``,
                 ``csrc/host_sampler.cpp``).
  - ``ops``      the losses, the graph SpMM, k-means; ``ops.cuda``: the
                 hand-written Hopper retrieval
                 kernel (``csrc/``), its nvcc + ctypes build and its plain
                 PyTorch version.
  - ``runtime``  trainer contract, eval sweep, three-way test, checkpoints
                 (npz bus, train state), serving.
  - ``parallel`` the process group (``torch.distributed``), the data x
                 model mesh, the sharded lookup, SpMM and retrieval, and a
                 dry run of them on N ranks.

Every public entry point runs on ``device="cuda"`` unless the caller passes
``device="cpu"``; with no card the default raises instead of falling back.
"""

__version__ = "0.1.0"
