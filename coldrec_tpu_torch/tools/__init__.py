"""The kernel-variant experiments of the retrieval sweep, on the card.

Counterparts of the JAX package's ``tools/exp_retrieval_kernels.py``,
``tools/exp_multiacc.py`` and ``tools/exp_blockskip.py``: each holds its
variants' wrappers (hand-written CUDA kernels in ``coldrec_tpu_torch/csrc``),
their plain PyTorch versions and the tool's command line
(``python -m coldrec_tpu_torch.tools.<name>``).

``tile_shapes`` is the port's own tool: it builds the retrieval sweep and
the dot ceiling at other tile shapes and times them
(``python -m coldrec_tpu_torch.tools.tile_shapes``); ``profile_train``
splits one MF training step's time on the card
(``python -m coldrec_tpu_torch.tools.profile_train``)."""
