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
(``python -m coldrec_tpu_torch.tools.profile_train``).

The JAX tools that drive the system at scale have counterparts here too:
``scale_run`` (whole CLI runs at a published dataset shape, timed),
``ubench_serving`` (``RetrievalServer``'s latency and device time, fp32
against bf16), ``ubench_sweep`` (the sweep beside its ceilings, for
``ubench_retrieval``, ``exp_bf16_isolate``, ``exp_d256_bf16`` and
``ubench_kernel_variants``) and ``ubench_spmm`` (the ELL SpMM's forms, for
``ubench_spmm`` and ``exp_spmm_layouts``). So do the MF step tools:
``profile_train --split`` / ``--chain`` / ``--scatter`` (for
``exp_mf_step_decomp``, ``exp_grad_sorted``, ``check_mfstep`` and
``exp_scatter_variants``) and ``exp_fused_steps``; and the USIM tools:
``profile_usim`` (for ``profile_usim``, ``profile_usim_bx`` and
``usim_roofline``)."""
