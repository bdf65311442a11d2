"""SPMM in PyTorch for NVIDIA Hopper.

The PyTorch counterpart of ``spmm_tpu`` (the JAX/TPU package, which stays the
reference): module names mirror ``spmm_tpu``'s so each counterpart is easy to
find.  This package imports ``torch`` only — never ``jax`` and nothing of
``spmm_tpu`` — and keeps its own copies of the host-side modules it needs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU they raise instead of falling back to the CPU.  Two hand-written
kernels, CUDA C++ built with ``nvcc`` at first use into
``build/spmm_tpu_torch/``, carry the two paths:

  - PV->SMILES beam search: ``ops.decode_attention.beam_decode_attention``
    (``csrc/beam_decode_attention.cu``);
  - SMILES->PV prediction: ``ops.fused_attention.fused_mha``
    (``csrc/fused_attention.cu``), every attention of ``predict_pv``.
"""
