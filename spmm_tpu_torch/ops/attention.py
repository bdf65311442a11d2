"""Multi-head attention core (counterpart of ``spmm_tpu.ops.attention``).

Two implementations behind one interface (reference xbert.py:304-350
semantics: fp32 scores scaled by 1/sqrt(head_dim), the additive mask before
an fp32 softmax, dropout on the probabilities, probabilities cast to
``v``'s dtype before the product with V):

  - impl="plain"   matmul -> fp32 softmax -> dropout -> matmul (default, as
                   "xla" is in the JAX package, and the only path with
                   dropout, i.e. training);
  - impl="kernel"  ``ops.fused_attention.fused_mha``, the counterpart of the
                   JAX package's impl="pallas": the hand-written CUDA kernel
                   on a CUDA tensor, its plain version on a CPU one.  The
                   mask must be head-uniform, as it is in this model family.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from spmm_tpu_torch.ops.fused_attention import fused_mha


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            shape: Optional[tuple] = None,
            index: Optional[tuple] = None) -> torch.Tensor:
    """Inverted dropout as ``_dropout`` of spmm_tpu/models/bert.py:72-76:
    keep with p = 1 - rate, scale the kept values by 1/(1 - rate).  On only
    with a ``generator`` (the JAX functions' ``rng``), whose stream alone
    draws the mask: the global RNG is never touched.  The generator lives on
    ``x``'s device.

    ``x`` may be one rank's shard of a tensor of ``shape`` that one process
    holds whole (its heads under tensor parallelism, its positions under
    sequence parallelism): the mask is then drawn at ``shape`` and cut by
    ``index``, so every rank draws what one process draws and the
    generators of the peers stay in step."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape if shape is None else shape,
                      generator=generator, device=x.device)
    if index is not None:
        keep = keep[index]
    keep = keep < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def multi_head_attention(
    q: torch.Tensor,  # [B, h, Lq, D]
    k: torch.Tensor,  # [B, h, Lk, D]
    v: torch.Tensor,  # [B, h, Lk, D]
    additive_mask: Optional[torch.Tensor] = None,  # broadcastable to [B, h, Lq, Lk]
    impl: str = "plain",
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    heads: Optional[tuple[int, int]] = None,
) -> torch.Tensor:
    """Scaled dot-product attention; returns [B, h, Lq, D] in v's dtype.
    With a ``generator``, the probabilities go through ``dropout`` at
    ``dropout_rate`` (spmm_tpu/ops/attention.py:50-52).  ``heads`` =
    (first, total) says that q, k and v hold heads [first, first + h) of
    ``total`` (a tensor-parallel rank's): the dropout mask is drawn for all
    ``total`` heads and cut to these."""
    if impl == "kernel":
        if generator is not None and dropout_rate > 0.0:
            raise ValueError("the kernel has no dropout: train with "
                             "attention_impl='plain'")
        return fused_mha(q, k, v, additive_mask)
    if impl != "plain":
        raise ValueError(f"unknown attention impl {impl!r}")
    # bf16 operands upcast exactly, so the fp32 product equals an fp32-
    # accumulated bf16 product (JAX's preferred_element_type=float32); also
    # under autocast (the pretrain step's bf16_compute), which would round
    # the scores to bf16
    with torch.autocast(q.device.type, enabled=False):
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)
                              ) / math.sqrt(q.shape[-1])
    if additive_mask is not None:
        scores = scores + additive_mask.float()
    shape = index = None
    if heads is not None:
        first, total = heads
        shape = (scores.shape[0], total) + scores.shape[2:]
        index = (slice(None), slice(first, first + scores.shape[1]))
    probs = dropout(torch.softmax(scores, dim=-1), dropout_rate, generator,
                    shape, index)
    return torch.matmul(probs.to(v.dtype), v)
