"""Multi-head attention core (counterpart of ``spmm_tpu.ops.attention``).

Two implementations behind one interface (reference xbert.py:304-350
semantics: fp32 scores scaled by 1/sqrt(head_dim), the additive mask before
an fp32 softmax, probabilities cast to ``v``'s dtype before the product
with V):

  - impl="plain"   matmul -> fp32 softmax -> matmul (default, as "xla" is in
                   the JAX package);
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


def multi_head_attention(
    q: torch.Tensor,  # [B, h, Lq, D]
    k: torch.Tensor,  # [B, h, Lk, D]
    v: torch.Tensor,  # [B, h, Lk, D]
    additive_mask: Optional[torch.Tensor] = None,  # broadcastable to [B, h, Lq, Lk]
    impl: str = "plain",
) -> torch.Tensor:
    """Scaled dot-product attention; returns [B, h, Lq, D] in v's dtype."""
    if impl == "kernel":
        return fused_mha(q, k, v, additive_mask)
    if impl != "plain":
        raise ValueError(f"unknown attention impl {impl!r}")
    # bf16 operands upcast exactly, so the fp32 product equals an fp32-
    # accumulated bf16 product (JAX's preferred_element_type=float32)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(
        q.shape[-1])
    if additive_mask is not None:
        scores = scores + additive_mask.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)
