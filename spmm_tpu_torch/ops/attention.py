"""Multi-head attention core (counterpart of ``spmm_tpu.ops.attention``).

The plain path of the JAX function (reference xbert.py:304-350 semantics):
fp32 scores scaled by 1/sqrt(head_dim), the additive mask before an fp32
softmax, probabilities cast to ``v``'s dtype before the product with V.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def multi_head_attention(
    q: torch.Tensor,  # [B, h, Lq, D]
    k: torch.Tensor,  # [B, h, Lk, D]
    v: torch.Tensor,  # [B, h, Lk, D]
    additive_mask: Optional[torch.Tensor] = None,  # broadcastable to [B, h, Lq, Lk]
    impl: str = "plain",
) -> torch.Tensor:
    """Scaled dot-product attention; returns [B, h, Lq, D] in v's dtype."""
    if impl == "pallas":
        raise NotImplementedError(
            "the fused attention kernel (spmm_tpu/ops/pallas_attention.py "
            "pallas_mha) is not ported yet: ROADMAP.md queue 2, item 2")
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
