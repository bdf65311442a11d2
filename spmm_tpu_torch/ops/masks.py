"""Additive attention-mask construction (counterpart of ``spmm_tpu.ops.masks``).

Masked positions receive an additive ``-10000.0`` (NOT -inf) on the
pre-softmax scores (reference xbert.py:941-948); binary masks are 1 = attend.
"""

from __future__ import annotations

import torch

MASK_VALUE = -10000.0


def extend_attention_mask(mask: torch.Tensor,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Binary padding mask [B, L] -> additive [B, 1, 1, L]."""
    return ((1.0 - mask.to(dtype)) * MASK_VALUE)[:, None, None, :]


def extend_causal_mask(mask: torch.Tensor, q_len: int, past_len: int = 0,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Binary padding mask [B, K] -> additive causal mask [B, 1, Q, K].

    Query row q may attend key position k iff ``k <= past_len + q`` and the
    key is not padding (``K = past_len + q_len``).
    """
    k_len = mask.shape[-1]
    q_pos = torch.arange(q_len, device=mask.device)[:, None] + past_len
    k_pos = torch.arange(k_len, device=mask.device)[None, :]
    causal = (k_pos <= q_pos).to(dtype)  # [Q, K]
    combined = causal[None, :, :] * mask.to(dtype)[:, None, :]
    return ((1.0 - combined) * MASK_VALUE)[:, None, :, :]


def invert_encoder_mask(mask: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Cross-attention mask over encoder keys: [B, L_enc] -> [B, 1, 1, L_enc]."""
    return extend_attention_mask(mask, dtype)
