"""Attention-map introspection (counterpart of ``spmm_tpu.models.introspect``;
reference xbert.py:251-263, the ``save_attention_map`` hook behind the
paper's interpretability figures).

Rather than a hook that stores maps during a forward, the fusion stack is
replayed and each layer's cross-attention probabilities are recomputed
with the plain matmul-softmax (kernel 2 returns no probabilities).  No
gradient is taken and no dropout is drawn.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from spmm_tpu_torch.configs import BertArchConfig
from spmm_tpu_torch.models.bert import BertAttention, BertModel, split_heads
from spmm_tpu_torch.ops.masks import extend_attention_mask, invert_encoder_mask

Tensor = torch.Tensor


def _attention_probs(attn: BertAttention, cfg: BertArchConfig,
                     hidden: Tensor, kv_source: Tensor,
                     additive_mask: Optional[Tensor]) -> Tensor:
    """softmax(q k^T / sqrt(D) + mask) in fp32, [B, h, Lq, Lk]
    (spmm_tpu/models/introspect.py:22-33)."""
    h = cfg.num_attention_heads
    q = split_heads(attn.self.query(hidden), h)
    k = split_heads(attn.self.key(kv_source), h)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)
                          ) / math.sqrt(cfg.head_dim)
    if additive_mask is not None:
        scores = scores + additive_mask
    return torch.softmax(scores, dim=-1)


def _bert(model_or_bert: nn.Module) -> BertModel:
    """The text BERT of an SPMM or of a BertForMaskedLM, or a BertModel."""
    if isinstance(model_or_bert, BertModel):
        return model_or_bert
    if hasattr(model_or_bert, "bert"):
        return model_or_bert.bert
    return model_or_bert.text_encoder.bert


@torch.no_grad()
def cross_attention_maps(
    model_or_bert: nn.Module,
    cfg: BertArchConfig,
    encoder_embeds: Tensor,          # queries, already encoded [B, Lq, H]
    attention_mask: Tensor,          # [B, Lq]
    encoder_hidden_states: Tensor,   # keys [B, Lk, H]
    encoder_attention_mask: Optional[Tensor] = None,
) -> list[Tensor]:
    """One fp32 [B, heads, Lq, Lk] probability tensor per fusion layer.

    Replays layers [fusion_layer, num_hidden_layers) as the fusion section
    runs them (spmm_tpu/models/introspect.py:46-64): the self-attention
    block, the cross-attention softmax (what the reference's hook records),
    the cross-attention block, the MLP."""
    bert = _bert(model_or_bert)
    if encoder_attention_mask is None:
        encoder_attention_mask = torch.ones(
            encoder_hidden_states.shape[:2], dtype=torch.int32,
            device=encoder_hidden_states.device)
    self_mask = extend_attention_mask(attention_mask)
    cross_mask = invert_encoder_mask(encoder_attention_mask)
    maps = []
    hidden = encoder_embeds
    for i in range(cfg.fusion_layer, cfg.num_hidden_layers):
        layer = bert.encoder.layer[i]
        hidden = layer.attention(hidden, hidden, self_mask)
        maps.append(_attention_probs(layer.crossattention, cfg, hidden,
                                     encoder_hidden_states, cross_mask))
        hidden = layer.crossattention(hidden, encoder_hidden_states,
                                      cross_mask)
        hidden = layer.mlp(hidden)
    return maps
