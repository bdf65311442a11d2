"""SPMM task model (counterpart of ``spmm_tpu.models.spmm``).

The inference surface of the reference SPMM module (SPMM_models.py:16-77):

  text_encoder        12L chem-BERT + LM head (fusion layers 6-11 cross-attend)
  property_encoder    6L chem-BERT, driven purely via inputs_embeds
  property_embed      Linear(1 -> 768) applied per scalar property
  property_cls        learned [1, 1, 768] CLS vector of the PV sequence
  property_mask       learned [1, 1, 768] vector for masked properties
  property_mtr_head   Linear-GELU-LayerNorm-Linear(768 -> 1)
  property_proj / text_proj / itm_head   optional pretraining heads

Momentum twins, the temperature and the feature queues are training state:
``training.pretrain.PretrainModel`` adds them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from spmm_tpu_torch.configs import BertArchConfig, property_config, text_config
from spmm_tpu_torch.models.bert import (BertForMaskedLM, BertModel, LayerNorm,
                                        Linear)

N_PROPERTIES = 53
EMBED_DIM = 256          # contrastive projection width


def _init_weights(module: nn.Module, std: float,
                  generator: torch.Generator) -> None:
    """HF BertPreTrainedModel._init_weights: normal(std) weights, zero
    biases, LayerNorm 1/0."""
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding)):
            nn.init.normal_(mod.weight, 0.0, std, generator=generator)
        if isinstance(mod, nn.Linear) and mod.bias is not None:
            nn.init.zeros_(mod.bias)
        if isinstance(mod, LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)


class SPMM(nn.Module):
    def __init__(self, text_cfg: Optional[BertArchConfig] = None,
                 prop_cfg: Optional[BertArchConfig] = None,
                 with_pretrain_heads: bool = False,
                 embed_dim: int = EMBED_DIM):
        super().__init__()
        self.text_cfg = text_cfg = text_cfg or text_config()
        self.prop_cfg = prop_cfg = prop_cfg or property_config()
        h = text_cfg.hidden_size
        self.text_encoder = BertForMaskedLM(text_cfg)
        self.property_encoder = BertModel(prop_cfg)
        self.property_embed = Linear(1, h)
        self.property_cls = nn.Parameter(torch.zeros(1, 1, h))
        self.property_mask = nn.Parameter(torch.zeros(1, 1, h))
        self.property_mtr_head = nn.Sequential(
            Linear(h, h), nn.GELU(), LayerNorm(h, text_cfg.layer_norm_eps),
            Linear(h, 1))
        if with_pretrain_heads:
            self.property_proj = Linear(h, embed_dim)
            self.text_proj = Linear(h, embed_dim)
            self.itm_head = Linear(2 * h, 2)

    @classmethod
    def random_init(cls, seed: int, text_cfg: Optional[BertArchConfig] = None,
                    prop_cfg: Optional[BertArchConfig] = None,
                    device=None, with_pretrain_heads: bool = False,
                    embed_dim: int = EMBED_DIM) -> "SPMM":
        """HF-style random init from ``seed`` (normal(0.02)), made on the CPU
        with its own generator and moved to ``device``;
        ``with_pretrain_heads`` adds the projections and the ITM head."""
        from spmm_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
        model = cls(text_cfg, prop_cfg, with_pretrain_heads, embed_dim)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            _init_weights(model, model.text_cfg.initializer_range, gen)
            # padding row zeroed like nn.Embedding(padding_idx=0)
            for bert in (model.text_encoder.bert, model.property_encoder):
                bert.embeddings.word_embeddings.weight[
                    bert.cfg.pad_token_id].zero_()
        return model.to(dev).eval()

    def embed_properties(self, values: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """property scalars [B, 53] -> [B, 54, H] input embeddings: a
        per-scalar Linear(1->H), masked positions (mask 1) replaced by the
        learned mask vector, the learned CLS vector prepended (reference
        SPMM_models.py:82-88)."""
        b = values.shape[0]
        feat = self.property_embed(values[..., None])            # [B, 53, H]
        if mask is not None:
            m = mask[..., None].to(feat.dtype)
            feat = feat * (1.0 - m) + self.property_mask * m
        cls = self.property_cls.expand(b, 1, feat.shape[-1])
        return torch.cat([cls, feat], dim=1)

    def encode_properties(self, prop_inputs: torch.Tensor,
                          attention_mask: Optional[torch.Tensor] = None,
                          is_decoder: bool = False,
                          attention_impl: str = "plain",
                          generator: Optional[torch.Generator] = None,
                          remat: bool = False) -> torch.Tensor:
        """6-layer property encoder over injected embeddings (reference
        SPMM_models.py:90; ``is_decoder``: the causal variant of MPM,
        :242)."""
        return self.property_encoder(inputs_embeds=prop_inputs,
                                     attention_mask=attention_mask,
                                     is_decoder=is_decoder, mode="multi_modal",
                                     attention_impl=attention_impl,
                                     generator=generator, remat=remat)

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor,
                    attention_impl: str = "plain",
                    generator: Optional[torch.Generator] = None,
                    remat: bool = False) -> torch.Tensor:
        """Unimodal SMILES encoding, layers [0, fusion) (``encode_text``,
        reference SPMM_models.py:94)."""
        return self.text_encoder.bert(input_ids=input_ids,
                                      attention_mask=attention_mask,
                                      mode="text",
                                      attention_impl=attention_impl,
                                      generator=generator, remat=remat)

    def mtr_head_forward(self, hidden: torch.Tensor) -> torch.Tensor:
        """property_mtr_head, Linear-GELU-LN-Linear -> one scalar per
        position (``mtr_head_forward``, reference SPMM_models.py:39-42)."""
        return self.property_mtr_head(hidden)[..., 0]
