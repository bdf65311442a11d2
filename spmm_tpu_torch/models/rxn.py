"""Reaction-prediction model (counterpart of ``spmm_tpu.models.rxn``;
reference SPMM_models_rxn.py:8-46): an encoder-decoder over two chem-BERT
stacks.

  text_encoder2  6-layer unimodal SMILES encoder of the reactants
                 (``smiles_config``), initialised from a pretrain
                 checkpoint's text encoder (``load_encoder_from_pretrain``);
  text_encoder   12-layer decoder (``text_config``) whose fusion layers
                 cross-attend over the encoder's hiddens.

The submodules carry the reference names, so a reference-named state dict
(``checkpoint.convert.rxn_state_dict_from_jax_tree`` of a JAX tree) loads
with ``strict=True``.  ``rxn_loss`` is the fine-tune loss: teacher-forced
next-token cross-entropy that ignores pads (id 0), unlike the pretrain MLM
loss (reference SPMM_models_rxn.py:44), with dropout in both stacks when
given a generator.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from spmm_tpu_torch.configs import BertArchConfig, smiles_config, text_config
from spmm_tpu_torch.models.bert import BertForMaskedLM
from spmm_tpu_torch.models.spmm import _init_weights

Tensor = torch.Tensor


class Rxn(nn.Module):
    def __init__(self, decoder_cfg: Optional[BertArchConfig] = None,
                 encoder_cfg: Optional[BertArchConfig] = None):
        super().__init__()
        self.decoder_cfg = decoder_cfg = decoder_cfg or text_config()
        self.encoder_cfg = encoder_cfg = encoder_cfg or smiles_config()
        self.text_encoder = BertForMaskedLM(decoder_cfg)
        self.text_encoder2 = BertForMaskedLM(encoder_cfg)

    @classmethod
    def random_init(cls, seed: int,
                    decoder_cfg: Optional[BertArchConfig] = None,
                    encoder_cfg: Optional[BertArchConfig] = None,
                    device=None) -> "Rxn":
        """HF-style random init from ``seed`` (normal(0.02)), made on the CPU
        with its own generator and moved to ``device``."""
        from spmm_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
        model = cls(decoder_cfg, encoder_cfg)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            _init_weights(model, model.decoder_cfg.initializer_range, gen)
            for mlm in (model.text_encoder, model.text_encoder2):
                emb = mlm.bert.embeddings.word_embeddings.weight
                emb[mlm.cfg.pad_token_id].zero_()
        return model.to(dev).eval()


def load_encoder_from_pretrain(model: Rxn,
                               state: Mapping[str, Tensor]) -> Rxn:
    """Initialise ``text_encoder2`` from a reference-named SPMM state dict's
    text encoder, in place (``load_encoder_from_pretrain`` and ``_tree`` of
    spmm_tpu/models/rxn.py:43-79; reference SPMM_models_rxn.py:16-29).

    ``text_encoder.`` is stripped; the embeddings, layers [0, n) without
    their cross-attention and the LM head transfer; the upper layers have
    no place in the encoder and are dropped.  The tied LM-head weight is
    the word table and the head's bias ``cls.predictions.bias``, as in the
    JAX converter.  Raises KeyError if an encoder weight is missing."""
    enc = model.text_encoder2
    prefix = "text_encoder."
    src = {k[len(prefix):]: v for k, v in state.items()
           if k.startswith(prefix)}
    if enc.cfg.tie_word_embeddings:
        src["cls.predictions.decoder.weight"] = src.get(
            "bert.embeddings.word_embeddings.weight")
    src["cls.predictions.decoder.bias"] = src.get("cls.predictions.bias")
    keys = list(enc.state_dict())
    missing = [k for k in keys if src.get(k) is None]
    if missing:
        raise KeyError(f"the pretrain state lacks {len(missing)} encoder "
                       f"weights, e.g. {prefix}{missing[0]}")
    enc.load_state_dict({k: src[k] for k in keys}, strict=True)
    return model


def encode_reactants(model: Rxn, input_ids: Tensor, attention_mask: Tensor,
                     attention_impl: str = "kernel",
                     generator: Optional[torch.Generator] = None) -> Tensor:
    """The reactant encoder, ``mode="text"`` over all of its layers
    (fusion_layer = num_hidden_layers; reference SPMM_models_rxn.py:34).
    With ``attention_impl="kernel"`` every attention goes through
    ``ops.fused_attention.fused_mha``; a ``generator`` turns dropout on."""
    return model.text_encoder2.bert(input_ids=input_ids,
                                    attention_mask=attention_mask,
                                    mode="text",
                                    attention_impl=attention_impl,
                                    generator=generator)


def rxn_loss(model: Rxn, src_ids: Tensor, src_mask: Tensor, tgt_ids: Tensor,
             tgt_mask: Tensor,
             generator: Optional[torch.Generator] = None) -> Tensor:
    """Teacher-forced next-token cross-entropy over the product tokens,
    ignore_index 0, mean over the kept labels (spmm_tpu/models/rxn.py:99-124;
    reference SPMM_models_rxn.py:31-46), on the plain attention: the fused
    kernel has no backward.  With a ``generator`` dropout runs in both
    stacks, the encoder drawing from it first, then the decoder (JAX splits
    its rng between the two)."""
    enc = encode_reactants(model, src_ids, src_mask, attention_impl="plain",
                           generator=generator)
    logits = model.text_encoder(
        input_ids=tgt_ids, attention_mask=tgt_mask,
        encoder_hidden_states=enc, encoder_attention_mask=src_mask,
        is_decoder=True, generator=generator)[:, :-1]
    labels = tgt_ids[:, 1:].long()
    nll = F.cross_entropy(logits.float().transpose(1, 2), labels,
                          ignore_index=0, reduction="sum")
    return nll / (labels != 0).sum().clamp_min(1)
