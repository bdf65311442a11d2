"""Downstream MoleculeNet models: classification / multi-label / regression
(counterpart of ``spmm_tpu.models.downstream``).

The reference builds these by loading the 12-layer text encoder and replacing
layers >= fusion_layer with nn.Identity, leaving the 6-layer unimodal SMILES
encoder (reference d_classification.py:26-49, d_regression.py:24-49,
d_classification_multilabel.py:25-47).  Here, as in the JAX package, the
truncation is structural: ``Downstream`` holds only the first
``fusion_layer`` layers, under the pretrain checkpoint's names
(``text_encoder.bert.*``), and the forward runs mode='text'.

Heads ``l1`` / ``l2`` (torch-default Linear init, as the reference's
un-pretrained heads):
  classification  Linear(H, H)  - GELU - Linear(H, 2);    CE loss
  multilabel      Linear(H, H)  - GELU - Linear(H, n);    BCE(sigmoid) loss
  regression      Linear(H, 2H) - GELU - Linear(2H, 1);   MSE loss
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from spmm_tpu_torch.configs import BertArchConfig, text_config
from spmm_tpu_torch.models.bert import BertModel
from spmm_tpu_torch.models.spmm import _init_weights
from spmm_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor

TASKS = ("classification", "multilabel", "regression")


def truncated_text_config(cfg: Optional[BertArchConfig] = None) -> BertArchConfig:
    """12-layer text config truncated to its unimodal section."""
    cfg = cfg or text_config()
    return dataclasses.replace(
        cfg, num_hidden_layers=cfg.fusion_layer, add_cross_attention=False)


class _TextEncoder(nn.Module):
    """Holds the encoder as ``bert``, so that its weights carry the pretrain
    checkpoint's ``text_encoder.bert.`` names."""

    def __init__(self, cfg: BertArchConfig):
        super().__init__()
        self.bert = BertModel(cfg)


class Downstream(nn.Module):
    """The truncated text encoder and a two-layer head for ``task``.
    ``cfg`` is the full text config; the model truncates it."""

    def __init__(self, task: str, cfg: Optional[BertArchConfig] = None,
                 n_output: int = 2):
        super().__init__()
        if task not in TASKS:
            raise ValueError(f"unknown task {task!r}")
        self.task = task
        self.cfg = truncated_text_config(cfg)
        h = self.cfg.hidden_size
        width, n_out = (2 * h, 1) if task == "regression" else (h, n_output)
        self.text_encoder = _TextEncoder(self.cfg)
        self.l1 = nn.Linear(h, width)
        self.l2 = nn.Linear(width, n_out)

    @classmethod
    def random_init(cls, seed: int, task: str,
                    cfg: Optional[BertArchConfig] = None, n_output: int = 2,
                    device=None) -> "Downstream":
        """Encoder HF-style (normal(0.02), zero biases, the pad row zeroed),
        heads as torch's Linear default: weight and bias U(-1/sqrt(fan_in),
        1/sqrt(fan_in)) (spmm_tpu/models/downstream.py:42-49).  Made on the
        CPU from ``seed`` with its own generator, moved to ``device``."""
        dev = resolve_device(device)
        model = cls(task, cfg, n_output)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            bert = model.text_encoder.bert
            _init_weights(bert, model.cfg.initializer_range, gen)
            bert.embeddings.word_embeddings.weight[model.cfg.pad_token_id].zero_()
            for lin in (model.l1, model.l2):
                bound = 1.0 / math.sqrt(lin.in_features)
                lin.weight.uniform_(-bound, bound, generator=gen)
                lin.bias.uniform_(-bound, bound, generator=gen)
        return model.to(dev)


def load_encoder_from_pretrain(model: Downstream,
                               state: Mapping[str, Tensor]) -> Downstream:
    """Load a reference-named pretrain state's text encoder into the
    truncated encoder, in place, keeping only the unimodal layers (the
    reference's strict=False load over Identity-replaced layers has the same
    effect; d_classification.py:145-151; spmm_tpu/models/downstream.py:
    80-94).  ``_unk`` is renamed ``_mask`` (reference d_regression.py:
    157-161).  Raises KeyError if an encoder weight is missing."""
    prefix = "text_encoder.bert."
    src = {k.replace("_unk", "_mask")[len(prefix):]: v
           for k, v in state.items() if k.startswith(prefix)}
    bert = model.text_encoder.bert
    keys = list(bert.state_dict())
    missing = [k for k in keys if k not in src]
    if missing:
        raise KeyError(f"the pretrain state lacks {len(missing)} encoder "
                       f"weights, e.g. {prefix}{missing[0]}")
    bert.load_state_dict({k: src[k] for k in keys}, strict=True)
    return model


def downstream_forward(model: Downstream, input_ids: Tensor,
                       attention_mask: Tensor, attention_impl: str = "plain",
                       generator: Optional[torch.Generator] = None) -> Tensor:
    """CLS hidden -> head output (logits / regression value).  With
    ``attention_impl="kernel"`` every attention runs through kernel 2 (no
    gradient, no dropout); a ``generator`` turns dropout on."""
    hidden = model.text_encoder.bert(
        input_ids=input_ids, attention_mask=attention_mask, mode="text",
        attention_impl=attention_impl, generator=generator)[:, 0]
    return model.l2(F.gelu(model.l1(hidden)))


def downstream_loss(model: Downstream, input_ids: Tensor,
                    attention_mask: Tensor, targets: Tensor,
                    generator: Optional[torch.Generator] = None) -> Tensor:
    """The task's loss on the plain attention (spmm_tpu/models/downstream.py:
    116-138): mean CE of the logits for classification (int targets);
    for multilabel the mean of -(t log(sigmoid(x) + 1e-12) + (1 - t)
    log(1 - sigmoid(x) + 1e-12)), which saturates as JAX's does where
    ``binary_cross_entropy_with_logits`` would not; MSE for regression."""
    out = downstream_forward(model, input_ids, attention_mask,
                             generator=generator)
    if model.task == "classification":
        return F.cross_entropy(out, targets.long())
    if model.task == "multilabel":
        p = torch.sigmoid(out)
        eps = 1e-12
        return -(targets * torch.log(p + eps)
                 + (1 - targets) * torch.log(1 - p + eps)).mean()
    return torch.mean(torch.square(out[:, 0] - targets))
