"""Chem-BERT core as ``nn.Module``s (counterpart of ``spmm_tpu.models.bert``).

Inference forward of the ALBEF-style sectioned BERT the reference builds in
xbert.py: layers ``>= fusion_layer`` also carry cross-attention, and a
forward runs one of three sections (``_layer_range``):

  - ``mode='text'``        : layers [0, fusion_layer)
  - ``mode='fusion'``      : layers [fusion_layer, n_layers)
  - ``mode='multi_modal'`` : all layers

Submodules carry the reference state-dict names (``bert.encoder.layer.{i}
.attention.self.query`` ...), so a reference-named state dict — a reference
checkpoint, or ``checkpoint.convert.state_dict_from_jax_tree`` of a JAX
tree — loads with ``strict=True``.  Function counterparts: ``BertEmbeddings``
= ``embeddings_forward``, ``BertAttention`` = ``attention_block``,
``BertLayer.mlp`` = ``mlp_block``, ``BertLayer`` = ``layer_forward``,
``BertEncoder`` = ``encoder_forward``, ``BertModel`` = ``bert_forward``,
``BertLMPredictionHead`` = ``mlm_head_forward``, ``BertForMaskedLM`` =
``mlm_forward``.

Dropout sits at JAX's points (spmm_tpu/models/bert.py:72-76, 117, 150-158,
174): after the embedding LayerNorm, on the attention probabilities, on
the attention output dense and on the MLP output before their residuals,
at ``cfg.hidden_dropout_prob`` / ``cfg.attention_probs_dropout_prob``.  It
is on only when the caller passes a ``torch.Generator`` (``generator=``,
the counterpart of JAX's ``rng`` with ``deterministic=False``), whatever
``train()`` / ``eval()`` say: without one every forward is the inference
forward, bit for bit.

``remat=True`` recomputes each layer in the backward
(``torch.utils.checkpoint``, non-reentrant), as ``encoder_forward``'s
``jax.checkpoint`` does (spmm_tpu/models/bert.py:256-275).
``checkpointed`` rewinds the caller's generator for the recompute, so
that it draws the forward's dropout masks again.

Under tensor parallelism (``parallel.tp``) a rank's q, k and v hold
``num_heads / tp`` whole heads: ``BertAttention`` splits by the head
width, and the attention-probability dropout draws the mask of every head
and keeps this rank's.  Under sequence parallelism (``parallel.sp``) the
residual stream between the blocks holds this rank's positions:
``BertModel`` cuts its input and gathers its output, each block gathers
its input before the projections, and the dropouts before the residual
adds keep this rank's positions of a whole mask.  Outside those contexts
every hook is the identity.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from spmm_tpu_torch.configs import BertArchConfig
from spmm_tpu_torch.ops import split_gemm
from spmm_tpu_torch.ops.split_gemm import split_linear
from spmm_tpu_torch.ops.attention import dropout, multi_head_attention
from spmm_tpu_torch.ops.masks import (
    extend_attention_mask,
    extend_causal_mask,
    invert_encoder_mask,
)
from spmm_tpu_torch.parallel import sp
from spmm_tpu_torch.parallel.mesh import local_tensor, tp_rank

Tensor = torch.Tensor


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 and cast back to the input dtype
    (spmm_tpu/models/bert.py:58-64): bf16 weights enter as fp32 values."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


_PLAIN = (torch.Tensor, nn.Parameter)   # not a DTensor of parallel/


class Linear(nn.Linear):
    """``nn.Linear`` whose fp32 products at inference on a card run on the
    tensor cores: ``ops.split_gemm.split_linear``, three TF32 products held
    to fp32's accuracy.  A call goes there when
      - the module is in eval mode and ``split`` is set: a model loaded for
        inference, whose weights nobody writes while it runs (the kernel
        keeps each weight's TF32 parts).  Training keeps its modules, the
        momentum twins' included, in training mode, and
        ``parallel.fsdp.apply_fsdp`` clears ``split`` (FSDP refills a
        gathered weight in place without a new ``_version``);
      - its input is a plain fp32 CUDA tensor outside autocast, and TF32 is
        not allowed (``torch.backends.cuda.matmul.allow_tf32``: then
        ``F.linear`` runs in TF32, as it did);
      - the weight is a plain fp32 one (not a DTensor of ``parallel``)
        whose widths the kernel takes (N a multiple of 96, K of 32);
      - autograd needs nothing from it (grad mode off, or nothing requires
        a gradient).
    Every other call, and every call on the CPU, is ``F.linear``.
    Parameters and state-dict keys are ``nn.Linear``'s."""

    split = True

    def forward(self, x: Tensor) -> Tensor:
        if x.is_cuda and self.routes(x):
            return split_linear(x, self.weight, self.bias)
        return F.linear(x, self.weight, self.bias)

    def routes(self, x: Tensor) -> bool:
        """Whether a call on ``x`` goes to the kernel, the device aside."""
        w, b = self.weight, self.bias
        return (self.split and not self.training
                and x.dtype == torch.float32 and w.dtype == torch.float32
                and type(x) is torch.Tensor and type(w) in _PLAIN
                and not torch.backends.cuda.matmul.allow_tf32
                and not torch.is_autocast_enabled(x.device.type)
                and split_gemm.takes(*w.shape)
                and not (torch.is_grad_enabled() and (
                    x.requires_grad or w.requires_grad
                    or (b is not None and b.requires_grad))))


def checkpointed(fn: Callable, generator: Optional[torch.Generator],
                 *args, **kwargs):
    """``fn(*args, **kwargs)`` under ``torch.utils.checkpoint`` (non-
    reentrant): its activations are recomputed in the backward.

    The checkpoint restores only the global RNG, while dropout draws from
    ``generator`` (``ops.attention.dropout``).  So the generator's state is
    taken before the forward, set back for the recompute and then returned
    to where the stream had gone: the recompute draws the forward's masks,
    and the stream runs on as it does without remat."""
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)
    start = generator.get_state()
    calls = []

    def run(*a, **kw):
        if not calls:                     # the forward
            calls.append(1)
            return fn(*a, **kw)
        live = generator.get_state()      # a recompute
        generator.set_state(start)
        try:
            return fn(*a, **kw)
        finally:
            generator.set_state(live)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False, **kwargs)


def split_heads(x: Tensor, num_heads: int) -> Tensor:
    b, l, hd = x.shape
    return x.reshape(b, l, num_heads, hd // num_heads).transpose(1, 2)


def local_heads(linear: nn.Linear, head_dim: int) -> int:
    """Heads whose projection ``linear`` computes on this rank: all of
    them, or ``num_heads / tp`` once ``parallel.tp`` shards its outputs."""
    return local_tensor(linear.weight).shape[0] // head_dim


def merge_heads(x: Tensor) -> Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


class BertEmbeddings(nn.Module):
    """word + position + token-type embeddings -> LN.

    ``position_offset`` is the KV-cache prefix length (reference
    xbert.py:203-204); token type is always 0 in this model family."""

    def __init__(self, cfg: BertArchConfig):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, h)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        self.LayerNorm = LayerNorm(h, cfg.layer_norm_eps)
        self.dropout_rate = cfg.hidden_dropout_prob

    def forward(self, input_ids: Optional[Tensor] = None,
                inputs_embeds: Optional[Tensor] = None,
                position_offset: int = 0,
                generator: Optional[torch.Generator] = None) -> Tensor:
        if inputs_embeds is None:
            inputs_embeds = self.word_embeddings(input_ids)
        seq_len = inputs_embeds.shape[1]
        # positions past the table read its last row, as JAX's gather
        # clamps an out-of-range index (spmm_tpu/models/bert.py:112-113)
        positions = torch.arange(
            position_offset, position_offset + seq_len,
            device=inputs_embeds.device).clamp_max(
                self.position_embeddings.num_embeddings - 1)
        x = (inputs_embeds + self.position_embeddings(positions)
             + self.token_type_embeddings.weight[0])
        return dropout(self.LayerNorm(x), self.dropout_rate, generator)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertArchConfig, kv_width: int):
        super().__init__()
        h = cfg.hidden_size
        self.query = Linear(h, h)
        self.key = Linear(kv_width, h)
        self.value = Linear(kv_width, h)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: BertArchConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class BertAttention(nn.Module):
    """Projected MHA + output dense + residual LN (reference xbert.py:362-422).

    ``kv`` supplies precomputed (k, v) head tensors — the cross-attention
    K/V computed once per decode.  ``attention_impl`` picks the attention
    core (``ops.attention.multi_head_attention``'s ``impl``)."""

    def __init__(self, cfg: BertArchConfig, kv_width: int):
        super().__init__()
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.head_dim
        self.probs_dropout = cfg.attention_probs_dropout_prob
        self.hidden_dropout = cfg.hidden_dropout_prob
        self.self = BertSelfAttention(cfg, kv_width)
        self.output = BertSelfOutput(cfg)

    def forward(self, hidden: Tensor, kv_source: Optional[Tensor],
                additive_mask: Optional[Tensor],
                kv: Optional[tuple[Tensor, Tensor]] = None,
                attention_impl: str = "plain",
                generator: Optional[torch.Generator] = None) -> Tensor:
        whole = sp.gather(hidden)
        q = self.self.query(whole)
        h = q.shape[-1] // self.head_dim      # num_heads / tp under tp
        q = split_heads(q, h)
        if kv is not None:
            k, v = kv
        else:
            if kv_source is hidden:
                kv_source = whole
            k = split_heads(self.self.key(kv_source), h)
            v = split_heads(self.self.value(kv_source), h)
        heads = None if h == self.num_heads else (tp_rank() * h,
                                                  self.num_heads)
        ctx = multi_head_attention(q, k, v, additive_mask, attention_impl,
                                   self.probs_dropout, generator, heads)
        out = self.output.dense(merge_heads(ctx))
        out = sp.residual_dropout(out, self.hidden_dropout, generator)
        return self.output.LayerNorm(out + hidden)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertArchConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.intermediate_size)


class BertOutput(nn.Module):
    def __init__(self, cfg: BertArchConfig):
        super().__init__()
        self.dense = Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class BertLayer(nn.Module):
    """One layer: self-attn (+ cross-attn in fusion layers) + FFN."""

    def __init__(self, cfg: BertArchConfig, has_cross: bool):
        super().__init__()
        self.attention = BertAttention(cfg, cfg.hidden_size)
        if has_cross:
            self.crossattention = BertAttention(cfg, cfg.encoder_width)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)
        self.hidden_dropout = cfg.hidden_dropout_prob

    @property
    def has_cross(self) -> bool:
        return hasattr(self, "crossattention")

    def mlp(self, hidden: Tensor,
            generator: Optional[torch.Generator] = None) -> Tensor:
        """Intermediate erf-GELU + output dense + dropout + residual LN
        (``mlp_block``)."""
        up = F.gelu(self.intermediate.dense(sp.gather(hidden)))
        down = sp.residual_dropout(self.output.dense(up),
                                   self.hidden_dropout, generator)
        return self.output.LayerNorm(down + hidden)

    def forward(self, hidden: Tensor, self_mask: Optional[Tensor],
                encoder_hidden: Optional[Tensor] = None,
                cross_mask: Optional[Tensor] = None,
                cross_kv: Optional[tuple[Tensor, Tensor]] = None,
                attention_impl: str = "plain",
                generator: Optional[torch.Generator] = None) -> Tensor:
        hidden = self.attention(hidden, hidden, self_mask,
                                attention_impl=attention_impl,
                                generator=generator)
        if self.has_cross:
            if encoder_hidden is None and cross_kv is None:
                raise ValueError(
                    "encoder_hidden_states required for cross-attention layers")
            hidden = self.crossattention(hidden, encoder_hidden, cross_mask,
                                         kv=cross_kv,
                                         attention_impl=attention_impl,
                                         generator=generator)
        return self.mlp(hidden, generator)


def _layer_range(cfg: BertArchConfig, mode: str) -> range:
    if mode == "text":
        return range(0, cfg.fusion_layer)
    if mode == "fusion":
        return range(cfg.fusion_layer, cfg.num_hidden_layers)
    if mode == "multi_modal":
        return range(0, cfg.num_hidden_layers)
    raise ValueError(f"unknown mode: {mode!r}")


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertArchConfig):
        super().__init__()
        self.cfg = cfg
        self.layer = nn.ModuleList(
            BertLayer(cfg, cfg.add_cross_attention and i >= cfg.fusion_layer)
            for i in range(cfg.num_hidden_layers))

    def forward(self, hidden: Tensor, self_mask: Optional[Tensor],
                encoder_hidden=None, cross_mask=None, mode: str = "multi_modal",
                cross_kv: Optional[dict] = None,
                attention_impl: str = "plain",
                generator: Optional[torch.Generator] = None,
                remat: bool = False) -> Tensor:
        """Run the section selected by ``mode``.  ``encoder_hidden`` /
        ``cross_mask`` may be lists, assigned round-robin over the fusion
        layers; ``cross_kv`` ({"k": [L, B, h, Le, D], "v": ...}) supplies
        precomputed cross K/V per absolute layer index; ``remat``
        recomputes each layer in the backward."""
        cfg = self.cfg
        for i in _layer_range(cfg, mode):
            if isinstance(encoder_hidden, (list, tuple)):
                j = (i - cfg.fusion_layer) % len(encoder_hidden)
                enc, xmask = encoder_hidden[j], cross_mask[j]
            else:
                enc, xmask = encoder_hidden, cross_mask
            layer = self.layer[i]
            ckv = None
            if cross_kv is not None and layer.has_cross:
                ckv = (cross_kv["k"][i], cross_kv["v"][i])
            run = functools.partial(layer, cross_kv=ckv,
                                    attention_impl=attention_impl,
                                    generator=generator)
            if remat:
                hidden = checkpointed(run, generator, hidden, self_mask,
                                      enc, xmask)
            else:
                hidden = run(hidden, self_mask, enc, xmask)
        return hidden


class BertModel(nn.Module):
    """BertModel.forward equivalent (reference xbert.py:950-1091)."""

    def __init__(self, cfg: BertArchConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)

    def forward(
        self,
        input_ids: Optional[Tensor] = None,
        attention_mask: Optional[Tensor] = None,
        inputs_embeds: Optional[Tensor] = None,
        encoder_embeds: Optional[Tensor] = None,
        encoder_hidden_states: Union[Tensor, Sequence[Tensor], None] = None,
        encoder_attention_mask=None,
        is_decoder: bool = False,
        mode: str = "multi_modal",
        cross_kv: Optional[dict] = None,
        attention_impl: str = "plain",
        generator: Optional[torch.Generator] = None,
        remat: bool = False,
    ) -> Tensor:
        """Returns the last hidden state [B, L, H].  ``encoder_embeds``
        bypasses the embedding layer; ``cross_kv`` replaces
        ``encoder_hidden_states`` with precomputed per-layer cross K/V;
        ``attention_impl`` ("plain" or "kernel") runs every attention of the
        section through that core; ``generator`` turns dropout on;
        ``remat`` recomputes each layer in the backward."""
        if encoder_embeds is not None:
            hidden = encoder_embeds
        else:
            hidden = self.embeddings(input_ids, inputs_embeds,
                                     generator=generator)
        b, l = hidden.shape[:2]
        dev = hidden.device
        if attention_mask is None:
            attention_mask = torch.ones((b, l), dtype=torch.int32, device=dev)
        if is_decoder:
            self_mask = extend_causal_mask(attention_mask, q_len=l)
        else:
            self_mask = extend_attention_mask(attention_mask)

        cross_mask = None
        if cross_kv is not None and encoder_hidden_states is None:
            if encoder_attention_mask is None:
                encoder_attention_mask = torch.ones(
                    (b, cross_kv["k"].shape[-2]), dtype=torch.int32, device=dev)
            cross_mask = invert_encoder_mask(encoder_attention_mask)
        elif encoder_hidden_states is not None:
            if isinstance(encoder_hidden_states, (list, tuple)):
                if encoder_attention_mask is None:
                    encoder_attention_mask = [
                        torch.ones(e.shape[:2], dtype=torch.int32, device=dev)
                        for e in encoder_hidden_states]
                cross_mask = [invert_encoder_mask(m)
                              for m in encoder_attention_mask]
            else:
                if encoder_attention_mask is None:
                    encoder_attention_mask = torch.ones(
                        encoder_hidden_states.shape[:2], dtype=torch.int32,
                        device=dev)
                cross_mask = invert_encoder_mask(encoder_attention_mask)

        hidden = self.encoder(sp.scatter(hidden), self_mask,
                              encoder_hidden_states, cross_mask, mode,
                              cross_kv=cross_kv,
                              attention_impl=attention_impl,
                              generator=generator, remat=remat)
        return sp.gather(hidden)


class BertPredictionTransform(nn.Module):
    def __init__(self, cfg: BertArchConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class BertLMPredictionHead(nn.Module):
    """LM head: dense + GELU + LN, then the vocab decoder (reference
    xbert.py:662-696).  The decoder bias IS ``bias`` (the reference aliases
    ``cls.predictions.bias``); the decoder weight is tied by BertForMaskedLM."""

    def __init__(self, cfg: BertArchConfig):
        super().__init__()
        self.transform = BertPredictionTransform(cfg)
        self.decoder = Linear(cfg.hidden_size, cfg.vocab_size)
        self.bias = self.decoder.bias

    def forward(self, hidden: Tensor) -> Tensor:
        x = F.gelu(self.transform.dense(hidden))
        x = self.transform.LayerNorm(x)
        return self.decoder(x)


class BertOnlyMLMHead(nn.Module):
    def __init__(self, cfg: BertArchConfig):
        super().__init__()
        self.predictions = BertLMPredictionHead(cfg)


class BertForMaskedLM(nn.Module):
    """BertModel + LM head returning logits (reference xbert.py:1377-1428)."""

    def __init__(self, cfg: BertArchConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(cfg)
        self.cls = BertOnlyMLMHead(cfg)
        if cfg.tie_word_embeddings:
            self.cls.predictions.decoder.weight = (
                self.bert.embeddings.word_embeddings.weight)

    def forward(self, **kwargs) -> Tensor:
        return self.cls.predictions(self.bert(**kwargs))
