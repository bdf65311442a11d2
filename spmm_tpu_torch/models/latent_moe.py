"""A decoder-only LM with latent attention (MLA) and routed experts, in
DeepSeek-V3's layout: Moonlight-16B-A3B at its published widths
(``configs.LatentMoeConfig``).  The JAX package has no such model.

A block: ``h = x + MLA(RMSNorm(x))``, ``out = h + FFN(RMSNorm(h))``; after
the last, a final RMSNorm and the untied ``lm_head``.  Weights, activations
and the cache are bf16 (the published dtype; fp32 where a CPU test holds
the algorithm to the reference); RMSNorm, RoPE's angles, the softmax and
the router run in fp32.

MLA without a q LoRA, for a token at position p:

- ``q = W_q x`` [heads, nope | rope]; ``[c | k_pe] = W_kva x``,
  ``c = RMSNorm_kv(c)``; RoPE rotates each pair (x_2i, x_2i+1) of ``q_pe``
  and the one shared ``k_pe`` by ``p * theta^(-2i / rope)``;
- the cache keeps ``[c | rope(k_pe)]``, latent + rope values a token a
  layer (``cache[layer, row, position]``);
- prefill (``prefill``), the expanded form: ``[k_nope | v] = W_kvb c`` a
  head over the row's cached positions, scores ``(q_nope.k_nope +
  q_pe.k_pe) / sqrt(nope + rope)``, causal, then ``W_o [softmax . v]``
  (``ops.mla_prefill``: one fused kernel a layer and group of rows on a
  card);
- decode (``decode_step``), the absorbed form: with ``W_kvb`` split into
  ``W_uk`` and ``W_uv`` [heads, nope | v, latent], ``q_lat = W_uk^T
  q_nope`` and the scores ``q_lat.c + q_pe.k_pe`` over the cache, ``o_lat
  = sum p c`` (kernel 3, ``ops.mla_decode``), ``o = W_uv o_lat``.

The FFN: SwiGLU ``down(silu(gate x) * up x)`` in the first
``first_k_dense_replace`` layers; then routed experts (``ops.moe``: the
top k of sigmoid scores plus a correction bias, weighted by the unbiased
scores, normalised and scaled, no token dropped) plus the shared experts,
one SwiGLU of ``n_shared_experts`` expert widths.

Parameters hold each layer's gate and up rows together and the experts
stacked; ``checkpoint_views`` names each under DeepSeek-V3's checkpoint
names, and ``load_checkpoint`` fills them from a name -> tensor function.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from spmm_tpu_torch.configs import LatentMoeConfig
from spmm_tpu_torch.ops import mla_prefill, moe
from spmm_tpu_torch.ops.mla_decode import (
    mla_decode_attention, mla_decode_attention_reference)
from spmm_tpu_torch.ops.mla_prefill import mla_prefill_attention

Tensor = torch.Tensor


def rms_norm(x: Tensor, w: Tensor, eps: float) -> Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` in fp32, returned in x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * w.float()
    return y.to(x.dtype)


def rope(x: Tensor, pos: Tensor, inv_freq: Tensor) -> Tensor:
    """Rotate each pair (x_2i, x_2i+1) of the last axis of ``x`` [N, ...,
    d] by ``pos[n] * inv_freq[i]``, in fp32; returned in x's dtype."""
    ang = pos.float()[:, None] * inv_freq[None]
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (ang.shape[1],)
    cos, sin = ang.cos().view(shape), ang.sin().view(shape)
    xf = x.float()
    x0, x1 = xf[..., 0::2], xf[..., 1::2]
    return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                       -1).flatten(-2).to(x.dtype)


def swiglu(x: Tensor, gate_up: Tensor, down: Tensor) -> Tensor:
    """``down(silu(gate x) * up x)`` with gate and up rows stacked in
    ``gate_up``; the activation in fp32."""
    gu = F.linear(x, gate_up)
    inter = gate_up.shape[0] // 2
    act = (F.silu(gu[:, :inter].float()) * gu[:, inter:].float()).to(x.dtype)
    return F.linear(act, down)


def _param(*shape, fill=None, dtype=torch.bfloat16) -> nn.Parameter:
    t = (torch.empty(shape, dtype=dtype) if fill is None
         else torch.full(shape, fill, dtype=dtype))
    return nn.Parameter(t, requires_grad=False)


class LatentMoeLayer(nn.Module):
    def __init__(self, cfg: LatentMoeConfig, index: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        h, nh = cfg.hidden_size, cfg.num_attention_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        r = cfg.kv_lora_rank
        self.cfg = cfg
        self.dense = index < cfg.first_k_dense_replace
        self.input_norm = _param(h, fill=1.0, dtype=dtype)
        self.q_proj = _param(nh * (dn + dr), h, dtype=dtype)
        self.kv_a = _param(r + dr, h, dtype=dtype)
        self.kv_norm = _param(r, fill=1.0, dtype=dtype)
        self.kv_b = _param(nh * (dn + dv), r, dtype=dtype)
        self.o_proj = _param(h, nh * dv, dtype=dtype)
        self.post_norm = _param(h, fill=1.0, dtype=dtype)
        if self.dense:
            self.gate_up = _param(2 * cfg.intermediate_size, h, dtype=dtype)
            self.down = _param(h, cfg.intermediate_size, dtype=dtype)
        else:
            e, inter = cfg.n_routed_experts, cfg.moe_intermediate_size
            shared = cfg.n_shared_experts * inter
            self.router = _param(e, h, dtype=dtype)
            self.router_bias = _param(e, fill=0.0, dtype=torch.float32)
            self.experts_gate_up = _param(e, 2 * inter, h, dtype=dtype)
            self.experts_down = _param(e, h, inter, dtype=dtype)
            self.shared_gate_up = _param(2 * shared, h, dtype=dtype)
            self.shared_down = _param(h, shared, dtype=dtype)

    # ---- attention ----

    def _qkv(self, x: Tensor, pos: Tensor, inv_freq: Tensor):
        """(q_nope [N, heads, nope], rotated q_pe [N, heads, rope], the
        cache rows [N, latent + rope]) of normed ``x`` [N, H]."""
        cfg = self.cfg
        nh, dn = cfg.num_attention_heads, cfg.qk_nope_head_dim
        r = cfg.kv_lora_rank
        q = F.linear(x, self.q_proj).view(x.shape[0], nh, -1)
        kv = F.linear(x, self.kv_a)
        c = rms_norm(kv[:, :r], self.kv_norm, cfg.kv_norm_eps)
        k_pe = rope(kv[:, r:], pos, inv_freq)
        return (q[..., :dn], rope(q[..., dn:], pos, inv_freq),
                torch.cat([c, k_pe], -1))

    def attend_prefill(self, x: Tensor, pos: Tensor, inv_freq: Tensor,
                       cache: Tensor, row_ids: Tensor, segments: list,
                       groups: Optional[list] = None) -> Tensor:
        """Normed ``x`` [N, H] of tokens at ``pos`` of rows ``row_ids``:
        their cache rows written, then each row's tokens (``segments``:
        (row, start, count, offset into x)) attend its cached positions up
        to their own, in the expanded form, the scale folded into q
        (``ops.mla_prefill``: the kernel on a card, over ``groups``, its
        plan; the plain version on the CPU).  Returns W_o's output [N, H]."""
        cfg = self.cfg
        dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        q_nope, q_pe, lat = self._qkv(x, pos, inv_freq)
        cache[row_ids, pos] = lat
        q = torch.cat([q_nope, q_pe], -1) * (1.0 / math.sqrt(dn + dr))
        out = mla_prefill_attention(q, cache, self.kv_b, segments, dn,
                                    groups)
        return F.linear(out, self.o_proj)

    def attend_decode(self, x: Tensor, pos: Tensor, inv_freq: Tensor,
                      cache: Tensor, lens: Tensor, attention: str) -> Tensor:
        """Normed ``x`` [B, H], one token a row at ``pos`` [B]: its cache
        row written, then the absorbed attention over the row's first
        ``lens`` positions.  Returns W_o's output [B, H]."""
        cfg = self.cfg
        nh, dn, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                      cfg.v_head_dim)
        r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        b = x.shape[0]
        q_nope, q_pe, lat = self._qkv(x, pos, inv_freq)
        cache[torch.arange(b, device=x.device), pos] = lat
        w = self.kv_b.view(nh, dn + dv, r)
        q_lat = torch.bmm(q_nope.transpose(0, 1), w[:, :dn])   # [nh, B, r]
        q = torch.cat([q_lat.transpose(0, 1), q_pe], -1).contiguous()
        attend = (mla_decode_attention if attention == "kernel"
                  else mla_decode_attention_reference)
        o_lat = attend(q, cache, lens, r, 1.0 / math.sqrt(dn + dr))
        o = torch.bmm(o_lat.transpose(0, 1), w[:, dn:].transpose(1, 2))
        return F.linear(o.transpose(0, 1).reshape(b, nh * dv), self.o_proj)

    # ---- feed-forward ----

    def ffn(self, x: Tensor) -> Tensor:
        if self.dense:
            return swiglu(x, self.gate_up, self.down)
        cfg = self.cfg
        # the shared experts first: the routed part's kernels, router to
        # pairs' sum, then run back to back (portbench's moe_ms reads them)
        shared = swiglu(x, self.shared_gate_up, self.shared_down)
        idx, w = moe.route(x, self.router, self.router_bias,
                           cfg.num_experts_per_tok, cfg.routed_scaling_factor)
        routed = moe.routed_experts(x, idx, w, self.experts_gate_up,
                                    self.experts_down)
        return (routed + shared.float()).to(x.dtype)

    def finish(self, x: Tensor, attn: Tensor) -> Tensor:
        x = x + attn
        return x + self.ffn(rms_norm(x, self.post_norm, self.cfg.rms_norm_eps))


class LatentMoe(nn.Module):
    """The model, its weights and activations in ``dtype`` (bf16, as
    published; fp32 for the CPU tests' comparison of the algorithm);
    ``prefill`` and ``decode_step`` work on a cache [layers, rows,
    positions, latent + rope] of that dtype that the caller holds
    (``inference.lm.SessionCache``)."""

    def __init__(self, cfg: LatentMoeConfig,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(LatentMoeLayer(cfg, i, dtype)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = _param(cfg.hidden_size, fill=1.0, dtype=dtype)
        self.lm_head = _param(cfg.vocab_size, cfg.hidden_size, dtype=dtype)
        d = cfg.qk_rope_head_dim
        inv = cfg.rope_theta ** (-torch.arange(0, d, 2, dtype=torch.float64)
                                 / d)
        self.register_buffer("inv_freq", inv.float(), persistent=False)

    def checkpoint_views(self) -> list:
        """(DeepSeek-V3 checkpoint name, the view of a parameter it fills)
        for every tensor of the model."""
        cfg = self.cfg
        out = [("model.embed_tokens.weight", self.embed),
               ("model.norm.weight", self.norm),
               ("lm_head.weight", self.lm_head)]
        for i, layer in enumerate(self.layers):
            p = f"model.layers.{i}."
            a = f"{p}self_attn."
            out += [(f"{p}input_layernorm.weight", layer.input_norm),
                    (f"{a}q_proj.weight", layer.q_proj),
                    (f"{a}kv_a_proj_with_mqa.weight", layer.kv_a),
                    (f"{a}kv_a_layernorm.weight", layer.kv_norm),
                    (f"{a}kv_b_proj.weight", layer.kv_b),
                    (f"{a}o_proj.weight", layer.o_proj),
                    (f"{p}post_attention_layernorm.weight", layer.post_norm)]

            def pair(prefix, gate_up, down):
                inter = gate_up.shape[0] // 2
                return [(f"{prefix}gate_proj.weight", gate_up[:inter]),
                        (f"{prefix}up_proj.weight", gate_up[inter:]),
                        (f"{prefix}down_proj.weight", down)]

            if layer.dense:
                out += pair(f"{p}mlp.", layer.gate_up, layer.down)
                continue
            out += [(f"{p}mlp.gate.weight", layer.router),
                    (f"{p}mlp.gate.e_score_correction_bias",
                     layer.router_bias)]
            for e in range(cfg.n_routed_experts):
                out += pair(f"{p}mlp.experts.{e}.", layer.experts_gate_up[e],
                            layer.experts_down[e])
            out += pair(f"{p}mlp.shared_experts.", layer.shared_gate_up,
                        layer.shared_down)
        return out

    @torch.no_grad()
    def load_checkpoint(self, get: Callable[[str, tuple], Tensor]) -> None:
        """Fill every parameter from ``get(name, shape)``, one tensor at a
        time (each may be made on demand and dropped)."""
        for name, view in self.checkpoint_views():
            view.copy_(get(name, tuple(view.shape)))

    def logits(self, x: Tensor) -> Tensor:
        return F.linear(rms_norm(x, self.norm, self.cfg.rms_norm_eps),
                        self.lm_head)

    @torch.no_grad()
    def prefill(self, cache: Tensor, tokens: Tensor, pos: Tensor,
                row_ids: Tensor, segments: list) -> Tensor:
        """Run ``tokens`` [N] (rows' runs back to back; ``segments``:
        (row, start, count, offset) each, positions ``pos`` [N], rows
        ``row_ids`` [N]) through every layer against the rows' caches,
        writing their cache rows; returns the logits [len(segments), V] of
        the token after each run's last."""
        cfg = self.cfg
        x = self.embed[tokens]
        groups = None
        if x.device.type == "cuda":     # one plan for every layer
            key_bytes = (cfg.num_attention_heads * x.element_size()
                         * (cfg.qk_nope_head_dim + cfg.v_head_dim))
            groups = mla_prefill.plan(segments, cfg.num_attention_heads,
                                      key_bytes, device=x.device)
        for i, layer in enumerate(self.layers):
            attn = layer.attend_prefill(
                rms_norm(x, layer.input_norm, cfg.rms_norm_eps), pos,
                self.inv_freq, cache[i], row_ids, segments, groups)
            x = layer.finish(x, attn)
        last = torch.tensor([off + count - 1 for _, _, count, off in segments],
                            device=x.device)
        return self.logits(x[last])

    @torch.no_grad()
    def decode_step(self, cache: Tensor, tokens: Tensor, pos: Tensor,
                    attention: str = "kernel") -> Tensor:
        """One token a row (``tokens`` [B] at positions ``pos`` [B]) through
        every layer, each row's cache row written; the attention is kernel
        3 (``"kernel"``) or its plain version (``"plain"``).  Returns the
        logits [B, V].  Static shapes and no host read: a CUDA graph
        captures it."""
        if attention not in ("kernel", "plain"):
            raise ValueError(f"unknown attention {attention!r}")
        x = self.embed[tokens]
        lens = (pos + 1).to(torch.int32)
        for i, layer in enumerate(self.layers):
            attn = layer.attend_decode(
                rms_norm(x, layer.input_norm, self.cfg.rms_norm_eps), pos,
                self.inv_freq, cache[i], lens, attention)
            x = layer.finish(x, attn)
        return self.logits(x)
