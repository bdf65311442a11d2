"""Moonlight-16B-A3B (``model_type`` deepseek_v3) in plain PyTorch: the
reference of the ``moonlight-16b-a3b`` configuration.

One full causal forward over a sequence, in fp32 with TF32 off, with no
cache, no kernel and no batching (each sequence alone), after DeepSeek-V3's
public modeling code for this configuration:

- a block: ``h = x + MLA(RMSNorm(x))``, ``out = h + FFN(RMSNorm(h))``; a
  final RMSNorm, then the untied ``lm_head``;
- RMSNorm ``x * rsqrt(mean(x^2) + eps) * w``; the block norms and the final
  norm at ``rms_norm_eps``, ``kv_a_layernorm`` at ``kv_norm_eps`` (1e-6,
  the norm class's default);
- MLA without a q LoRA: ``q = W_q x`` viewed [heads, nope | rope];
  ``[c | k_pe] = W_kva x``, ``c = RMSNorm_kv(c)``; ``[k_nope | v] = W_kvb
  c`` a head; RoPE rotates each pair (x_2i, x_2i+1) of ``q_pe`` and the
  one shared ``k_pe`` by ``p * theta^(-2i / rope_dim)``; scores
  ``(q_nope.k_nope + q_pe.k_pe) / sqrt(nope + rope)``, causal, softmax;
  ``o = W_o [softmax . v]``;
- the first ``first_k_dense_replace`` layers' FFN is SwiGLU,
  ``down(silu(gate x) * up x)``; the rest are MoE: ``s = sigmoid(W_g x)``,
  the top ``num_experts_per_tok`` chosen by ``s + e_score_correction_bias``
  (one group, so group selection is a no-op), weighted by ``s[chosen] /
  (sum + 1e-20) * routed_scaling_factor``, each expert a SwiGLU of
  ``moe_intermediate_size``, plus the shared experts as one SwiGLU of
  ``n_shared_experts * moe_intermediate_size``; no token dropped.

Where the configuration holds a chip's share of the experts (their count,
``n_routed_experts`` or ``num_experts``, cut and its published value under
``published``), the router keeps its published width and chooses the top k
of all the experts; only the held experts, the global ids
[``first_expert``, ``first_expert`` + held), add their products, and the
shared experts always do.  What the absent experts would add is left out,
as on the chip that holds this share.

Queries are taken in blocks so that an 8k sequence fits.  Weights are made
per tensor from (seed, name), under DeepSeek-V3's checkpoint names, so that
the program and this reference hold the same values, and the reference
makes one layer at a time: every matrix N(0, ``initializer_range``) rounded
to bf16 (the configuration's dtype), every norm 1, the correction bias
N(0, ``initializer_range``) in fp32 (an fp32 buffer in the checkpoint).

``precision="fp8"`` is the cell's control: every product's operands rounded
to float8_e4m3fn with one scale a tensor, then multiplied in fp32.
``precision="bf16"`` is the program's rounding without the program (a
witness of what bf16 alone does to the served tokens): every product's
operands and result in bf16 (fp32 sums), the residual stream rounded to
bf16 after each addition; the router's product, the norms and the softmax
in fp32.

The module gives the interface of ``portbench/reference/__init__.py``:
``Reference`` is ``LatentMoeReference``, ``work`` the turn's counts of
``portbench/lm_counts.py``.
"""

from __future__ import annotations

import hashlib
import math

import torch
import torch.nn.functional as F

from portbench import lm_counts
from portbench.experts import routed_experts

FP8_MAX = 448.0
QUERY_BLOCK = 1024


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def tensor_seed(seed: int, name: str) -> int:
    """The generator seed of one named tensor."""
    digest = hashlib.sha256(f"{seed}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def layer_spec(cfg: dict, i: int, first_expert: int = 0) -> list:
    """(name, shape, kind) of layer ``i``'s tensors; kind "normal" (bf16
    values), "ones" or "bias" (fp32 values).  The routed experts are the
    held ones from global id ``first_expert``; the router spans all."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    p = f"model.layers.{i}."
    out = [(f"{p}input_layernorm.weight", (h,), "ones"),
           (f"{p}self_attn.q_proj.weight", (nh * (dn + dr), h), "normal"),
           (f"{p}self_attn.kv_a_proj_with_mqa.weight", (r + dr, h), "normal"),
           (f"{p}self_attn.kv_a_layernorm.weight", (r,), "ones"),
           (f"{p}self_attn.kv_b_proj.weight", (nh * (dn + dv), r), "normal"),
           (f"{p}self_attn.o_proj.weight", (h, nh * dv), "normal"),
           (f"{p}post_attention_layernorm.weight", (h,), "ones")]

    def swiglu(prefix, width):
        return [(f"{prefix}gate_proj.weight", (width, h), "normal"),
                (f"{prefix}up_proj.weight", (width, h), "normal"),
                (f"{prefix}down_proj.weight", (h, width), "normal")]

    if i < cfg["first_k_dense_replace"]:
        return out + swiglu(f"{p}mlp.", cfg["intermediate_size"])
    held, e = routed_experts(cfg)
    out += [(f"{p}mlp.gate.weight", (e, h), "normal"),
            (f"{p}mlp.gate.e_score_correction_bias", (e,), "bias")]
    for j in range(first_expert, first_expert + held):
        out += swiglu(f"{p}mlp.experts.{j}.", cfg["moe_intermediate_size"])
    return out + swiglu(f"{p}mlp.shared_experts.",
                        cfg["n_shared_experts"] * cfg["moe_intermediate_size"])


def outer_spec(cfg: dict) -> list:
    """(name, shape, kind) of the tensors outside the layers."""
    v, h = cfg["vocab_size"], cfg["hidden_size"]
    return [("model.embed_tokens.weight", (v, h), "normal"),
            ("model.norm.weight", (h,), "ones"),
            ("lm_head.weight", (v, h), "normal")]


def tensor_kinds(cfg: dict) -> dict:
    """name -> kind of every tensor of the model."""
    out = {name: kind for name, _, kind in outer_spec(cfg)}
    for i in range(cfg["num_hidden_layers"]):
        out.update((name, kind) for name, _, kind in layer_spec(cfg, i))
    return out


def make_tensor(cfg: dict, seed: int, name: str, shape, kind: str,
                device) -> torch.Tensor:
    """One named tensor in fp32, made on ``device`` from (seed, name)."""
    if kind == "ones":
        return torch.ones(shape, device=device)
    gen = torch.Generator(device=device).manual_seed(tensor_seed(seed, name))
    x = torch.randn(shape, generator=gen, device=device).mul_(
        cfg["initializer_range"])
    return x.to(torch.bfloat16).float() if kind == "normal" else x


class LatentMoeReference:
    """The forward of ``cfg`` (the configuration file's dict) with the
    weights of ``seed``, on ``device``; where ``cfg`` holds a share of the
    experts, the share from global id ``first_expert`` (0: chip 0's).
    Making one turns TF32 off for the process."""

    def __init__(self, cfg: dict, seed: int, device, precision: str = "fp32",
                 first_expert: int = 0):
        if precision not in ("fp32", "fp8", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg, self.seed, self.dev = cfg, seed, device
        self.precision, self.first_expert = precision, first_expert
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def tensors(self, spec: list) -> dict:
        return {name: make_tensor(self.cfg, self.seed, name, shape, kind,
                                  self.dev) for name, shape, kind in spec}

    # ---- pieces ----

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            a, b = _fp8(a), _fp8(b)
        elif self.precision == "bf16":
            return torch.matmul(a.bfloat16(), b.bfloat16()).float()
        return torch.matmul(a, b)

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream as stored: bf16 in the bf16 witness."""
        return x.bfloat16().float() if self.precision == "bf16" else x

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.mm(x, w.t())

    @staticmethod
    def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float
                 ) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Rotate each pair (x_2i, x_2i+1) of the last axis by pos *
        theta^(-2i / d); ``x`` [L, ..., d], ``pos`` [L]."""
        d = x.shape[-1]
        inv = self.cfg["rope_theta"] ** (-torch.arange(
            0, d, 2, device=x.device, dtype=torch.float64) / d)
        ang = (pos.double()[:, None] * inv[None]).float()
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (d // 2,)
        cos, sin = ang.cos().view(shape), ang.sin().view(shape)
        x0, x1 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                           -1).flatten(-2)

    def swiglu(self, x: torch.Tensor, w: dict, prefix: str) -> torch.Tensor:
        gate = self.linear(x, w[f"{prefix}gate_proj.weight"])
        up = self.linear(x, w[f"{prefix}up_proj.weight"])
        return self.linear(F.silu(gate) * up, w[f"{prefix}down_proj.weight"])

    def route(self, x: torch.Tensor, w: dict, p: str) -> tuple:
        """(chosen experts [L, k], their weights [L, k]) of ``x`` [L, H]."""
        cfg = self.cfg
        gate = w[f"{p}mlp.gate.weight"]
        s = torch.sigmoid(torch.matmul(x, gate.t()) if self.precision == "bf16"
                          else self.linear(x, gate))
        biased = s + w[f"{p}mlp.gate.e_score_correction_bias"]
        idx = biased.topk(cfg["num_experts_per_tok"], dim=-1).indices
        chosen = s.gather(-1, idx)
        weights = chosen / (chosen.sum(-1, keepdim=True) + 1e-20)
        return idx, weights * cfg["routed_scaling_factor"]

    def moe(self, x: torch.Tensor, w: dict, p: str) -> torch.Tensor:
        idx, weights = self.route(x, w, p)
        out = self.swiglu(x, w, f"{p}mlp.shared_experts.")
        first = self.first_expert
        for e in range(first, first + routed_experts(self.cfg)[0]):
            rows, slot = (idx == e).nonzero(as_tuple=True)
            if rows.numel():
                y = self.swiglu(x[rows], w, f"{p}mlp.experts.{e}.")
                out = out.index_add(0, rows, y * weights[rows, slot, None])
        return out

    def attention(self, x: torch.Tensor, w: dict, p: str) -> torch.Tensor:
        cfg = self.cfg
        n, nh = x.shape[0], cfg["num_attention_heads"]
        dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
        dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
        a = f"{p}self_attn."
        pos = torch.arange(n, device=x.device)
        q = self.linear(x, w[f"{a}q_proj.weight"]).view(n, nh, dn + dr)
        q = torch.cat([q[..., :dn], self.rope(q[..., dn:], pos)], -1)
        kv = self.linear(x, w[f"{a}kv_a_proj_with_mqa.weight"])
        c = self.rms_norm(kv[:, :r], w[f"{a}kv_a_layernorm.weight"],
                          cfg["kv_norm_eps"])
        k_pe = self.rope(kv[:, r:], pos)
        kvb = self.linear(c, w[f"{a}kv_b_proj.weight"]).view(n, nh, dn + dv)
        k = torch.cat([kvb[..., :dn], k_pe[:, None].expand(n, nh, dr)], -1)
        v = kvb[..., dn:]
        k, v = k.transpose(0, 1), v.transpose(0, 1)        # [nh, n, d]
        out = torch.empty(n, nh * dv, device=x.device)
        scale = 1.0 / math.sqrt(dn + dr)
        for lo in range(0, n, QUERY_BLOCK):
            hi = min(lo + QUERY_BLOCK, n)
            s = self.mm(q[lo:hi].transpose(0, 1), k[:, :hi].transpose(1, 2))
            s = s * scale
            future = pos[None, :hi] > pos[lo:hi, None]
            s = s.masked_fill(future[None], float("-inf"))
            ctx = self.mm(torch.softmax(s, -1), v[:, :hi])   # [nh, b, dv]
            out[lo:hi] = ctx.transpose(0, 1).reshape(hi - lo, nh * dv)
        return self.linear(out, w[f"{a}o_proj.weight"])

    def layer(self, x: torch.Tensor, i: int, w: dict) -> torch.Tensor:
        cfg, p = self.cfg, f"model.layers.{i}."
        eps = cfg["rms_norm_eps"]
        x = self.residual(x + self.attention(
            self.rms_norm(x, w[f"{p}input_layernorm.weight"], eps), w, p))
        h = self.rms_norm(x, w[f"{p}post_attention_layernorm.weight"], eps)
        if i < cfg["first_k_dense_replace"]:
            return self.residual(x + self.swiglu(h, w, f"{p}mlp."))
        return self.residual(x + self.moe(h, w, p))

    # ---- the forward ----

    def logits(self, sequences: list, wanted: list) -> list:
        """For each token sequence (a 1-D LongTensor), the logits [n, V]
        at its positions ``wanted`` (a 1-D LongTensor each): those of the
        token after each such position.  One layer's weights at a time."""
        outer = self.tensors(outer_spec(self.cfg))
        xs = [outer["model.embed_tokens.weight"][s.to(self.dev)]
              for s in sequences]
        for i in range(self.cfg["num_hidden_layers"]):
            w = self.tensors(layer_spec(self.cfg, i, self.first_expert))
            xs = [self.layer(x, i, w) for x in xs]
            del w
        out = []
        for x, at in zip(xs, wanted):
            h = self.rms_norm(x[at.to(self.dev)], outer["model.norm.weight"],
                              self.cfg["rms_norm_eps"])
            out.append(self.linear(h, outer["lm_head.weight"]))
        return out


Reference = LatentMoeReference


def work(cfg: dict, history, rows: int, turn: int, answer: int) -> dict:
    """A turn's needed work over rows with the given history lengths, for
    the per-layer readers: its FLOPs (``mfu``), and kernel 3's and the
    expert products' (launches, summed bound seconds)."""
    return {
        "model_flops": lm_counts.turn_flops(cfg, history, turn, answer),
        "k3": lm_counts.k3_turn_bound_s(cfg, history, turn, answer),
        "moe_product": lm_counts.moe_turn_bound_s(cfg, rows, turn, answer),
    }
