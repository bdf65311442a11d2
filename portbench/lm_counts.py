"""Operations and bytes that a turn of the latent MoE configuration needs
(the ``moonlight-16b-a3b`` cells), for the per-layer shares: functions of
the configuration and the lengths only, never of the program.

Conventions, as ``counts.py``'s (2 FLOPs a multiply-add, matrix products
only, each input byte read once and each output byte written once):

- the turn's prefill in the expanded form: each new token's projections,
  router and experts (its k routed and the shared ones), its attention to
  the row's positions up to its own (q.k over nope + rope, p.v over v, a
  head), and the expansion of every key the row attends (``W_kvb`` over
  the row's cached latents, once a layer); the LM head at the turn's last
  token;
- a decode step in the absorbed form: each row's projections, the
  absorption of q (``W_uk``) and of the output (``W_uv``), router, experts
  and LM head, and its attention over its live positions (scores over
  latent + rope, outputs over the latent, a head);
- kernel 3 (a launch of the attention and its combine): each row's live
  cache rows read once, q read and the output written;
- the expert products (``moe_product_kernel``, the gated up-projection and
  the weighted down-projection): each expert that a token chose read once
  a launch (the expected number of experts that ``tokens * k`` uniform
  choices touch), the tokens' rows read, the pairs' rows written and read;
- a configuration that holds a chip's share of the experts (their count,
  ``n_routed_experts`` or ``num_experts``, cut, the published count under
  ``published``):
  the router over the published count, and of the experts only the held
  ones' work and bytes: k * held / published pairs a token on average, and
  of ``tokens`` tokens' choices held * (1 - (1 - k / published)^tokens)
  experts touched.
"""

from __future__ import annotations

from portbench.counts import PEAK_FLOPS, bound_s
from portbench.experts import routed_experts

BF16 = 2


def _dims(cfg: dict) -> tuple:
    return (cfg["hidden_size"], cfg["num_attention_heads"],
            cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
            cfg["v_head_dim"], cfg["kv_lora_rank"])


def token_macs(cfg: dict, layer: int) -> float:
    """Multiply-adds of one token's projections and feed-forward in
    ``layer``, outside the attention products (``W_kvb`` excepted)."""
    h, nh, dn, dr, dv, r = _dims(cfg)
    macs = h * nh * (dn + dr) + h * (r + dr) + nh * dv * h
    if layer < cfg["first_k_dense_replace"]:
        return macs + 3 * h * cfg["intermediate_size"]
    held, published = routed_experts(cfg)
    routed = cfg["num_experts_per_tok"] * held / published
    return (macs + h * published + 3 * h * cfg["moe_intermediate_size"]
            * (routed + cfg["n_shared_experts"]))


def prefill_flops(cfg: dict, history, turn: int) -> float:
    """The turn's prefill over rows with the given history lengths."""
    h, nh, dn, dr, dv, r = _dims(cfg)
    layers = cfg["num_hidden_layers"]
    rows = len(history)
    per_token = sum(token_macs(cfg, i) for i in range(layers))
    pairs = sum(turn * n + turn * (turn + 1) // 2 for n in history)
    keys = sum(n + turn for n in history)
    macs = rows * turn * per_token
    macs += layers * (pairs * nh * (dn + dr + dv) + keys * r * nh * (dn + dv))
    macs += rows * h * cfg["vocab_size"]
    return 2.0 * macs


def decode_flops(cfg: dict, lengths) -> float:
    """One decode step of rows that attend ``lengths`` positions each
    (their own included)."""
    h, nh, dn, dr, dv, r = _dims(cfg)
    layers = cfg["num_hidden_layers"]
    per_token = sum(token_macs(cfg, i) for i in range(layers))
    per_token += layers * nh * (dn + dv) * r + h * cfg["vocab_size"]
    macs = len(lengths) * per_token
    macs += layers * sum(lengths) * nh * (2 * r + dr)
    return 2.0 * macs


def turn_flops(cfg: dict, history, turn: int, answer: int) -> float:
    """A whole turn: the prefill, then ``answer - 1`` decode steps."""
    f = prefill_flops(cfg, history, turn)
    for j in range(answer - 1):
        f += decode_flops(cfg, [n + turn + j + 1 for n in history])
    return f


def k3_launch(cfg: dict, lengths) -> tuple[float, float]:
    """(bytes, FLOPs) of one kernel-3 call over rows of ``lengths`` live
    positions."""
    _, nh, _, dr, _, r = _dims(cfg)
    rows, live = len(lengths), sum(lengths)
    nbytes = BF16 * (live * (r + dr) + rows * nh * (2 * r + dr))
    return nbytes, 2.0 * live * nh * (2 * r + dr)


def k3_turn_bound_s(cfg: dict, history, turn: int, answer: int
                    ) -> tuple[int, float]:
    """(launches, summed bound seconds) of kernel 3 in a turn's decode:
    two launches (attention, combine) a layer a step."""
    layers = cfg["num_hidden_layers"]
    total = 0.0
    for j in range(answer - 1):
        total += bound_s(*k3_launch(cfg, [n + turn + j + 1 for n in history]),
                         PEAK_FLOPS["bf16"])
    return 2 * layers * (answer - 1), layers * total


def experts_touched(cfg: dict, tokens: int) -> float:
    """The expected number of held experts that ``tokens`` tokens' uniform
    choices of k among the published ones touch."""
    held, published = routed_experts(cfg)
    k = cfg["num_experts_per_tok"]
    return held * (1.0 - (1.0 - k / published) ** tokens)


def moe_launches(cfg: dict, tokens: int) -> tuple[float, float]:
    """(bytes, FLOPs) of the two expert-product launches of one expert
    layer over ``tokens`` tokens."""
    h, inter = cfg["hidden_size"], cfg["moe_intermediate_size"]
    held, published = routed_experts(cfg)
    pairs = tokens * cfg["num_experts_per_tok"] * held / published
    weights = experts_touched(cfg, tokens) * 3 * h * inter
    acts = tokens * h + 2 * pairs * inter + pairs * h
    return BF16 * (weights + acts), 2.0 * pairs * 3 * h * inter


def moe_turn_bound_s(cfg: dict, rows: int, turn: int, answer: int
                     ) -> tuple[int, float]:
    """(launches, summed bound seconds) of the expert products in a turn:
    two launches an expert layer in the prefill and in each decode step."""
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    peak = PEAK_FLOPS["bf16"]
    prefill = bound_s(*moe_launches(cfg, rows * turn), peak)
    step = bound_s(*moe_launches(cfg, rows), peak)
    return (2 * layers * answer,
            layers * (prefill + (answer - 1) * step))

