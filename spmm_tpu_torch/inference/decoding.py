"""KV-cached k-beam search and greedy decoding (counterpart of
``spmm_tpu.inference.decoding``).  Greedy decoding is a k=1 beam of the
same cache layout and kernel (``greedy_decode``).

Beam semantics replicate the reference exactly (d_pv2smiles_single.py:79-110):
  - step 0 seeds k beams from the [CLS] distribution (no SEP harvesting);
  - every later step expands k beams x k candidates, harvests every candidate
    whose new token is [SEP] with its pre-suppression logprob, then
    suppresses it to -1e5 before the top-k over the flattened k*k scores;
  - stops when >= ``stop_count`` beams have been harvested (k**2 for the
    single-query workload, k for the batched one) or after ``max_steps``;
  - stochastic mode draws k samples without replacement (Gumbel top-k) and
    scores them by log softmax probability; deterministic mode takes top-k;
  - if NO beam finished within max_steps, the live beams are returned.

The cache is append-only, [2, L, m, h, k, T, D]: the beam shuffle permutes
only the [m, k, T] ancestry matrix ``anc``, and the additive mask resolves
it at attention time.  Every layer of every step goes through
``ops.decode_attention.beam_decode_attention`` (the CUDA kernel on the GPU).
The JAX code grows the cache in segments for XLA's static shapes; here it is
allocated at ``max_len`` once and the kernel reads only the live prefix.

Every ``top_k`` of the JAX code is ``_top_k`` here: a stable descending sort,
so equal values keep their order, first occurrence first, as ``lax.top_k``
does (the harvest merge is full of -inf ties).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from spmm_tpu_torch.configs import BertArchConfig
from spmm_tpu_torch.models.bert import (
    BertForMaskedLM, local_heads, merge_heads, split_heads)
from spmm_tpu_torch.ops.attention import multi_head_attention
from spmm_tpu_torch.ops.decode_attention import (
    ancestry_mask,
    beam_decode_attention,
    beam_decode_attention_reference,
    compute_dtype,
)
from spmm_tpu_torch.ops.masks import MASK_VALUE

Tensor = torch.Tensor
# step -> uniforms in (0, 1): beam search [m, V] at step 0 and [m, k, V]
# after it; greedy decoding [B, V] at every step
UniformFn = Callable[[int], Tensor]


@dataclasses.dataclass(frozen=True)
class BeamSpec:
    k: int = 2
    stop_count: int = 4          # k**2 single-query; k batched
    max_steps: int = 100
    stochastic: bool = False
    cls_id: int = 2
    sep_id: int = 3
    vocab_size: int = 300
    # "kernel": beam_decode_attention (the CUDA kernel on a GPU tensor, its
    # plain version on a CPU one); "plain": the plain version everywhere
    attention: str = "kernel"

    @property
    def max_len(self) -> int:
        # [CLS] + seed token + max_steps tokens, rounded up to a multiple of
        # 8 as in the JAX package, so both return the same seqs shape
        return -8 * (-(self.max_steps + 2) // 8)


def _top_k(x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """``lax.top_k`` over the last axis: ties keep the first occurrence."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def init_beam_cache_kv(cfg: BertArchConfig, m: int, k: int, max_len: int,
                       dtype: torch.dtype, device,
                       heads: Optional[int] = None) -> Tensor:
    """Beam-search KV cache [2(kv), L, m, h, k, T, D], zero-filled; h is
    ``heads`` (a tensor-parallel rank's) or all of them."""
    h = cfg.num_attention_heads if heads is None else heads
    return torch.zeros((2, cfg.num_hidden_layers, m, h, k, max_len,
                        cfg.head_dim), dtype=dtype, device=device)


def decoder_heads(model: BertForMaskedLM, cfg: BertArchConfig) -> int:
    """Heads of the decoder on this rank (``num_heads / tp`` under
    tensor parallelism)."""
    return local_heads(model.bert.encoder.layer[0].attention.self.query,
                       cfg.head_dim)


def precompute_cross_kv(model: BertForMaskedLM, cfg: BertArchConfig,
                        encoder_hidden: Tensor) -> dict[str, Tensor]:
    """Cross-attention K/V for every fusion layer ([L, B, h, Le, D], zeros
    for layers without cross-attention), computed once per decode."""
    ks, vs = [], []
    h = decoder_heads(model, cfg)
    for layer in model.bert.encoder.layer:
        if layer.has_cross:
            sa = layer.crossattention.self
            k = split_heads(sa.key(encoder_hidden), h)
            v = split_heads(sa.value(encoder_hidden), h)
        else:
            b, le = encoder_hidden.shape[:2]
            k = v = encoder_hidden.new_zeros((b, h, le, cfg.head_dim))
        ks.append(k)
        vs.append(v)
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(
    model: BertForMaskedLM,
    cfg: BertArchConfig,
    token: Tensor,               # [m*k] current token ids
    pos: int,                    # position of `token`
    cache: Tensor,               # [2, L, m, h, k, T, D], appended in place
    key_valid: Tensor,           # [m*k, T] 1 = written non-pad token
    cross_kv: dict[str, Tensor],  # from precompute_cross_kv, per molecule
    cross_mask: Tensor,          # [m, Le] binary
    anc: Tensor,                 # [m, k, T] beam ancestry
    attention: str = "kernel",
) -> Tensor:
    """One cached decoder step in the beam layout; returns logits [m*k, V].

    The k beams of a molecule attend to the shared encoder K/V as k query
    positions of one attention call; self-attention goes through the fused
    append + ancestry-masked attention of each layer."""
    if attention not in ("kernel", "plain"):
        raise ValueError(f"unknown attention {attention!r}")
    attend = (beam_decode_attention if attention == "kernel"
              else beam_decode_attention_reference)
    h, d = decoder_heads(model, cfg), cfg.head_dim
    m, kb, T = anc.shape
    hidden = model.bert.embeddings(token[:, None], position_offset=pos)
    xmask = ((1.0 - cross_mask.float()) * MASK_VALUE)[:, None, None, :]
    # the cache row at pos is written by the call itself, so the prefix
    # mask covers t < pos; the current token enters as the self term
    t_ids = torch.arange(T, device=anc.device)
    prefix_valid = key_valid.reshape(m, kb, T) * (t_ids < pos)
    self_mask = ancestry_mask(anc, prefix_valid).contiguous()
    cdt = compute_dtype(cache.dtype)

    def beams(x: Tensor) -> Tensor:              # [m*k, 1, H] -> [m, h, k, D]
        return x.reshape(m, kb, h, d).transpose(1, 2).to(cdt).contiguous()

    for i, layer in enumerate(model.bert.encoder.layer):
        sa = layer.attention.self
        ctx = attend(beams(sa.query(hidden)), beams(sa.key(hidden)),
                     beams(sa.value(hidden)), cache, self_mask, pos, i)
        ctx = ctx.transpose(1, 2).reshape(m * kb, h, 1, d).to(hidden.dtype)
        att = layer.attention.output.dense(merge_heads(ctx))
        hidden = layer.attention.output.LayerNorm(att + hidden)
        if layer.has_cross:
            ca = layer.crossattention
            qx = ca.self.query(hidden).reshape(m, kb, h, d).transpose(1, 2)
            ctxx = multi_head_attention(
                qx, cross_kv["k"][i].to(qx.dtype),
                cross_kv["v"][i].to(qx.dtype), xmask)      # [m, h, kb, d]
            ctxx = ctxx.transpose(1, 2).reshape(m * kb, h, 1, d)
            attx = ca.output.dense(merge_heads(ctxx))
            hidden = ca.output.LayerNorm(attx + hidden)
        hidden = layer.mlp(hidden)
    return model.cls.predictions(hidden)[:, 0, :]


def _log_softmax(x: Tensor) -> Tensor:
    """``jax.nn.log_softmax`` in x's dtype, rounding where it rounds: the
    shift, exp and log in x's dtype, the sum of the exps in fp32."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    total = torch.exp(shifted).float().sum(dim=-1, keepdim=True)
    return shifted - torch.log(total.to(x.dtype))


def _gumbel(uniforms: Tensor) -> Tensor:
    """Gumbel noise from uniforms, as ``jax.random.gumbel`` makes it."""
    return -torch.log(-torch.log(uniforms))


def _sample_topk(logits: Tensor, k: int, stochastic: bool,
                 uniforms: Optional[Tensor]) -> tuple[Tensor, Tensor]:
    """(log softmax p of the selected, indices); stochastic = Gumbel top-k
    (== torch.multinomial without replacement, reference
    d_pv2smiles_single.py:37-44) over the given uniforms.

    The log softmax is in the logits' dtype, as in the JAX package
    (spmm_tpu/inference/decoding.py:385): under a bf16 decoder the live
    beam scores are bf16, while the harvested ones are fp32."""
    logp = _log_softmax(logits)
    if stochastic:
        _, idx = _top_k(logp + _gumbel(uniforms), k)
        vals = torch.gather(logp, -1, idx)
    else:
        vals, idx = _top_k(logp, k)
    return vals, idx


def torch_uniforms(generator: torch.Generator, m: int, k: int,
                   vocab: int, device) -> UniformFn:
    """Uniforms in [1e-20, 1) from ``generator`` for the stochastic mode."""
    def draw(step: int) -> Tensor:
        shape = (m, vocab) if step == 0 else (m, k, vocab)
        u = torch.rand(shape, generator=generator, device=device)
        return u.clamp_min_(1e-20)
    return draw


@torch.no_grad()
def beam_search_batched(
    model: BertForMaskedLM,
    cfg: BertArchConfig,
    cross_hidden: Tensor,        # [m, Le, H] encoder sequence per query
    cross_mask: Tensor,          # [m, Le] binary
    spec: BeamSpec,
    uniforms: Optional[UniformFn] = None,
    generator: Optional[torch.Generator] = None,
    cache_dtype: torch.dtype = torch.float32,
) -> dict[str, Tensor]:
    """Reference-exact k-beam decode over a batch of m queries.

    Stochastic mode takes its noise from ``uniforms`` (step -> uniforms,
    e.g. the JAX package's own draws in a parity test) or else from
    ``generator``.  Returns, with leading molecule axis m:
      seqs [m, k, max_len], logp [m, k], lengths [m, k] (incl. the trailing
      SEP), n_finished [m] (0 => live-beam fallback), and ``steps``, the
      number of decoder steps run (each one launch per layer).
    """
    dev = cross_hidden.device
    m = cross_hidden.shape[0]
    k, T = spec.k, spec.max_len
    if spec.stochastic and uniforms is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        uniforms = torch_uniforms(generator, m, k, cfg.vocab_size, dev)
    noise = uniforms if spec.stochastic else (lambda step: None)

    cross_kv = precompute_cross_kv(model, cfg, cross_hidden)
    cache = init_beam_cache_kv(cfg, m, k, T, cache_dtype, dev,
                               decoder_heads(model, cfg))
    # anc[m, b, t] = cache lane holding beam b's K/V for position t
    lane_ids = torch.arange(k, device=dev)
    anc = lane_ids[None, :, None].expand(m, k, T).contiguous()
    t_ids = torch.arange(T, device=dev)

    def step_logits(seqs: Tensor, pos: int, anc: Tensor) -> Tensor:
        key_valid = (seqs != 0).reshape(m * k, T).to(torch.int32)
        return decode_step(model, cfg, seqs.reshape(m * k, T)[:, pos], pos,
                           cache, key_valid, cross_kv, cross_mask, anc,
                           spec.attention).reshape(m, k, -1)

    # ---- step 0: [CLS] on every beam, sample k continuations ----
    seqs = torch.zeros((m, k, T), dtype=torch.int64, device=dev)
    seqs[:, :, 0] = spec.cls_id
    logits = step_logits(seqs, 0, anc)
    vals, idx = _sample_topk(logits[:, 0], k, spec.stochastic, noise(0))
    seqs[:, :, 1] = idx                   # beams share the CLS-cache entries
    logp = vals                           # [m, k]
    n_steps = 1

    # running top-k of harvested beams; the buffer comes before the new
    # candidates in the merge, so earlier harvests win ties
    fin_seqs = torch.zeros((m, k, T), dtype=torch.int64, device=dev)
    fin_logp = torch.full((m, k), float("-inf"), dtype=torch.float32,
                          device=dev)
    fin_len = torch.zeros((m, k), dtype=torch.int64, device=dev)
    fin_cnt = torch.zeros((m,), dtype=torch.int64, device=dev)
    done = torch.zeros((m,), dtype=torch.bool, device=dev)

    step = 0
    while step < spec.max_steps and not bool(done.all()):
        pos = step + 1                    # position of the newest token
        logits = step_logits(seqs, pos, anc)
        n_steps += 1
        vals, idx = _sample_topk(logits, k, spec.stochastic, noise(step + 1))
        k2_p = logp[:, :, None] + vals                      # [m, k, k]

        cand_seqs = seqs.repeat_interleave(k, dim=1)        # [m, k*k, T]
        cand_seqs[:, :, pos + 1] = idx.reshape(m, k * k)

        # ---- harvest SEP-ended candidates into the running top-k ----
        ended = (idx == spec.sep_id).reshape(m, k * k)
        flat_p = k2_p.reshape(m, k * k)
        merged_logp = torch.cat(
            [fin_logp, torch.where(ended, flat_p, float("-inf"))], dim=1)
        merged_seqs = torch.cat([fin_seqs, cand_seqs], dim=1)
        merged_len = torch.cat(
            [fin_len, torch.full((m, k * k), pos + 2, dtype=torch.int64,
                                 device=dev)], dim=1)
        new_fin_logp, top = _top_k(merged_logp, k)
        new_fin_seqs = torch.gather(
            merged_seqs, 1, top[:, :, None].expand(m, k, T))
        new_fin_len = torch.gather(merged_len, 1, top)
        new_fin_cnt = fin_cnt + ended.sum(dim=1)

        # ---- suppress harvested entries, then select the next beams ----
        k2_sup = torch.where(ended.reshape(m, k, k),
                             torch.full_like(k2_p, -1e5), k2_p)
        new_logp, flat_idx = _top_k(k2_sup.reshape(m, k * k), k)
        parent = flat_idx // k                              # [m, k]
        new_seqs = torch.gather(cand_seqs, 1,
                                flat_idx[:, :, None].expand(m, k, T))
        # written positions inherit the parent's ancestry (this step wrote
        # lane p at pos); later positions write into the beam's own lane
        new_anc = torch.where(t_ids[None, None, :] > pos,
                              lane_ids[None, :, None],
                              torch.gather(anc, 1,
                                           parent[:, :, None].expand(m, k, T)))

        # freeze the outputs of finished molecules; the cache and the
        # ancestry advance harmlessly
        def keep(new: Tensor, old: Tensor) -> Tensor:
            d = done.reshape((m,) + (1,) * (new.dim() - 1))
            return torch.where(d, old, new)

        seqs, logp = keep(new_seqs, seqs), keep(new_logp, logp)
        fin_seqs = keep(new_fin_seqs, fin_seqs)
        fin_logp = keep(new_fin_logp, fin_logp)
        fin_len = keep(new_fin_len, fin_len)
        fin_cnt, done = (keep(new_fin_cnt, fin_cnt),
                         done | (new_fin_cnt >= spec.stop_count))
        anc = new_anc.contiguous()
        step += 1

    # fallback: nothing harvested within max_steps -> the live beams
    no_fin = (fin_cnt == 0)[:, None]
    live_len = torch.full((m, k), step + 2, dtype=torch.int64, device=dev)
    return {
        "seqs": torch.where(no_fin[:, :, None], seqs, fin_seqs),
        "logp": torch.where(no_fin, logp, fin_logp),
        "lengths": torch.where(no_fin, live_len, fin_len),
        "n_finished": fin_cnt,
        "steps": n_steps,
    }


def beam_search(
    model: BertForMaskedLM,
    cfg: BertArchConfig,
    cross_hidden: Tensor,        # [Le, H]
    cross_mask: Tensor,          # [Le]
    spec: BeamSpec,
    uniforms: Optional[UniformFn] = None,
    generator: Optional[torch.Generator] = None,
    cache_dtype: torch.dtype = torch.float32,
) -> dict:
    """Single-query k-beam decode (beam_search_batched with m=1)."""
    out = beam_search_batched(model, cfg, cross_hidden[None], cross_mask[None],
                              spec, uniforms, generator, cache_dtype)
    return {key: v if key == "steps" else v[0] for key, v in out.items()}


@torch.no_grad()
def greedy_decode(
    model: BertForMaskedLM,
    cfg: BertArchConfig,
    cross_hidden: Tensor,        # [B, Le, H]
    cross_mask: Tensor,          # [B, Le] binary
    max_steps: int = 100,
    stochastic: bool = False,
    uniforms: Optional[UniformFn] = None,
    cls_id: int = 2,
    sep_id: int = 3,
    cache_dtype: torch.dtype = torch.float32,
    attention: str = "kernel",
) -> dict:
    """Batch greedy / stochastic decode (``greedy_decode`` of the JAX
    package, spmm_tpu/inference/decoding.py:632-693; reference
    d_rxn_prediction.py:55-81), run as its kernel path runs it: a k=1 beam
    through ``decode_step``, with a single-lane cache [2, L, B, h, 1, T, D],
    an all-zero ancestry [B, 1, T] and T = max_steps + 2 rounded up to a
    multiple of 8.  Every layer of every step goes through
    ``beam_decode_attention`` (``attention="kernel"``) or its plain version
    (``"plain"``).

    Each row decodes until it has emitted [SEP] or for ``max_steps`` steps;
    the stop test runs after the append, and rows keep appending after
    their [SEP].  Keys are valid where ``seqs != 0``.  Stochastic mode
    takes argmax(logits + Gumbel noise), which is what
    ``jax.random.categorical`` computes, with the noise of step s made from
    ``uniforms(s)`` [B, V] as ``_sample_topk`` makes it (e.g. from JAX's
    own draws in a parity test).  Returns ``seqs`` [B, T] and ``steps``,
    the number of decoder steps run."""
    if stochastic and uniforms is None:
        raise ValueError("stochastic greedy decoding needs uniforms")
    dev = cross_hidden.device
    b = cross_hidden.shape[0]
    T = -8 * (-(max_steps + 2) // 8)
    cross_kv = precompute_cross_kv(model, cfg, cross_hidden)
    cache = init_beam_cache_kv(cfg, b, 1, T, cache_dtype, dev,
                               decoder_heads(model, cfg))
    anc = torch.zeros((b, 1, T), dtype=torch.int64, device=dev)
    seqs = torch.zeros((b, T), dtype=torch.int64, device=dev)
    seqs[:, 0] = cls_id
    step = 0
    ended_all = False
    while step < max_steps and not ended_all:
        key_valid = (seqs != 0).to(torch.int32)
        logits = decode_step(model, cfg, seqs[:, step], step, cache,
                             key_valid, cross_kv, cross_mask, anc, attention)
        if stochastic:
            logits = logits + _gumbel(uniforms(step)).to(logits.dtype)
        seqs[:, step + 1] = logits.argmax(dim=-1)
        ended_all = bool((seqs == sep_id).any(dim=1).all())
        step += 1
    return {"seqs": seqs, "steps": step}
