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
``ops.decode_attention.beam_decode_attention`` (kernel 1 on the GPU), and
every fusion layer's cross-attention through
``ops.decode_cross_attention.decode_cross_attention`` (kernel 4).
The JAX code grows the cache in segments for XLA's static shapes; here it is
allocated at ``max_len`` once and the kernel reads only the live prefix.

Every ``top_k`` of the JAX code is ``_top_k`` here: a stable descending sort,
so equal values keep their order, first occurrence first, as ``lax.top_k``
does (the harvest merge is full of -inf ties).

The JAX package runs the whole loop on the device inside ``lax.while_loop``
segments.  Here a decode has three parts: a prologue (the cross K/V,
``precompute_cross_kv``, and the state loaded and reset), a step body that
reads and writes a fixed set of state tensors in place (``_BeamDecode``,
``_GreedyDecode``), and a runner.  On a CUDA tensor the runner replays the
body as CUDA graphs, one captured per position (one for every step of the
latent decode, ``_LatentDecode``) and kept per shape
(``DecodeGraphs``, ``graph_cache``), with no per-step Python dispatch of
the step's ops; on a CPU tensor, and for a decoder laid out by tensor
parallelism, it calls the body step by step (``beam_search_batched_eager``,
``greedy_decode_eager``, also callable on the card by name).  Either way
the host reads the stop test after each step, so ``steps``, the early exit
and the noise drawn are the same.

Under ``torch.profiler`` the runner names its parts as ranges of the trace
(``utils.spans.span``): ``spmm.decode.cross_kv``, ``.load``, ``.loop``
holding each ``.step`` (a replay, or an eager step) and ``.stop_test``,
and ``.result``; never inside a captured step body.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Callable, Optional

import torch

from spmm_tpu_torch.configs import BertArchConfig
from spmm_tpu_torch.models.bert import (
    BertForMaskedLM, local_heads, merge_heads, split_heads)
from spmm_tpu_torch.ops._build import captured_launches, count_launch
from spmm_tpu_torch.ops.decode_attention import (
    ancestry_mask,
    beam_decode_attention,
    beam_decode_attention_reference,
    compute_dtype,
)
from spmm_tpu_torch.ops.decode_cross_attention import (
    decode_cross_attention,
    decode_cross_attention_reference,
)
from spmm_tpu_torch.utils.spans import span

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
    # "kernel": beam_decode_attention and decode_cross_attention (the CUDA
    # kernels on a GPU tensor, their plain versions on a CPU one); "plain":
    # the plain versions everywhere
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

    Self-attention goes through the fused append + ancestry-masked
    attention of each layer (kernel 1), cross-attention through one call a
    fusion layer in which the k beams of a molecule attend its encoder K/V
    (kernel 4); ``attention="plain"`` takes both plain versions."""
    if attention not in ("kernel", "plain"):
        raise ValueError(f"unknown attention {attention!r}")
    attend, cross = ((beam_decode_attention, decode_cross_attention)
                     if attention == "kernel" else
                     (beam_decode_attention_reference,
                      decode_cross_attention_reference))
    h, d = decoder_heads(model, cfg), cfg.head_dim
    m, kb, T = anc.shape
    hidden = model.bert.embeddings(token[:, None], position_offset=pos)
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
            ctxx = cross(ca.self.query(hidden), cross_kv["k"][i],
                         cross_kv["v"][i], cross_mask)  # [m*kb, 1, h*d]
            attx = ca.output.dense(ctxx)
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


# ---- the decode state: buffers allocated once, one step body ----

class _Decode:
    """One decode's buffers and its step body, which reads and writes them
    in place (``copy_``, never rebinding), so that a CUDA graph captured
    from the body replays on the same memory; the eager loop runs the same
    body.  ``load`` is the prologue, ``result`` the epilogue."""

    kind = ""

    def buffers(self) -> list[Tensor]:
        """Every tensor the state holds."""
        out = []
        for value in vars(self).values():
            if isinstance(value, dict):
                out += [t for t in value.values() if isinstance(t, Tensor)]
            elif isinstance(value, Tensor):
                out.append(value)
        return out

    def stopped(self) -> bool:
        """The stop test of the last step, read on the host."""
        return bool(self.stop)

    def graph_key(self, pos: int) -> int:
        """Which captured graph replays the step at ``pos``: one a position
        (kernel 1 sizes its shared memory by position)."""
        return pos

    def prepare(self) -> None:
        """Before the first capture: the step's kernel loaded and its
        shared-memory limit raised, with no launch."""
        raise NotImplementedError


class _CrossDecode(_Decode):
    """A decoder cross-attending to an encoder: a call loads its cross K/V
    and mask into the state; the beam-layout cache [2, L, m, h, k, T, D],
    kernel 1 and kernel 4."""

    def prepare(self) -> None:
        if self.attention == "kernel":
            from spmm_tpu_torch.ops import decode_attention
            from spmm_tpu_torch.ops import decode_cross_attention as cross

            decode_attention.prepare(self.cache)
            cross.prepare(self.cross["k"], self.cache.shape[4])

    def _load_inputs(self, cross_kv: dict[str, Tensor],
                     cross_mask: Tensor) -> None:
        for name, value in cross_kv.items():
            self.cross[name].copy_(value)
        self.cross_mask.copy_(cross_mask)
        self.cache.zero_()
        self.stop.zero_()

    def describe(self) -> dict:
        _, _, m, _, k, T, _ = self.cache.shape
        return {"kind": self.kind, "m": m, "k": k, "T": T,
                "Le": self.cross_mask.shape[1],
                "cache_dtype": str(self.cache.dtype).split(".")[-1],
                "attention": self.attention, "stochastic": self.stochastic}


class _BeamDecode(_CrossDecode):
    """State of ``beam_search_batched``: seqs, logp and anc; the running
    top-k of harvested beams (fin_*), done and the stop flag; the KV cache;
    this call's cross K/V and mask; the noise buffers of the stochastic
    mode (float32, as ``torch_uniforms`` draws).  The live scores ``logp``
    are held in fp32, which holds a bf16 score exactly, and used in the
    logits' dtype, so a bf16 decoder's scores stay bf16 as in JAX."""

    kind = "beam"

    def __init__(self, model: BertForMaskedLM, cfg: BertArchConfig,
                 spec: BeamSpec, cross_kv: dict[str, Tensor],
                 cross_mask: Tensor, cache_dtype: torch.dtype):
        dev = cross_mask.device
        m, k, T = cross_mask.shape[0], spec.k, spec.max_len
        self.model, self.cfg, self.spec = model, cfg, spec
        self.attention, self.stochastic = spec.attention, spec.stochastic
        self.cache = init_beam_cache_kv(cfg, m, k, T, cache_dtype, dev,
                                        decoder_heads(model, cfg))
        self.cross = {name: torch.empty_like(v) for name, v in cross_kv.items()}
        self.cross_mask = torch.empty_like(cross_mask)
        self.lane_ids = torch.arange(k, device=dev)
        self.t_ids = torch.arange(T, device=dev)
        ints = {"dtype": torch.int64, "device": dev}
        self.seqs = torch.zeros((m, k, T), **ints)
        self.logp = torch.zeros((m, k), dtype=torch.float32, device=dev)
        # anc[m, b, t] = cache lane holding beam b's K/V for position t
        self.anc = torch.zeros((m, k, T), **ints)
        # running top-k of harvested beams; the buffer comes before the new
        # candidates in the merge, so earlier harvests win ties
        self.fin_seqs = torch.zeros((m, k, T), **ints)
        self.fin_logp = torch.zeros((m, k), dtype=torch.float32, device=dev)
        self.fin_len = torch.zeros((m, k), **ints)
        self.fin_cnt = torch.zeros((m,), **ints)
        self.done = torch.zeros((m,), dtype=torch.bool, device=dev)
        self.stop = torch.zeros((), dtype=torch.bool, device=dev)
        if spec.stochastic:
            self.noise0 = torch.full((m, cfg.vocab_size), 0.5, device=dev)
            self.noise = torch.full((m, k, cfg.vocab_size), 0.5, device=dev)

    def load(self, cross_kv: dict[str, Tensor], cross_mask: Tensor) -> None:
        """This call's inputs into the buffers, every other state tensor
        and the cache reset: a call's result does not depend on the last.
        (Kernel 1 reads whole 32-row tiles of the cache, whose rows at and
        past ``pos`` its mask zeroes: they must hold finite values, as the
        zeros do.)"""
        self._load_inputs(cross_kv, cross_mask)
        self.seqs.zero_()
        self.seqs[:, :, 0] = self.spec.cls_id
        self.logp.zero_()
        self.anc.copy_(self.lane_ids[None, :, None].expand_as(self.anc))
        self.fin_seqs.zero_()
        self.fin_logp.fill_(float("-inf"))
        self.fin_len.zero_()
        self.fin_cnt.zero_()
        self.done.zero_()

    def feed(self, pos: int, uniforms: Optional[UniformFn]) -> None:
        """Step ``pos``'s noise into its buffer (stochastic mode)."""
        if self.spec.stochastic:
            (self.noise0 if pos == 0 else self.noise).copy_(uniforms(pos))

    def step(self, pos: int, attention: Optional[str] = None) -> None:
        """Decoder step at ``pos``: pos 0 seeds k beams from the [CLS]
        distribution; each later step expands, harvests and selects."""
        spec = self.spec
        m, k, T = self.seqs.shape
        seqs, logp, anc, done = self.seqs, self.logp, self.anc, self.done
        key_valid = (seqs != 0).reshape(m * k, T).to(torch.int32)
        logits = decode_step(self.model, self.cfg,
                             seqs.reshape(m * k, T)[:, pos], pos, self.cache,
                             key_valid, self.cross, self.cross_mask, anc,
                             attention or self.attention).reshape(m, k, -1)
        if pos == 0:                      # [CLS] on every beam
            vals, idx = _sample_topk(logits[:, 0], k, spec.stochastic,
                                     self.noise0 if spec.stochastic else None)
            seqs[:, :, 1] = idx           # beams share the CLS-cache entries
            logp.copy_(vals)
            return
        vals, idx = _sample_topk(logits, k, spec.stochastic,
                                 self.noise if spec.stochastic else None)
        k2_p = logp.to(vals.dtype)[:, :, None] + vals       # [m, k, k]
        cand_seqs = seqs[:, :, None].expand(m, k, k, T).reshape(m, k * k, T)
        cand_seqs[:, :, pos + 1] = idx.reshape(m, k * k)

        # ---- harvest SEP-ended candidates into the running top-k ----
        ended = (idx == spec.sep_id).reshape(m, k * k)
        flat_p = k2_p.reshape(m, k * k)
        merged_logp = torch.cat(
            [self.fin_logp, torch.where(ended, flat_p, float("-inf"))], dim=1)
        merged_seqs = torch.cat([self.fin_seqs, cand_seqs], dim=1)
        merged_len = torch.cat(
            [self.fin_len, torch.full((m, k * k), pos + 2, dtype=torch.int64,
                                      device=seqs.device)], dim=1)
        new_fin_logp, top = _top_k(merged_logp, k)
        new_fin_seqs = torch.gather(
            merged_seqs, 1, top[:, :, None].expand(m, k, T))
        new_fin_len = torch.gather(merged_len, 1, top)
        new_fin_cnt = self.fin_cnt + ended.sum(dim=1)

        # ---- suppress harvested entries, then select the next beams ----
        k2_sup = torch.where(ended.reshape(m, k, k),
                             torch.full_like(k2_p, -1e5), k2_p)
        new_logp, flat_idx = _top_k(k2_sup.reshape(m, k * k), k)
        parent = flat_idx // k                              # [m, k]
        new_seqs = torch.gather(cand_seqs, 1,
                                flat_idx[:, :, None].expand(m, k, T))
        # written positions inherit the parent's ancestry (this step wrote
        # lane p at pos); later positions write into the beam's own lane
        new_anc = torch.where(self.t_ids[None, None, :] > pos,
                              self.lane_ids[None, :, None],
                              torch.gather(anc, 1,
                                           parent[:, :, None].expand(m, k, T)))

        # freeze the outputs of finished molecules; the cache and the
        # ancestry advance harmlessly
        for old, new in ((seqs, new_seqs), (logp, new_logp),
                         (self.fin_seqs, new_fin_seqs),
                         (self.fin_logp, new_fin_logp),
                         (self.fin_len, new_fin_len),
                         (self.fin_cnt, new_fin_cnt)):
            frozen = done.reshape((m,) + (1,) * (new.dim() - 1))
            old.copy_(torch.where(frozen, old, new))
        anc.copy_(new_anc)
        done |= new_fin_cnt >= spec.stop_count
        self.stop.copy_(done.all())

    def result(self, steps: int) -> dict[str, Tensor]:
        """The outputs after ``steps`` decoder steps, in fresh tensors;
        nothing harvested within max_steps -> the live beams."""
        m, k = self.logp.shape
        no_fin = (self.fin_cnt == 0)[:, None]
        live_len = torch.full((m, k), steps + 1, dtype=torch.int64,
                              device=no_fin.device)
        return {
            "seqs": torch.where(no_fin[:, :, None], self.seqs, self.fin_seqs),
            "logp": torch.where(no_fin, self.logp, self.fin_logp),
            "lengths": torch.where(no_fin, live_len, self.fin_len),
            "n_finished": self.fin_cnt.clone(),
            "steps": steps,
        }


class _GreedyDecode(_CrossDecode):
    """State of ``greedy_decode``: seqs [B, T], the single-lane cache, an
    all-zero ancestry, this call's cross K/V and mask, the stop flag and
    the noise buffer of the stochastic mode (float32)."""

    kind = "greedy"

    def __init__(self, model: BertForMaskedLM, cfg: BertArchConfig, T: int,
                 cross_kv: dict[str, Tensor], cross_mask: Tensor,
                 cache_dtype: torch.dtype, stochastic: bool, cls_id: int,
                 sep_id: int, attention: str):
        dev = cross_mask.device
        b = cross_mask.shape[0]
        self.model, self.cfg = model, cfg
        self.cls_id, self.sep_id, self.attention = cls_id, sep_id, attention
        self.stochastic = stochastic
        self.cache = init_beam_cache_kv(cfg, b, 1, T, cache_dtype, dev,
                                        decoder_heads(model, cfg))
        self.cross = {name: torch.empty_like(v) for name, v in cross_kv.items()}
        self.cross_mask = torch.empty_like(cross_mask)
        self.anc = torch.zeros((b, 1, T), dtype=torch.int64, device=dev)
        self.seqs = torch.zeros((b, T), dtype=torch.int64, device=dev)
        self.stop = torch.zeros((), dtype=torch.bool, device=dev)
        self.noise = (torch.full((b, cfg.vocab_size), 0.5, device=dev)
                      if stochastic else None)

    def load(self, cross_kv: dict[str, Tensor], cross_mask: Tensor) -> None:
        self._load_inputs(cross_kv, cross_mask)
        self.seqs.zero_()
        self.seqs[:, 0] = self.cls_id

    def feed(self, pos: int, uniforms: Optional[UniformFn]) -> None:
        if self.noise is not None:
            self.noise.copy_(uniforms(pos))

    def step(self, pos: int, attention: Optional[str] = None) -> None:
        """Append the token after ``pos``; the stop test runs after the
        append, and rows keep appending after their [SEP]."""
        key_valid = (self.seqs != 0).to(torch.int32)
        logits = decode_step(self.model, self.cfg, self.seqs[:, pos], pos,
                             self.cache, key_valid, self.cross,
                             self.cross_mask, self.anc,
                             attention or self.attention)
        if self.noise is not None:
            logits = logits + _gumbel(self.noise).to(logits.dtype)
        self.seqs[:, pos + 1] = logits.argmax(dim=-1)
        self.stop.copy_((self.seqs == self.sep_id).any(dim=1).all())

    def result(self, steps: int) -> dict:
        return {"seqs": self.seqs.clone(), "steps": steps}


class _LatentDecode(_Decode):
    """State of ``latent_decode``: greedy decoding of a decoder-only latent
    MoE model (``models.latent_moe``) over a session cache [L, B, T, latent
    + rope] that the caller holds (``inference.lm.SessionCache``), each row
    at its own position.  Its prologue is the caller's prefill into that
    cache; ``load`` takes the first answer token and the rows' positions.
    A step feeds each row's last token at its position, writes its cache
    row there and appends the argmax, with no stop; the step body does not
    depend on ``pos`` (the positions and the answer column live on the
    device), so one graph replays every step."""

    kind = "latent"

    def __init__(self, model, cache: Tensor, n_answer: int):
        dev = cache.device
        b = cache.shape[1]
        self.model, self.cache = model, cache
        ints = {"dtype": torch.int64, "device": dev}
        self.tokens = torch.zeros((b,), **ints)
        self.pos = torch.zeros((b,), **ints)
        self.answers = torch.zeros((b, n_answer), **ints)
        self.column = torch.zeros((b, 1), **ints)
        self.stop = torch.zeros((), dtype=torch.bool, device=dev)

    def load(self, first: Tensor, positions: Tensor) -> None:
        """The first answer token of each row (from the prefill) and the
        position it takes; the answers reset."""
        self.tokens.copy_(first)
        self.pos.copy_(positions)
        self.answers.zero_()
        self.answers[:, 0] = first
        self.column.fill_(1)

    def feed(self, pos: int, uniforms: Optional[UniformFn]) -> None:
        pass

    def step(self, pos: int, attention: Optional[str] = None) -> None:
        logits = self.model.decode_step(self.cache, self.tokens, self.pos,
                                        attention or "kernel")
        nxt = logits.argmax(dim=-1)
        self.answers.scatter_(1, self.column, nxt[:, None])
        self.tokens.copy_(nxt)
        self.pos += 1
        self.column += 1

    def graph_key(self, pos: int) -> int:
        return 0

    def prepare(self) -> None:
        from spmm_tpu_torch.ops import mla_decode, moe

        mla_decode.prepare(self.cache)
        moe.prepare(self.cache.device)

    def describe(self) -> dict:
        layers, b, T, width = self.cache.shape
        return {"kind": self.kind, "rows": b, "T": T, "layers": layers,
                "width": width, "answer": self.answers.shape[1],
                "cache_dtype": str(self.cache.dtype).split(".")[-1]}

    def result(self, steps: int) -> dict:
        return {"answers": self.answers.clone(), "steps": steps}


def _drive(state: _Decode, run_step: Callable[[int], None], n_pos: int,
           uniforms: Optional[UniformFn]) -> int:
    """Positions 0, 1, ... up to ``n_pos``, each after its noise is fed
    (so ``uniforms`` is called once a step run, in order); the host reads
    the stop test after each step.  Returns the number of steps run."""
    pos = 0
    with span("spmm.decode.loop"):
        while pos < n_pos:
            state.feed(pos, uniforms)
            with span("spmm.decode.step"):
                run_step(pos)
            pos += 1
            if pos < n_pos:
                with span("spmm.decode.stop_test"):
                    if state.stopped():
                        break
    return pos


# ---- the decode loop as captured CUDA graphs ----

_thread = threading.local()
_thread_ids = itertools.count()


def _thread_token() -> int:
    """A number for this thread, never given to another one."""
    token = getattr(_thread, "token", None)
    if token is None:
        token = _thread.token = next(_thread_ids)
    return token


class _Entry:
    """One shape's decode state, its graphs (by ``_Decode.graph_key``) and
    their launches."""

    def __init__(self, state: _Decode):
        self.state = state
        self.device = state.cache.device
        self.graphs: dict = {}
        self.launches: dict[int, dict] = {}
        self.lock = threading.Lock()
        self.warmed: set[int] = set()      # the threads it was warmed up in
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.stream = None
        self.pool = None

    def describe(self) -> dict:
        return {**self.state.describe(), "graphs": len(self.graphs),
                "capture_s": self.capture_s, "pool_bytes": self.pool_bytes,
                "state_bytes": sum(t.nbytes for t in self.state.buffers())}


class DecodeGraphs:
    """The decode loops as captured CUDA graphs: the counterpart of the JAX
    package's decode inside ``lax.while_loop`` segments, where one compiled
    program runs a batch's decode.

    Each decode shape (``_shape_key``: the decoder and its weights' storage,
    the device, the inputs' and cache's shapes and dtypes, the search's
    fields) has an entry: the decode's buffers (``_BeamDecode``,
    ``_GreedyDecode``, ``_LatentDecode``), its graphs, captured from the
    step body when a decode first reaches a position of a new
    ``graph_key`` (one a position where kernel 1 sizes its shared memory
    by position; one for all of the latent decode's steps), all in one
    memory pool and replayed in position order, and each graph's kernel
    launches, which ``count_launch`` adds at every replay (the capture
    itself launches nothing).  A call copies its
    inputs into the entry's buffers and resets the rest, so its result
    equals a fresh eager decode's; then it replays, feeding each step's
    noise before the replay and reading the stop test after it (one small
    copy to the host), so ``steps`` and the draws are the eager loop's.

    The entries of the ``MAX_SHAPES`` shapes used last are kept (each holds
    its KV cache, up to 3.93 GB at bf16 m=512, k=2, T=104, or a reference
    to the session cache of a latent decode, and its decoder); the least
    recently used is dropped past that.  A weight
    updated in place is seen by the graphs; replaced storage makes a new
    key.  A capture or replay error raises and drops the entry: nothing
    falls back to the eager loop."""

    MAX_SHAPES = 4

    def __init__(self):
        self.captured = 0               # graphs captured, over the process
        self.capture_s = 0.0            # seconds spent capturing them
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def clear(self) -> None:
        """Drop every entry (their graphs, pools, buffers and decoders)."""
        with self._lock:
            self._entries.clear()

    def stats(self) -> dict:
        """Graphs captured and capture seconds so far; each kept shape's
        graphs, capture seconds, pool and buffer bytes."""
        with self._lock:
            entries = list(self._entries.values())
        return {"captured": self.captured, "capture_s": self.capture_s,
                "shapes": [e.describe() for e in entries]}

    def run(self, key: tuple, make: Callable[[], _Decode], inputs: tuple,
            n_pos: int, uniforms: Optional[UniformFn]) -> dict:
        """One decode of shape ``key`` (``make`` builds its state the first
        time) through the entry's graphs; ``inputs`` are what the state's
        ``load`` takes."""
        entry = self._entry(key, make)
        on_device = (torch.cuda.device(entry.device)
                     if entry.device.type == "cuda" else contextlib.nullcontext())
        with entry.lock, on_device:
            try:
                with span("spmm.decode.load"):
                    entry.state.load(*inputs)
                    if _thread_token() not in entry.warmed:
                        self._warm_up(entry)
                        entry.warmed.add(_thread_token())
                        entry.state.load(*inputs)
                steps = _drive(entry.state,
                               lambda pos: self._replay(entry, pos), n_pos,
                               uniforms)
                with span("spmm.decode.result"):
                    return entry.state.result(steps)
            except BaseException:
                with self._lock:
                    if self._entries.get(key) is entry:
                        del self._entries[key]
                raise

    def _entry(self, key: tuple, make: Callable[[], _Decode]) -> _Entry:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                return entry
        entry = _Entry(make())
        with self._lock:
            self._entries[key] = entry
            while len(self._entries) > self.MAX_SHAPES:
                self._entries.popitem(last=False)
        return entry

    def _replay(self, entry: _Entry, pos: int) -> None:
        key = entry.state.graph_key(pos)
        graph = entry.graphs.get(key)
        if graph is None:
            t0 = time.perf_counter()
            with captured_launches() as launches:
                graph = self._capture(entry, pos)
            seconds = time.perf_counter() - t0
            entry.graphs[key], entry.launches[key] = graph, launches
            entry.capture_s += seconds
            with self._lock:
                self.captured += 1
                self.capture_s += seconds
        graph.replay()
        for wrapper, n in entry.launches[key].items():
            count_launch(wrapper, n)

    def _warm_up(self, entry: _Entry) -> None:
        """Before the first capture in a thread: the step's kernel loaded
        and its shared-memory limit raised, with no launch
        (``_Decode.prepare``); positions 0 and 1 of the step body on the
        plain attention on the capture stream, so that cuBLAS's handle and
        workspace for this thread and stream exist before any capture.  It
        writes the state, which the call then loads again."""
        state = entry.state
        if entry.stream is None:
            entry.stream = torch.cuda.Stream(entry.device)
            entry.pool = torch.cuda.graph_pool_handle()
        state.prepare()
        current = torch.cuda.current_stream(entry.device)
        entry.stream.wait_stream(current)
        with torch.cuda.stream(entry.stream):
            for pos in (0, 1):
                state.step(pos, attention="plain")
        current.wait_stream(entry.stream)

    def _capture(self, entry: _Entry, pos: int):
        """The step body at ``pos`` captured on the entry's stream into its
        pool (nothing runs); ``thread_local``, so that another thread's
        work (a service's HTTP threads) does not break the capture."""
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(entry.device)
        entry.stream.wait_stream(current)
        reserved = torch.cuda.memory_reserved(entry.device)
        with torch.cuda.stream(entry.stream):
            graph.capture_begin(pool=entry.pool,
                                capture_error_mode="thread_local")
            try:
                entry.state.step(pos)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
        current.wait_stream(entry.stream)
        entry.pool_bytes += torch.cuda.memory_reserved(entry.device) - reserved
        return graph


graph_cache = DecodeGraphs()


def _tp_laid_out(model: BertForMaskedLM) -> bool:
    """Whether ``parallel.tp`` laid the decoder out (DTensor weights)."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return any(isinstance(p, DTensor) for p in model.parameters())


def _graphs_for(model: BertForMaskedLM, device: torch.device
                ) -> Optional[DecodeGraphs]:
    """The graph cache a decode on ``device`` runs through: ``graph_cache``
    on a CUDA device, None (the eager loop) on the CPU and for a decoder
    laid out by tensor parallelism, whose steps hold collectives."""
    if device.type != "cuda" or _tp_laid_out(model):
        return None
    return graph_cache


def _shape_key(kind: str, model: BertForMaskedLM, cross_kv: dict[str, Tensor],
               cross_mask: Tensor, cache_dtype: torch.dtype,
               **fields) -> tuple:
    """What fixes a decode's graphs: the decoder object and the storage of
    its weights (which the graphs read), the inputs' and the cache's shapes
    and dtypes on their device (the cross K/V's is the decoder's dtype),
    and the search's own fields."""
    weights = tuple(t.data_ptr() for t in itertools.chain(
        model.parameters(), model.buffers()))
    return (kind, id(model), weights, cross_mask.device,
            tuple(cross_kv["k"].shape), cross_kv["k"].dtype,
            tuple(cross_mask.shape), cross_mask.dtype, cache_dtype,
            tuple(sorted(fields.items())))


def _run(graphs: Optional[DecodeGraphs], key: Callable[[], tuple],
         make: Callable[[], _Decode], inputs: tuple, n_pos: int,
         uniforms: Optional[UniformFn]) -> dict:
    """A decode through ``graphs``, or eagerly where there are none."""
    if graphs is not None:
        return graphs.run(key(), make, inputs, n_pos, uniforms)
    state = make()
    with span("spmm.decode.load"):
        state.load(*inputs)
    steps = _drive(state, state.step, n_pos, uniforms)
    with span("spmm.decode.result"):
        return state.result(steps)


# ---- the decode entry points ----

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

    Stochastic mode takes its noise from ``uniforms`` (step -> float32
    uniforms, e.g. the JAX package's own draws in a parity test) or else
    from ``generator``.  Returns, with leading molecule axis m:
      seqs [m, k, max_len], logp [m, k], lengths [m, k] (incl. the trailing
      SEP), n_finished [m] (0 => live-beam fallback), and ``steps``, the
      number of decoder steps run (each one launch per layer).

    On a CUDA tensor the steps replay as CUDA graphs (``graph_cache``), on
    the CPU and for a decoder laid out by tensor parallelism they run
    eagerly (``beam_search_batched_eager``); both run one step body.
    """
    return _beam_search(model, cfg, cross_hidden, cross_mask, spec, uniforms,
                        generator, cache_dtype,
                        _graphs_for(model, cross_hidden.device))


@torch.no_grad()
def beam_search_batched_eager(
    model: BertForMaskedLM,
    cfg: BertArchConfig,
    cross_hidden: Tensor,
    cross_mask: Tensor,
    spec: BeamSpec,
    uniforms: Optional[UniformFn] = None,
    generator: Optional[torch.Generator] = None,
    cache_dtype: torch.dtype = torch.float32,
) -> dict[str, Tensor]:
    """``beam_search_batched`` with every step's ops issued from Python, on
    any device: the reference its graphs are held to on the card."""
    return _beam_search(model, cfg, cross_hidden, cross_mask, spec, uniforms,
                        generator, cache_dtype, None)


def _beam_search(model, cfg, cross_hidden, cross_mask, spec, uniforms,
                 generator, cache_dtype, graphs) -> dict[str, Tensor]:
    dev = cross_hidden.device
    if spec.stochastic and uniforms is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        uniforms = torch_uniforms(generator, cross_hidden.shape[0], spec.k,
                                  cfg.vocab_size, dev)
    with span("spmm.decode.cross_kv"):
        cross_kv = precompute_cross_kv(model, cfg, cross_hidden)
    return _run(
        graphs,
        lambda: _shape_key("beam", model, cross_kv, cross_mask, cache_dtype,
                           k=spec.k, T=spec.max_len,
                           stop_count=spec.stop_count,
                           stochastic=spec.stochastic,
                           attention=spec.attention, cls_id=spec.cls_id,
                           sep_id=spec.sep_id),
        lambda: _BeamDecode(model, cfg, spec, cross_kv, cross_mask,
                            cache_dtype),
        (cross_kv, cross_mask), spec.max_steps + 1, uniforms)


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
    ``beam_decode_attention`` and every fusion layer through
    ``decode_cross_attention`` (``attention="kernel"``), or through their
    plain versions (``"plain"``).

    Each row decodes until it has emitted [SEP] or for ``max_steps`` steps;
    the stop test runs after the append, and rows keep appending after
    their [SEP].  Keys are valid where ``seqs != 0``.  Stochastic mode
    takes argmax(logits + Gumbel noise), which is what
    ``jax.random.categorical`` computes, with the noise of step s made from
    ``uniforms(s)`` [B, V] (float32) as ``_sample_topk`` makes it (e.g.
    from JAX's own draws in a parity test).  Returns ``seqs`` [B, T] and
    ``steps``, the number of decoder steps run.  Graphs on a CUDA tensor,
    eager elsewhere, as ``beam_search_batched``."""
    return _greedy(model, cfg, cross_hidden, cross_mask, max_steps,
                   stochastic, uniforms, cls_id, sep_id, cache_dtype,
                   attention, _graphs_for(model, cross_hidden.device))


@torch.no_grad()
def greedy_decode_eager(
    model: BertForMaskedLM,
    cfg: BertArchConfig,
    cross_hidden: Tensor,
    cross_mask: Tensor,
    max_steps: int = 100,
    stochastic: bool = False,
    uniforms: Optional[UniformFn] = None,
    cls_id: int = 2,
    sep_id: int = 3,
    cache_dtype: torch.dtype = torch.float32,
    attention: str = "kernel",
) -> dict:
    """``greedy_decode`` with every step's ops issued from Python, on any
    device: the reference its graphs are held to on the card."""
    return _greedy(model, cfg, cross_hidden, cross_mask, max_steps,
                   stochastic, uniforms, cls_id, sep_id, cache_dtype,
                   attention, None)


def _greedy(model, cfg, cross_hidden, cross_mask, max_steps, stochastic,
            uniforms, cls_id, sep_id, cache_dtype, attention, graphs) -> dict:
    if stochastic and uniforms is None:
        raise ValueError("stochastic greedy decoding needs uniforms")
    T = -8 * (-(max_steps + 2) // 8)
    with span("spmm.decode.cross_kv"):
        cross_kv = precompute_cross_kv(model, cfg, cross_hidden)
    return _run(
        graphs,
        lambda: _shape_key("greedy", model, cross_kv, cross_mask, cache_dtype,
                           T=T, stochastic=stochastic, attention=attention,
                           cls_id=cls_id, sep_id=sep_id),
        lambda: _GreedyDecode(model, cfg, T, cross_kv, cross_mask,
                              cache_dtype, stochastic, cls_id, sep_id,
                              attention),
        (cross_kv, cross_mask), max_steps, uniforms)


@torch.no_grad()
def latent_decode(model, cache: Tensor, first: Tensor, positions: Tensor,
                  n_answer: int, eager: bool = False) -> dict:
    """Greedy decoding of ``n_answer`` tokens a row of a latent MoE model
    over its session ``cache`` [L, B, T, latent + rope]: ``first`` [B] is
    each row's first answer token (the prefill's) and ``positions`` [B] the
    position it takes.  Each of the ``n_answer - 1`` steps runs every layer
    through kernel 3 (its plain version on the CPU), writing the rows' cache
    rows at their positions.  Returns ``answers`` [B, n_answer] and
    ``steps``.  Graphs on a CUDA tensor (``graph_cache``, one graph for
    every step), eager on the CPU or with ``eager``."""
    graphs = None if eager else _graphs_for(model, cache.device)
    weights = tuple(t.data_ptr() for t in itertools.chain(
        model.parameters(), model.buffers()))
    return _run(
        graphs,
        lambda: ("latent", id(model), weights, cache.device, cache.data_ptr(),
                 tuple(cache.shape), cache.dtype, n_answer),
        lambda: _LatentDecode(model, cache, n_answer),
        (first, positions), n_answer - 1, None)
