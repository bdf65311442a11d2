"""SPMM's networks in plain PyTorch (see the package's docstring).

Semantics, after the SPMM repository's xbert.py and d_*.py scripts:

- embeddings: word (or given) embeddings + position + token type 0, then
  LayerNorm (eps from the configuration);
- a layer: self-attention, in fusion layers cross-attention, then the
  erf-GELU feed-forward, each with its residual and LayerNorm; masked keys
  get -10000 before the softmax;
- the LM head: dense, GELU, LayerNorm, then the word table (tied) and bias;
- a decoder read teacher-forced: position t attends the earlier positions
  whose token is not [PAD] (id 0) and itself;
- PV -> SMILES encodes [CLS] + the 53 embedded properties bidirectionally
  and decodes cross-attending to them; reaction prediction encodes the
  source with the 6-layer SMILES encoder and decodes cross-attending to it;
- SMILES -> PV: the text section over the SMILES, then for each property i
  the property encoder over the i + 1 slots written so far
  (bidirectionally), the fusion layers over them (causally, cross-attending
  to the SMILES), the MTR head at slot i, and its prediction embedded into
  slot i + 1.
"""

from __future__ import annotations

import json
import math
from typing import Optional

import torch
import torch.nn.functional as F

MASK_VALUE = -10000.0
FP8_MAX = 448.0


def load_vocab(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def detokenize(ids, inv_vocab: dict) -> str:
    """Wordpiece ids -> SMILES: the pieces joined, "##" continuations
    merged, [PAD], [CLS] and [SEP] dropped."""
    s = " ".join(inv_vocab[int(i)] for i in ids).replace(" ##", "").strip()
    for special in ("[PAD]", "[CLS]", "[SEP]"):
        s = s.replace(special, "")
    return s.strip()


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    """The networks of one configuration over ``weights`` (name -> fp32
    tensor), in ``precision`` "fp32" or "fp8".  Making one turns TF32 off
    for the process: the reference runs after the program's window."""

    def __init__(self, config: dict, weights: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.config, self.w, self.precision = config, weights, precision
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # ---- pieces ----

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            a, b = _fp8(a), _fp8(b)
        return torch.matmul(a, b)

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        y = self.mm(x, self.w[f"{name}.weight"].t())
        bias = self.w.get(f"{name}.bias")
        return y if bias is None else y + bias

    def norm(self, x: torch.Tensor, name: str, eps: float) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"],
                            self.w[f"{name}.bias"], eps)

    def embed(self, prefix: str, arch: dict, ids=None, embeds=None,
              start: int = 0) -> torch.Tensor:
        e = f"{prefix}embeddings."
        x = embeds if embeds is not None else \
            self.w[f"{e}word_embeddings.weight"][ids]
        n = x.shape[1]
        pos = torch.arange(start, start + n, device=x.device).clamp_max(
            arch["max_position_embeddings"] - 1)
        x = (x + self.w[f"{e}position_embeddings.weight"][pos]
             + self.w[f"{e}token_type_embeddings.weight"][0])
        return self.norm(x, f"{e}LayerNorm", arch["layer_norm_eps"])

    def attend(self, name: str, arch: dict, x: torch.Tensor,
               kv: torch.Tensor, mask: Optional[torch.Tensor]
               ) -> torch.Tensor:
        h = arch["num_attention_heads"]
        b, lq, width = x.shape
        d = width // h

        def heads(t):
            return t.reshape(b, t.shape[1], h, d).transpose(1, 2)

        q = heads(self.linear(x, f"{name}.self.query"))
        k = heads(self.linear(kv, f"{name}.self.key"))
        v = heads(self.linear(kv, f"{name}.self.value"))
        return self.attend_out(name, arch, x, self.softmax_ctx(q, k, v, mask))

    def softmax_ctx(self, q, k, v, mask) -> torch.Tensor:
        """softmax(q k^T / sqrt(d) + mask) v over [B, h, L, d] heads."""
        scores = self.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        if mask is not None:
            scores = scores + mask
        return self.mm(torch.softmax(scores, dim=-1), v)

    def attend_out(self, name: str, arch: dict, x: torch.Tensor,
                   ctx: torch.Tensor) -> torch.Tensor:
        b, lq, width = x.shape
        out = self.linear(ctx.transpose(1, 2).reshape(b, lq, width),
                          f"{name}.output.dense")
        return self.norm(out + x, f"{name}.output.LayerNorm",
                         arch["layer_norm_eps"])

    def stack(self, prefix: str, arch: dict, x: torch.Tensor,
              mask: Optional[torch.Tensor], layers: range,
              cross: Optional[torch.Tensor] = None,
              cross_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        eps = arch["layer_norm_eps"]
        for i in layers:
            layer = f"{prefix}encoder.layer.{i}."
            x = self.attend(f"{layer}attention", arch, x, x, mask)
            if arch["add_cross_attention"] and i >= arch["fusion_layer"]:
                x = self.attend(f"{layer}crossattention", arch, x, cross,
                                cross_mask)
            up = F.gelu(self.linear(x, f"{layer}intermediate.dense"))
            x = self.norm(self.linear(up, f"{layer}output.dense") + x,
                          f"{layer}output.LayerNorm", eps)
        return x

    def lm_head(self, prefix: str, arch: dict, x: torch.Tensor
                ) -> torch.Tensor:
        p = f"{prefix}cls.predictions."
        x = F.gelu(self.linear(x, f"{p}transform.dense"))
        x = self.norm(x, f"{p}transform.LayerNorm", arch["layer_norm_eps"])
        word = self.w[f"{prefix}bert.embeddings.word_embeddings.weight"]
        return self.mm(x, word.t()) + self.w[f"{p}bias"]

    # ---- masks ----

    @staticmethod
    def padding_mask(mask: torch.Tensor) -> torch.Tensor:
        """Binary [B, L] -> additive [B, 1, 1, L]."""
        return ((1.0 - mask.float()) * MASK_VALUE)[:, None, None, :]

    @staticmethod
    def causal_mask(n: int, device) -> torch.Tensor:
        t = torch.arange(n, device=device)
        return ((1.0 - (t[None, :] <= t[:, None]).float())
                * MASK_VALUE)[None, None]

    @staticmethod
    def decoder_mask(tokens: torch.Tensor) -> torch.Tensor:
        """[B, L] -> additive [B, 1, L, L]: the non-[PAD] tokens up to and
        including the position (causal, keys masked by [PAD] as BERT's
        attention mask does)."""
        n = tokens.shape[1]
        t = torch.arange(n, device=tokens.device)
        keep = (t[None, :] <= t[:, None])[None] & (tokens != 0)[:, None, :]
        return ((1.0 - keep.float()) * MASK_VALUE)[:, None]

    # ---- the configurations' networks ----

    def encode_pv(self, pv: torch.Tensor) -> torch.Tensor:
        """Normalised PVs [B, 53] -> property hiddens [B, 54, H]."""
        arch = self.config["property"]
        feat = self.linear(pv[..., None], "property_embed")
        cls = self.w["property_cls"].expand(pv.shape[0], 1, feat.shape[-1])
        x = self.embed("property_encoder.", arch,
                       embeds=torch.cat([cls, feat], dim=1))
        return self.stack("property_encoder.", arch, x, None,
                          range(arch["num_hidden_layers"]))

    def encode_source(self, ids: torch.Tensor, mask: torch.Tensor
                      ) -> torch.Tensor:
        """Reaction sources [B, L] -> the SMILES encoder's hiddens."""
        arch = self.config["encoder"]
        x = self.embed("text_encoder2.bert.", arch, ids=ids)
        return self.stack("text_encoder2.bert.", arch, x,
                          self.padding_mask(mask),
                          range(arch["num_hidden_layers"]))

    def decoder_arch(self) -> dict:
        return self.config.get("decoder") or self.config["text"]

    def decoder_logits(self, tokens: torch.Tensor, cross: torch.Tensor,
                       cross_mask: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits [B, L, V] of the token after each position
        of ``tokens`` [B, L]."""
        arch = self.decoder_arch()
        x = self.embed("text_encoder.bert.", arch, ids=tokens)
        x = self.stack("text_encoder.bert.", arch, x,
                       self.decoder_mask(tokens),
                       range(arch["num_hidden_layers"]), cross,
                       self.padding_mask(cross_mask))
        return self.lm_head("text_encoder.", arch, x)

    def decoder_logprobs(self, tokens: torch.Tensor, cross: torch.Tensor,
                         cross_mask: torch.Tensor) -> torch.Tensor:
        """Teacher-forced log-probabilities [B, L, V] of the token after
        each position of ``tokens`` [B, L]."""
        return torch.log_softmax(
            self.decoder_logits(tokens, cross, cross_mask), -1)

    def smiles2pv(self, ids: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
        """SMILES tokens [B, L] (the leading [CLS] dropped) -> normalised
        property predictions [B, 53]."""
        text, prop = self.config["text"], self.config["property"]
        eps = text["layer_norm_eps"]
        x = self.embed("text_encoder.bert.", text, ids=ids)
        cross = self.stack("text_encoder.bert.", text, x,
                           self.padding_mask(mask),
                           range(text["fusion_layer"]))
        cross_mask = self.padding_mask(mask)
        slots = [self.w["property_cls"][0].expand(ids.shape[0], -1)]
        preds = []
        for i in range(self.config["n_properties"]):
            n = i + 1
            p = self.embed("property_encoder.", prop,
                           embeds=torch.stack(slots, dim=1))
            p = self.stack("property_encoder.", prop, p, None,
                           range(prop["num_hidden_layers"]))
            f = self.stack("text_encoder.bert.", text, p,
                           self.causal_mask(n, ids.device),
                           range(text["fusion_layer"],
                                 text["num_hidden_layers"]),
                           cross, cross_mask)
            y = F.gelu(self.linear(f[:, i], "property_mtr_head.0"))
            y = self.norm(y, "property_mtr_head.2", eps)
            pred = self.linear(y, "property_mtr_head.3")[:, 0]
            slots.append(self.linear(pred[:, None], "property_embed"))
            preds.append(pred)
        return torch.stack(preds, dim=1)

    # ---- k-beam search ----

    @staticmethod
    def split_heads(t: torch.Tensor, h: int) -> torch.Tensor:
        b, n, width = t.shape
        return t.reshape(b, n, h, width // h).transpose(1, 2)

    def decode_start(self, cross: torch.Tensor, cross_mask: torch.Tensor,
                     rows_each: int) -> dict:
        """An incremental decode of ``rows_each`` rows a cross sequence:
        the cross keys and values of each fusion layer, and per layer the
        self-attention keys and values written so far (none)."""
        arch = self.decoder_arch()
        h = arch["num_attention_heads"]
        cross = cross.repeat_interleave(rows_each, 0)
        state = {"cross": {}, "self": {}, "valid": None,
                 "cross_mask": self.padding_mask(
                     cross_mask.repeat_interleave(rows_each, 0))}
        for i in self.cross_layers(arch):
            name = f"text_encoder.bert.encoder.layer.{i}.crossattention.self"
            state["cross"][i] = tuple(
                self.split_heads(self.linear(cross, f"{name}.{part}"), h)
                for part in ("key", "value"))
        return state

    @staticmethod
    def cross_layers(arch: dict) -> range:
        if not arch["add_cross_attention"]:
            return range(0)
        return range(arch["fusion_layer"], arch["num_hidden_layers"])

    def decode_token(self, state: dict, token: torch.Tensor, pos: int
                     ) -> torch.Tensor:
        """Each row's token at position ``pos`` -> log-probabilities [N, V]
        of the next token; its keys and values join ``state``."""
        arch = self.decoder_arch()
        h, eps = arch["num_attention_heads"], arch["layer_norm_eps"]
        valid = (token != 0)[:, None]
        state["valid"] = (valid if state["valid"] is None
                          else torch.cat([state["valid"], valid], 1))
        mask = ((1.0 - state["valid"].float()) * MASK_VALUE)[:, None, None]
        x = self.embed("text_encoder.bert.", arch, ids=token[:, None],
                       start=pos)
        for i in range(arch["num_hidden_layers"]):
            layer = f"text_encoder.bert.encoder.layer.{i}."
            name = f"{layer}attention"
            q, k, v = (self.split_heads(
                self.linear(x, f"{name}.self.{part}"), h)
                for part in ("query", "key", "value"))
            if i in state["self"]:
                k = torch.cat([state["self"][i][0], k], 2)
                v = torch.cat([state["self"][i][1], v], 2)
            state["self"][i] = (k, v)
            x = self.attend_out(name, arch, x, self.softmax_ctx(q, k, v, mask))
            if i in state["cross"]:
                name = f"{layer}crossattention"
                q = self.split_heads(self.linear(x, f"{name}.self.query"), h)
                x = self.attend_out(name, arch, x, self.softmax_ctx(
                    q, *state["cross"][i], state["cross_mask"]))
            up = F.gelu(self.linear(x, f"{layer}intermediate.dense"))
            x = self.norm(self.linear(up, f"{layer}output.dense") + x,
                          f"{layer}output.LayerNorm", eps)
        return torch.log_softmax(
            self.lm_head("text_encoder.", arch, x)[:, 0], -1)

    @staticmethod
    def decode_reorder(state: dict, rows: torch.Tensor) -> None:
        """Row n of the decode takes the history of row ``rows[n]``."""
        state["self"] = {i: (k[rows], v[rows])
                         for i, (k, v) in state["self"].items()}
        state["valid"] = state["valid"][rows]

    def beam_search(self, cross: torch.Tensor, cross_mask: torch.Tensor,
                    k: int, max_steps: int, stop_count: int, cls_id: int,
                    sep_id: int, trail: bool = False) -> dict:
        """SPMM's deterministic k-beam search (d_pv2smiles_single.py):
        step 0 seeds k beams from the [CLS] distribution; each later step
        takes every beam's k best next tokens, scored by the beam's summed
        log-probability, harvests the candidates ending in [SEP] into a
        running best k (earlier harvests first among equals), suppresses
        them, and keeps the best k of the rest; a molecule stops once
        ``stop_count`` candidates were harvested, the search once all have
        or after ``max_steps`` + 1 steps.  Result: seqs [m, k, max_steps
        + 2], logp, lengths (with the [SEP]) and n_finished; the live
        beams where nothing was harvested.  Ties keep the first.  With
        ``trail``, also each step's live seqs and scores after it, its
        log-probabilities [m, k, V] and the k-th kept score (``trail``)
        and each molecule's stopping step (``done_at``)."""
        m, dev = cross.shape[0], cross.device
        width = max_steps + 2
        seqs = torch.zeros((m, k, width), dtype=torch.long, device=dev)
        seqs[:, :, 0] = cls_id
        logp = torch.zeros((m, k), device=dev)
        fin_seqs = torch.zeros_like(seqs)
        fin_logp = torch.full((m, k), float("-inf"), device=dev)
        fin_len = torch.zeros((m, k), dtype=torch.long, device=dev)
        fin_cnt = torch.zeros((m,), dtype=torch.long, device=dev)
        done = torch.zeros((m,), dtype=torch.bool, device=dev)
        done_at = torch.full((m,), max_steps + 1, dtype=torch.long,
                             device=dev)
        base = (torch.arange(m, device=dev) * k)[:, None]
        state = self.decode_start(cross, cross_mask, k)
        steps, kept = 0, []

        def top(x, n):
            vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
            return vals[..., :n], idx[..., :n]

        for pos in range(max_steps + 1):
            lp = self.decode_token(state, seqs[:, :, pos].reshape(m * k),
                                   pos).reshape(m, k, -1)
            if pos == 0:
                logp, seqs[:, :, 1] = top(lp[:, 0], k)
                kth = logp[:, -1].clone()
            else:
                vals, idx = top(lp, k)
                cand = logp[:, :, None] + vals                  # [m, k, k]
                cand_seqs = seqs[:, :, None].expand(
                    m, k, k, width).reshape(m, k * k, width).clone()
                cand_seqs[:, :, pos + 1] = idx.reshape(m, k * k)
                ended = (idx == sep_id).reshape(m, k * k)
                flat = cand.reshape(m, k * k)
                new_fin_logp, pick = top(torch.cat(
                    [fin_logp, torch.where(ended, flat, float("-inf"))], 1),
                    k)
                new_fin_seqs = torch.cat([fin_seqs, cand_seqs], 1).gather(
                    1, pick[:, :, None].expand(m, k, width))
                new_fin_len = torch.cat(
                    [fin_len, torch.full_like(flat, pos + 2,
                                              dtype=torch.long)], 1
                ).gather(1, pick)
                new_logp, choice = top(torch.where(ended, -1e5, flat), k)
                kth = new_logp[:, -1].clone()
                parent = torch.where(done[:, None], torch.arange(
                    k, device=dev)[None], choice // k)
                new_seqs = cand_seqs.gather(
                    1, choice[:, :, None].expand(m, k, width))
                keep = done[:, None]
                seqs = torch.where(keep[:, :, None], seqs, new_seqs)
                logp = torch.where(keep, logp, new_logp)
                fin_seqs = torch.where(keep[:, :, None], fin_seqs,
                                       new_fin_seqs)
                fin_logp = torch.where(keep, fin_logp, new_fin_logp)
                fin_len = torch.where(keep, fin_len, new_fin_len)
                fin_cnt = torch.where(done, fin_cnt,
                                      fin_cnt + ended.sum(1))
                self.decode_reorder(state, (base + parent).reshape(-1))
                stops = ~done & (fin_cnt >= stop_count)
                done_at = torch.where(stops, pos, done_at)
                done = done | stops
            if trail:
                kept.append((seqs.clone(), logp.clone(), lp, kth))
            steps = pos + 1
            if bool(done.all()):
                break
        no_fin = (fin_cnt == 0)[:, None]
        out = {"seqs": torch.where(no_fin[:, :, None], seqs, fin_seqs),
               "logp": torch.where(no_fin, logp, fin_logp),
               "lengths": torch.where(no_fin, steps + 1, fin_len),
               "n_finished": fin_cnt, "steps": steps}
        if trail:
            out.update(trail=kept, done_at=done_at)
        return out
