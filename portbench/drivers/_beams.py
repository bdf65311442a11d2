"""What the k-beam drivers share: the search's settings, the host result,
and the comparison of served beams with the plain reference.

The comparison takes a sample of the window's molecules drawn from the seed,
the one with the longest served beam among them, and the reference's own
encoding of the same inputs (fp32, TF32 off).  It reads:

- ``token_gap``: every served beam read teacher-forced through the
  reference's decoder; the widest gap, in nats, by which a served token's
  reference log-probability lies below the reference's k-th best at that
  position.  A k-beam search takes each token from the top k of its beam's
  distribution, so only rounding puts a served token below the k-th best;
- ``mean_token_gap``: the same gaps (0 where the served token lies in the
  reference's top k) averaged over every served position: rounding that
  moves many tokens a little, as a lower precision does, shows here where
  the widest gap alone would not;
- ``score_gap``: the widest gap between a served beam's log-probability
  and the reference's sum over its tokens, over the reference's sum: a
  search that drops or mixes up the beams' summed scores reads near 1;
- ``beam_errors``: served beams that break the search's rules: a first
  token other than [CLS], a length outside [2, steps + 1], a live beam
  (none harvested) shorter than steps + 1, a harvested beam not ending in
  [SEP], a log-probability not finite or out of descending order;
- ``string_errors``: served strings that differ from the reference's
  detokenization of the served ids.

The calibration (``check(extra=True)``) also runs the reference's own
k-beam search over the sampled molecules and reads where the served beams
first leave it (``search_gap``, ``first_step_median``); no limit is set on
those (PERF.md, section 2).
"""

from __future__ import annotations

import random

import numpy as np
import torch

from portbench import traffic as traffic_mod
from portbench import weights
from portbench.drivers._common import on_device, phase, sample
from portbench.reference import Reference, detokenize, load_vocab

CHECK_BLOCK = 64        # sequences (or molecules) a reference call takes


class BeamDriver:
    """A k-beam entry point; subclasses make the model, encode the inputs
    and name the reference's encoder.

    ``control``: ``kv_fp8`` runs the program with its e4m3 KV cache;
    ``ref_fp8`` puts the reference in fp8 (every product's operands rounded
    to e4m3) in the program's place in the comparison: at each served
    position, read teacher-forced over the same inputs and tokens, the
    tokens it would serve (its top k) stand for the program's."""

    decoder_key = "text"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 control=None):
        self.config, self.traffic, self.seed, self.dev = (
            config, traffic, seed, device)
        self.control = control
        self.k, self.max_steps = traffic["k"], traffic["max_steps"]
        stop = traffic["stop_count"]
        self.stop_count = (self.k * self.k * self.max_steps
                           if stop == "unreachable" else int(stop))
        self.cache = ("fp8" if control == "kv_fp8"
                      else traffic["decoder_dtype"])
        self.dec_arch = config[self.decoder_key]
        self.py_rng = random.Random(seed)

    def spec(self):
        from spmm_tpu_torch.inference.decoding import BeamSpec

        return BeamSpec(k=self.k, stop_count=self.stop_count,
                        max_steps=self.max_steps,
                        attention=self.traffic["attention"],
                        cls_id=self.config["cls_token_id"],
                        sep_id=self.config["sep_token_id"],
                        vocab_size=self.dec_arch["vocab_size"])

    def setup(self) -> None:
        from spmm_tpu_torch.inference.pv2smiles import decoder_for
        from spmm_tpu_torch.tokenizer import SmilesTokenizer

        with phase("model and weights", self.dev):
            self.model = on_device(self.model_class(), self.config,
                                   self.seed, self.dev, *self.archs())
        with phase("decoder copy", self.dev):
            self.decoder = decoder_for(
                self.model, bf16=self.traffic["decoder_dtype"] == "bf16")
        self.tok = SmilesTokenizer()
        with phase("warm-up batch", self.dev):
            self.run(self.inputs(traffic_mod.WARM_UP, 0)[1])

    def search(self, ref: Reference, cross, cross_mask, trail=False) -> dict:
        return ref.beam_search(cross, cross_mask, self.k, self.max_steps,
                               self.stop_count, self.config["cls_token_id"],
                               self.config["sep_token_id"], trail)

    def run(self, x) -> dict:
        from spmm_tpu_torch.inference.pv2smiles import to_host

        res = to_host(self.decode(x))
        res["strings"] = self.strings(res)
        return res

    def units(self, res: dict) -> int:
        return int(res["seqs"].shape[0])

    def free(self) -> None:
        from spmm_tpu_torch.inference.decoding import graph_cache

        graph_cache.clear()
        self.model = self.decoder = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def n_avail(self, res: dict, r: int) -> int:
        n_fin = int(res["n_finished"][r])
        return self.k if n_fin == 0 else min(self.k, n_fin)

    # ---- the comparison ----

    def beam_errors(self, res: dict, r: int) -> int:
        cls_id = self.config["cls_token_id"]
        sep_id = self.config["sep_token_id"]
        steps, n_fin = res["steps"], int(res["n_finished"][r])
        errors = 0
        logp = res["logp"][r][: self.n_avail(res, r)]
        if not np.isfinite(logp).all() or (np.diff(logp) > 0).any():
            errors += 1
        for j in range(self.n_avail(res, r)):
            length, seq = int(res["lengths"][r, j]), res["seqs"][r, j]
            bad = (seq[0] != cls_id or not 2 <= length <= steps + 1
                   or (n_fin == 0 and length != steps + 1)
                   or (n_fin > 0 and seq[length - 1] != sep_id))
            errors += int(bad)
        return errors

    def check(self, batches: list, extra: bool = False) -> list:
        """[(name, value, limit)] of the comparison; with ``extra`` the
        calibration's further readings too, with no limit."""
        limits = self.traffic["limits"]
        rows = [(i, res, r) for i, res in batches
                for r in range(res["seqs"].shape[0])]
        picked = sample(rows, lambda row: int(row[1]["lengths"][row[2]].max()),
                        self.seed, self.traffic["check_rows"])
        hosts = {i: traffic_mod.make_batch(self.traffic, self.seed,
                                           traffic_mod.WINDOW, i)
                 for i in sorted({i for i, _, _ in picked})}
        vocab = load_vocab(self.config["vocab_file"])
        inv = {v: t for t, v in vocab.items()}
        ref = Reference(self.config, weights.make(self.config, self.seed,
                                                  self.dev))
        beams, owners = [], []       # (ids, served logp, harvested)
        beam_errors = string_errors = 0
        for n, (i, res, r) in enumerate(picked):
            beam_errors += self.beam_errors(res, r)
            for j, s in enumerate(res["strings"][r]):
                ids = res["seqs"][r, j, :max(int(res["lengths"][r, j]) - 1, 1)]
                string_errors += int(detokenize(ids, inv) != s)
            for j in range(self.n_avail(res, r)):
                length = int(res["lengths"][r, j])
                beams.append((res["seqs"][r, j, :length],
                              float(res["logp"][r, j]),
                              int(res["n_finished"][r]) > 0))
                owners.append(n)
        read = Readings()
        ref8 = (Reference(self.config, ref.w, "fp8")
                if self.control == "ref_fp8" else None)
        for start in range(0, len(beams), CHECK_BLOCK):
            block = range(start, min(start + CHECK_BLOCK, len(beams)))
            owned = [picked[owners[s]] for s in block]
            control = (None if ref8 is None
                       else (ref8, *self.ref_encode(ref8, owned, hosts)))
            self.teacher_forced(ref, [beams[s] for s in block],
                                *self.ref_encode(ref, owned, hosts), read,
                                extra, control)
        if extra:
            for start in range(0, len(picked), CHECK_BLOCK):
                block = range(start, min(start + CHECK_BLOCK, len(picked)))
                found = self.search(ref, *self.ref_encode(
                    ref, [picked[n] for n in block], hosts), trail=True)
                trail = [tuple(t.cpu().numpy() for t in step)
                         for step in found["trail"]]
                done_at = found["done_at"].cpu().numpy()
                del found
                for r, n in enumerate(block):
                    read.diverge(*divergence(
                        [b for b, o in zip(beams, owners) if o == n], trail,
                        r, int(done_at[r])))
        out = [("token_gap", read.token_gap, limits["token_gap"]),
               ("mean_token_gap", read.gap_sum / max(read.positions, 1),
                limits["mean_token_gap"]),
               ("score_gap", read.score_gap, limits["score_gap"]),
               ("beam_errors", beam_errors, 0),
               ("string_errors", string_errors, 0)]
        if extra:
            out += [(name, value, None)
                    for name, value in sorted(read.extra.items())]
        return out

    def teacher_forced(self, ref, block: list, cross, cross_mask,
                       read: "Readings", extra: bool, control=None) -> None:
        """The readings of one block of served beams, each read through the
        reference's decoder over its own tokens.  With ``control`` (the
        reference in fp8 and its encoding), the tokens in its top k at
        each position are read in place of the served ones."""
        width = max(len(ids) for ids, _, _ in block)
        tokens = torch.zeros((len(block), width), dtype=torch.long)
        valid = torch.zeros((len(block), width - 1), dtype=torch.bool)
        for row, (ids, _, _) in enumerate(block):
            tokens[row, :len(ids)] = torch.as_tensor(ids)
            valid[row, :len(ids) - 1] = True
        tokens, valid = tokens.to(self.dev), valid.to(self.dev)
        logits = ref.decoder_logits(tokens, cross, cross_mask)[:, :-1]
        lp = torch.log_softmax(logits, -1)
        got = lp.gather(-1, tokens[:, 1:, None])[..., 0]
        kth = lp.topk(self.k, dim=-1).values[..., -1:]
        if control is None:
            gap = (kth[..., 0] - got)[valid]
        else:
            ref8, cross8, mask8 = control
            chosen = ref8.decoder_logits(tokens, cross8, mask8)[:, :-1].topk(
                self.k, dim=-1).indices
            gap = (kth - lp.gather(-1, chosen)).amax(-1)[valid]
        total = torch.where(valid, got, 0.0).sum(1)
        served = torch.as_tensor([s for _, s, _ in block], device=self.dev)
        read.token_gap = max(read.token_gap, float(gap.max()))
        read.gap_sum += float(gap.clamp_min(0).sum())
        read.positions += int(gap.numel())
        read.score_gap = max(read.score_gap, float(
            ((served - total).abs() / total.abs().clamp_min(1e-6)).max()))
        if extra:
            read.score_bf16 = max(read.score_bf16, bf16_score_gap(
                logits, tokens, valid, served))


class Readings:
    """The readings so far: the widest gaps, the sum of the token gaps,
    and the calibration's further readings."""

    def __init__(self):
        self.token_gap = self.search_gap = self.score_gap = 0.0
        self.gap_sum, self.positions = 0.0, 0
        self.score_bf16, self.molecules, self.first_steps = 0.0, 0, []

    def diverge(self, step, gap: float) -> None:
        self.search_gap = max(self.search_gap, gap)
        self.molecules += 1
        if step is not None:
            self.first_steps.append(step)

    @property
    def extra(self) -> dict:
        return {"served_tokens": self.positions,
                "score_gap_bf16": self.score_bf16,
                "search_gap": self.search_gap,
                "diverged_share": (len(self.first_steps)
                                   / max(self.molecules, 1)),
                "first_step_median": (float(np.median(self.first_steps))
                                      if self.first_steps else None)}


def divergence(served: list, trail: list, r: int, done_at: int) -> tuple:
    """(the first step at which a served beam of molecule ``r`` leaves the
    reference's live beams, or None; the widest gap there of the
    reference's k-th kept score over its score of the served prefix).

    ``trail[t]``: the reference's live seqs and scores after step t, step
    t's log-probabilities [m, k, V] (by the live beams after step t - 1)
    and its k-th kept score.  A served beam harvested with its [SEP] at
    index L - 1 was live up to step L - 3; a live one to the last step."""
    for t in range(min(len(trail), done_at + 1)):
        live = trail[t][0][r][:, :t + 2]
        gap, parted = 0.0, False
        for ids, _, harvested in served:
            last = len(ids) - 3 if harvested else len(trail) - 1
            if t > last or (live == ids[:t + 2]).all(1).any():
                continue
            parted, tok = True, int(ids[t + 1])
            if t == 0:
                score = trail[0][2][r, 0, tok]
            else:
                prev = np.nonzero((trail[t - 1][0][r][:, :t + 1]
                                   == ids[:t + 1]).all(1))[0]
                if not len(prev):
                    return t, float("inf")
                b = int(prev[0])
                score = trail[t - 1][1][r, b] + trail[t][2][r, b, tok]
            gap = max(gap, float(trail[t][3][r] - score))
        if parted:
            return t, gap
    return None, 0.0


def bf16_score_gap(logits, tokens, valid, served) -> float:
    """Calibration only: the widest relative gap of a served
    log-probability from the running sum that a bf16 decoder's search
    keeps, worked out from the reference's logits: rounded to bf16, taken
    through a bf16 log-softmax, each step's sum rounded to bf16."""
    x = logits.to(torch.bfloat16)
    shifted = x - x.amax(-1, keepdim=True)
    total = torch.exp(shifted).float().sum(-1, keepdim=True)
    lp = shifted - torch.log(total.to(torch.bfloat16))
    got = lp.gather(-1, tokens[:, 1:, None])[..., 0]
    run = got[:, 0].clone()
    for t in range(1, got.shape[1]):
        run = torch.where(valid[:, t], run + got[:, t], run)
    run = run.float()
    return float(((served - run).abs() / run.abs().clamp_min(1e-6)).max())
