"""Turns of a language model over cached sessions: ``inference.lm.
answer_turn`` over a batch of rows, each with a long history prefilled once
in set-up; a batch is a fresh turn a row, answered greedily.

The configuration names what is particular to its model, and the driver
names no model itself: ``model`` the program's model, made by
``portbench/programs/<model>.py``'s ``build``; ``reference`` the path of
its reference module (the interface in ``portbench/reference/__init__.py``),
which gives the weights that both sides load, the reference that the
comparison reads and the turn's needed work.  Both are loaded by path from
the checkout that holds this driver.

Inputs from the seed: each row's history length (the ``batch`` quantiles of
the uniform distribution over [min, max] in an order drawn from the seed,
so every seed holds the same work) and ids (uniform over the vocabulary,
generator (seed, 3)); batch ``i``'s turn ids from (seed, stream, i).  One
"mol" of the rate is one answered turn.

The comparison takes ``check_rows`` of the window's rows drawn from the
seed, the one with the longest history first, and reads each through the
reference (fp32, TF32 off) teacher-forced over history + turn + the served
answer:

- ``mean_token_gap``: over every served answer position, the reference's
  best log-probability less the served token's, averaged.  Greedy decoding
  serves the argmax, so only rounding opens a gap: bf16 weights,
  activations and cache, and (in ``moonlight-16b-a3b``) the expert choices
  that they flip where two experts' scores nearly tie, which compound over
  the 26 expert layers;
- ``answer_errors``: rows of a batch with an answer of another length or an
  id outside the vocabulary.

The calibration (``check(extra=True)``) also reads ``token_gap``, the
widest of those gaps, which sets no limit: its sound readings reach past
the fp8 control's (PERF.md, section 2), and ``argmax_share``, the share of
served tokens that are the reference's argmax.

Control ``ref_fp8`` (calibration and the control test only): the reference
with every product's operands rounded to e4m3 stands for the program,
teacher-forced over the same tokens; its argmax at each position stands for
the served token.  Witness ``ref_bf16`` (calibration only), the same with
the reference in bf16 (``Reference`` precision "bf16"): what the program's
rounding alone does to the gaps, without the program's code.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

from portbench import traffic as traffic_mod
from portbench.counts import PEAK_FLOPS
from portbench.drivers._common import phase, sample

HISTORY_STREAM = 3
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load(path: str):
    """The module at ``path``, from the root of this driver's checkout."""
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(path)[0].replace("/", "."),
        os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 control=None):
        self.config, self.traffic, self.seed, self.dev = (
            config, traffic, seed, device)
        self.control = control
        self.rows, self.turn = traffic["batch"], traffic["turn"]
        self.answer = traffic["answer"]
        self.history = self.histories()
        self.reference = load(config["reference"])
        self.program = load(f"portbench/programs/{config['model']}.py")

    def histories(self) -> list:
        """Each row's history ids (host arrays)."""
        lo, hi = self.traffic["history"]["min"], self.traffic["history"]["max"]
        n = self.rows
        lengths = [round(lo + j * (hi - lo) / max(n - 1, 1)) for j in range(n)]
        g = np.random.default_rng([self.seed, HISTORY_STREAM])
        lengths = [lengths[j] for j in g.permutation(n)]
        return [g.integers(0, self.config["vocab_size"], size=length)
                for length in lengths]

    def setup(self) -> None:
        from spmm_tpu_torch.inference import lm

        cfg, ref = self.config, self.reference
        with phase("model and weights", self.dev):
            with torch.device(self.dev):
                self.model = self.program.build(cfg)
            kinds = ref.tensor_kinds(cfg)
            self.model.load_checkpoint(lambda name, shape: ref.make_tensor(
                cfg, self.seed, name, shape, kinds[name], self.dev))
            self.model.eval()
        with phase("session cache and histories", self.dev):
            self.session = lm.SessionCache(self.model, self.rows,
                                           self.traffic["positions"], self.dev)
            flat = torch.as_tensor(np.concatenate(self.history),
                                   device=self.dev)
            lm.prefill_history(self.model, self.session, list(flat.split(
                [len(h) for h in self.history])))
        with phase("warm-up batch", self.dev):
            self.run(self.inputs(traffic_mod.WARM_UP, 0)[1])

    def inputs(self, stream: int, i: int):
        g = traffic_mod.rng(self.seed, stream, i)
        turn = g.integers(0, self.config["vocab_size"],
                          size=(self.rows, self.turn))
        return {"turn": turn}, torch.as_tensor(turn, device=self.dev)

    def run(self, x) -> dict:
        from spmm_tpu_torch.inference import lm

        return lm.answer_turn(self.model, self.session, x, self.answer)

    def units(self, res: dict) -> int:
        return int(res["answers"].shape[0])

    def free(self) -> None:
        from spmm_tpu_torch.inference.decoding import graph_cache

        graph_cache.clear()
        self.model = self.session = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def work(self, host: dict, res: dict) -> dict:
        lengths = [len(h) for h in self.history]
        return {**self.reference.work(self.config, lengths, self.rows,
                                      self.turn, self.answer),
                "peak_flops": PEAK_FLOPS["bf16"], "steps": res["steps"]}

    # ---- the comparison ----

    def answer_errors(self, res: dict) -> int:
        ans = res["answers"]
        bad = (ans < 0) | (ans >= self.config["vocab_size"])
        if ans.shape[1] != self.answer or res["steps"] != self.answer - 1:
            return int(ans.shape[0])
        return int(bad.any(1).sum())

    def check(self, batches: list, extra: bool = False) -> list:
        """[(name, value, limit)] of the comparison; with ``extra`` the
        calibration's further readings too, with no limit."""
        limits = self.traffic["limits"]
        rows = [(i, res, r) for i, res in batches for r in range(self.rows)]
        picked = sample(rows, lambda row: len(self.history[row[2]]),
                        self.seed, self.traffic["check_rows"])
        seqs, wanted, served = [], [], []
        for i, res, r in picked:
            turn = self.inputs(traffic_mod.WINDOW, i)[0]["turn"][r]
            ans = res["answers"][r]
            seqs.append(torch.as_tensor(np.concatenate(
                [self.history[r], turn, ans[:-1]])))
            start = len(self.history[r]) + self.turn - 1
            wanted.append(torch.arange(start, start + self.answer))
            served.append(torch.as_tensor(ans, device=self.dev))
        make = self.reference.Reference
        ref = make(self.config, self.seed, self.dev)
        with phase("reference", self.dev):
            logps = [torch.log_softmax(lg, -1)
                     for lg in ref.logits(seqs, wanted)]
        if self.control in ("ref_fp8", "ref_bf16"):
            low = make(self.config, self.seed, self.dev,
                       precision=self.control[4:])
            served = [lg.argmax(-1) for lg in low.logits(seqs, wanted)]
        gaps = torch.cat([lp.max(-1).values - lp.gather(-1, s[:, None])[:, 0]
                          for lp, s in zip(logps, served)])
        out = [("mean_token_gap", float(gaps.mean()),
                limits["mean_token_gap"]),
               ("answer_errors", sum(self.answer_errors(res)
                                     for _, res in batches), 0)]
        if extra:
            agree = torch.cat([lp.argmax(-1) == s
                               for lp, s in zip(logps, served)])
            out += [("served_tokens", int(gaps.numel()), None),
                    ("token_gap", float(gaps.max()), None),
                    ("argmax_share", float(agree.float().mean()), None)]
        return out
