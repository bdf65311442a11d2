"""The port's bench: every workload of the JAX system's ``bench.py`` on one
NVIDIA GPU, one JSON line per measurement under the JAX bench's metric name
and unit.

    python -m spmm_tpu_torch.bench [--attention kernel|plain]
        [--only WORKLOAD] [--device DEVICE] [--seed 0] [--budget_s 1500]

Counterpart of the root ``bench.py`` and of ``scripts/bench_decode.py``,
``scripts/bench_smiles2pv.py`` and ``scripts/bench_rxn.py``; it imports
none of them.  Full width, random weights from the seed, and the JAX
bench's batches, lengths and counts.  The workloads, in order:

  decode      pv2smiles_beam_k2_throughput (60 steps, bench.py:82) and
              pv2smiles_beam_k2_throughput_100step (100 steps, :85): k=2
              deterministic beam search with an unreachable stop_count
              (k*k*steps) through the bf16 decoder, as JAX's
              ``_beam_batch(bf16=True)`` runs it (``inference.pv2smiles.
              _beam_batch``, kernel 1); 1,024 molecules in batches of 512,
              or 256, or 128: a smaller batch only after an out-of-memory
              error (:71, :81, :89);
  pipeline    host_pipeline_samples_per_sec: ``data.pipeline.
              batch_pretrain`` under ``prefetch`` with the native tokenizer
              (built, or loaded, before the clock starts) over the JAX
              bench's 50,000-line corpus (the example SMILES with random
              fragments, :240-287), batch 96; no device;
  smiles2pv   smiles2pv_mol_per_sec: fp32 ``predict_pv`` (kernel 2) of 5
              batches of 128 (64 after an out-of-memory error) random
              SMILES tokens in [4, 300), length 48, mask of ones (:290-330);
  rxn_greedy  rxn_greedy_mol_per_sec: bf16 greedy decode (``inference.rxn.
              _greedy_batch``, both kernels) of 3 batches of 128 (64)
              random sources of 96 tokens, [CLS] first, 100 steps
              (:333-376);
  rxn_beam    rxn_beam_k5_mol_per_sec: bf16 k=5 beam search (stop_count
              25, as the CLI) of 3 batches of 32 such sources
              (scripts/bench_rxn.py), both kernels;
  pretrain    pretrain_samples_per_sec_chip at the JAX bench's settings
              (``bf16_compute``, remat, bf16 Adam moments; batches of 100
              random tokens with [CLS] first, properties ~ N(0, 1)): batch
              96 (the reference's per-GPU batch), 64 (the JAX rung, :97),
              and 96 in fp32; then pretrain_mfu, the highest MFU of those.

Each line carries ``metric``, ``value``, ``unit``, ``vs_baseline`` and the
shape fields of the JAX line (``batch``, ``seq_len``, ``src_len``,
``max_steps``, ``accum``); ``attention`` on the decode, SMILES->PV and
reaction lines; ``median_batch_ms``, ``batch_ms`` (per timed batch, per
window for pretraining) and ``n_samples``; ``card`` (the name and power
limit nvidia-smi reads), ``torch``, ``cuda`` and ``device`` (the run's:
a ``--device cpu`` run says "cpu" on every line); and ``correct``.

``value`` is computed as the JAX bench computes it: molecules over the wall
clock of all timed batches for the decodes, SMILES->PV and reactions; the
batch over the step time for pretraining, here the mean over all timed
windows (``step_ms_best`` is the best window's, which the JAX bench used).
MFU is the step's FLOPs (``count_flops`` over one step; remat's recompute
counts) against the H100's 989 TFLOP/s bf16 or 67 TFLOP/s fp32 peak; on
the CPU it is not measured (None).  ``step_ms_device`` is the summed
device time of the kernels of a separate profiled window, per step.
``vs_baseline`` divides by ``bench_baseline.json``, read and never written:
the reference's decode strategy on torch on the CPU, not a TPU number.

Timing: each workload is warmed up first (a kernel's first-use build
belongs there; on the card both kernels are built, in parallel, before any
workload, and a decode's warm-up batch captures its CUDA graphs, whose
seconds it prints to stderr); every timed batch gets fresh inputs made from the seed, moved to
the device before the clock starts, and ends with a host fetch of a
reduction of its result (the hard data dependency of bench.py:162-172);
the host clock reads around work that ends in ``torch.cuda.synchronize``.

Correctness, before anything is timed: each workload holds its kernel path
to its plain path on a slice of its warm-up inputs: decode at fp32 over 8
PVs, ``seqs`` and ``n_finished`` exact and ``logp`` within 1e-5 + 5e-7
|logp|; SMILES->PV within 2e-5; reaction greedy ``seqs`` and steps exact at
fp32, the k=5 beam as the decode; every decode batch must have
``lengths.sum() > 0`` (bench.py:175; ``seqs.sum()`` for greedy), every
SMILES->PV batch a finite sum, every pretrain loss must be finite.  A
failure prints ``"correct": false`` on its line and the run exits non-zero.

``--attention plain`` runs both kernels' plain PyTorch versions instead of
the kernels on every timed path (the A/B of scripts/bench_decode.py's first
argument); pretraining and the pipeline run neither.  ``--only`` runs one
workload (the JAX bench's ``--*-only`` flags).  Without a card and without
``--device cpu`` the bench raises before it prints anything.

Not ported from the JAX bench, because each exists for a shared TPU: one
subprocess per workload so that a single TPU client frees the chip; the
compile cache; the ``DECODE_SANE_FLOOR`` retries that keep the best
reading and the pretrain rung retries, which hide contention rather than
report it; the discarding of MFU readings above 0.85.  Kept: the two
PENDING notes first, the headline line again as the last line, and a global
time budget (``--budget_s``) checked before each workload, so a run cut
short still leaves the lines it has printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import statistics
import sys
import time
import traceback
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from spmm_tpu_torch.configs import BertArchConfig, PretrainConfig
from spmm_tpu_torch.data.pipeline import batch_pretrain, prefetch
from spmm_tpu_torch.inference.decoding import BeamSpec, graph_cache
from spmm_tpu_torch.inference.pv2smiles import _beam_batch as pv_beam_batch
from spmm_tpu_torch.inference.pv2smiles import decoder_for
from spmm_tpu_torch.inference.rxn import _beam_batch as rxn_beam_batch
from spmm_tpu_torch.inference.rxn import _greedy_batch
from spmm_tpu_torch.inference.smiles2pv import predict_pv
from spmm_tpu_torch.models.rxn import Rxn
from spmm_tpu_torch.models.spmm import N_PROPERTIES, SPMM
from spmm_tpu_torch.tokenizer import SmilesTokenizer
from spmm_tpu_torch.training.pretrain import (
    init_pretrain_state, make_pretrain_step, step_generator)
from spmm_tpu_torch.utils.device import fp32_matmuls, resolve_device
from spmm_tpu_torch.utils.profiling import (
    H100_PEAK_FLOPS, card_description, count_flops, device_breakdown, mfu)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "s2p_input.txt")
BASELINE_FILE = os.path.join(REPO, "bench_baseline.json")
RELEASED_CKPT = ("checkpoint_SPMM.ckpt",
                 os.path.join(REPO, "checkpoint_SPMM.ckpt"))

# the JAX bench's constants (bench.py:71-97)
N_MOLECULES = 1024
DEVICE_BATCHES = (512, 256, 128)
MAX_STEPS = 60
FULL_STEPS = 100
K = 2
S2P_SEQ_LEN = 48
RXN_SRC_LEN = 96
RXN_K = 5
PIPELINE_BATCH = 96
PRETRAIN_SEQ_LEN = 100
WARMUP_STEPS = 2               # pretraining's, then one counting FLOPs
DEVICE_WINDOW = 4              # pretrain steps under torch.profiler
CHECK_ROWS = 8                 # rows of the warm-up inputs the checks take

UNITS = {
    "pv2smiles_beam_k2_throughput": "mol/s",
    "pv2smiles_beam_k2_throughput_100step": "mol/s",
    "host_pipeline_samples_per_sec": "samples/s",
    "smiles2pv_mol_per_sec": "mol/s",
    "rxn_greedy_mol_per_sec": "mol/s",
    "rxn_beam_k5_mol_per_sec": "mol/s",
    "pretrain_samples_per_sec_chip": "samples/s/chip",
    "pretrain_mfu": "model_flop_utilization",
}
HEADLINE = "pv2smiles_beam_k2_throughput"
DECODE_METRICS = (HEADLINE, "pv2smiles_beam_k2_throughput_100step")
# metric -> its key in bench_baseline.json
BASELINE_KEYS = {HEADLINE: "torch_cpu_mol_per_sec",
                 "pv2smiles_beam_k2_throughput_100step":
                     "torch_cpu_mol_per_sec_100",
                 "smiles2pv_mol_per_sec": "torch_cpu_smiles2pv",
                 "rxn_greedy_mol_per_sec": "torch_cpu_rxn_greedy"}
BASELINE_LABEL = ("bench_baseline.json: the reference's decode strategy (a "
                  "full re-forward per token) on torch on the CPU; not a TPU "
                  "number, and not measured by this bench")
WORKLOADS = ("decode", "pipeline", "smiles2pv", "rxn_greedy", "rxn_beam",
             "pretrain")
KERNEL_WORKLOADS = {"decode", "smiles2pv", "rxn_greedy", "rxn_beam"}
# salts of the input generators, one per workload
_DECODE, _S2P, _RXN, _BEAM, _PRETRAIN = range(1, 6)


@dataclasses.dataclass(frozen=True)
class Setup:
    """Widths, batches and counts of a run: the JAX bench's by default
    (full width: configs None take ``configs.text_config()`` and the
    rest).  The tests and ``chip_smoke.py`` shrink them."""

    seed: int = 0
    text_cfg: Optional[BertArchConfig] = None
    prop_cfg: Optional[BertArchConfig] = None
    smiles_cfg: Optional[BertArchConfig] = None    # the reactant encoder
    decode_steps: tuple = (MAX_STEPS, FULL_STEPS)  # one per DECODE_METRICS
    decode_batches: tuple = DEVICE_BATCHES
    n_molecules: int = N_MOLECULES
    s2p_batches: tuple = (128, 64)
    s2p_timed: int = 5
    rxn_batches: tuple = (128, 64)
    rxn_max_steps: int = FULL_STEPS
    rxn_timed: int = 3
    beam_batch: int = 32
    pipeline_lines: int = 50_000
    # (batch, "bf16" or "fp32") of each pretrain line
    pretrain_runs: tuple = ((96, "bf16"), (64, "bf16"), (96, "fp32"))
    windows: int = 3
    window: int = 12


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rng(seed: int, salt: int, i: int) -> np.random.Generator:
    return np.random.default_rng([seed, salt, i])


def decode_inputs(seed: int, i: int, batch: int) -> np.ndarray:
    """Normalized PVs [batch, 53] ~ N(0, 1) of timed batch ``i`` (0 is the
    warm-up's)."""
    return _rng(seed, _DECODE, i).normal(
        size=(batch, N_PROPERTIES)).astype(np.float32)


def token_inputs(seed: int, salt: int, i: int, batch: int, length: int,
                 cls_first: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Random token ids in [4, 300) [batch, length] (int32, as the
    tokenizer gives them), [CLS] in column 0 with ``cls_first``, and a mask
    of ones."""
    ids = _rng(seed, salt, i).integers(4, 300, size=(batch, length),
                                       dtype=np.int32)
    if cls_first:
        ids[:, 0] = 2
    return ids, np.ones((batch, length), np.int32)


def pipeline_corpus(seed: int, n_lines: int) -> tuple[list, np.ndarray]:
    """The JAX bench's corpus (bench.py:253-265): the example SMILES cycled,
    each with 0-2 random fragments, and properties [n_lines, 53] ~ N(0, 1),
    all from one generator."""
    with open(EXAMPLES) as f:
        seeds = [line.strip() for line in f if line.strip()]
    rng = np.random.default_rng(seed)
    frags = ["C", "CC", "c1ccccc1", "C(=O)O", "N", "Cl", "CCO", "C1CCCCC1"]
    corpus = [seeds[i % len(seeds)] + "".join(
        rng.choice(frags) for _ in range(int(rng.integers(0, 3))))
        for i in range(n_lines)]
    return corpus, rng.normal(size=(n_lines, N_PROPERTIES)).astype(np.float32)


class _Corpus:
    """The PretrainDataset fast path: cached properties and raw text."""

    def __init__(self, texts: list, pv: np.ndarray):
        self.texts, self.pv = texts, pv

    def __len__(self) -> int:
        return len(self.texts)

    def __getitem__(self, i: int):
        return self.pv[i], "[CLS]" + self.texts[i]


def close(got: torch.Tensor, want: torch.Tensor, atol: float,
          rtol: float = 0.0) -> bool:
    """|got - want| <= atol + rtol |want| where ``want`` is finite, equal
    elsewhere."""
    finite = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), finite):
        return False
    if not torch.equal(got[~finite], want[~finite]):
        return False
    err = (got[finite] - want[finite]).abs()
    return bool((err <= atol + rtol * want[finite].abs()).all())


def decode_spec(steps: int, attention: str) -> BeamSpec:
    """The JAX bench's search (bench.py:144): k=2, deterministic, and a
    stop_count no batch reaches (k*k*steps), so every batch runs all
    ``steps``."""
    return BeamSpec(k=K, stop_count=K * K * steps, max_steps=steps,
                    attention=attention)


def rxn_beam_spec(steps: int, attention: str) -> BeamSpec:
    """scripts/bench_rxn.py's search: k=5, stop_count k*k as the CLI."""
    return BeamSpec(k=RXN_K, stop_count=RXN_K * RXN_K, max_steps=steps,
                    attention=attention)


def warm_up(dev: torch.device, what: str, run: Callable, x):
    """``run(x)``, a decode workload's warm-up batch, before the clock; its
    seconds, and those of the decode graphs it captured (on a card), to
    stderr.  Returns its result."""
    before = graph_cache.stats()
    t0 = time.perf_counter()
    out = run(x)
    _sync(dev)
    after = graph_cache.stats()
    log(f"{what}: warm-up batch {time.perf_counter() - t0:.1f} s, of which "
        f"{after['capture_s'] - before['capture_s']:.1f} s capturing "
        f"{after['captured'] - before['captured']} decode graphs")
    return out


def timed(dev: torch.device, inputs: Sequence, run: Callable,
          fetch: Callable) -> tuple[list, list, float]:
    """Each of ``inputs`` through ``run``, each ended by ``fetch`` (a host
    fetch of a reduction of its result): (seconds per input, the fetched
    values, seconds of all)."""
    _sync(dev)
    stamps, fetched = [time.perf_counter()], []
    for x in inputs:
        fetched.append(fetch(run(x)))
        _sync(dev)
        stamps.append(time.perf_counter())
    return np.diff(stamps).tolist(), fetched, stamps[-1] - stamps[0]


def first_that_fits(dev: torch.device, batches: Sequence[int],
                    measure: Callable[[int], dict]) -> dict:
    """``measure(batch)`` at the first of ``batches`` that fits: an
    out-of-memory error falls through to the next, the last re-raises."""
    for n, batch in enumerate(batches):
        try:
            return measure(batch)
        except torch.OutOfMemoryError:
            if n + 1 == len(batches):
                raise
        log(f"batch {batch}: out of memory; trying {batches[n + 1]}")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    raise ValueError("no batch to try")


def read_baseline() -> dict:
    """bench_baseline.json (read only), {} if absent or at another k."""
    try:
        with open(BASELINE_FILE) as f:
            data = json.load(f)
    except FileNotFoundError:
        return {}
    return data if data.get("k", K) == K else {}


def pending_gates() -> list[str]:
    """The two env-blocked validation gates (bench.py:688-713): run them
    when the environment allows, else say why not."""
    ckpt = next((p for p in RELEASED_CKPT if os.path.exists(p)), None)
    notes = [
        "PENDING: env-blocked gate — released checkpoint_SPMM.ckpt absent; "
        "the 1e-4 golden parity against it (BASELINE.json north star; "
        "spmm_tpu/checkpoint/verify.py, reference load path "
        "d_smiles2pv.py:119-143) has not run for the port"
        if ckpt is None else
        f"RUN NOW: released checkpoint found at {ckpt} — hold the port's "
        "predict_pv to the reference on it (the 1e-4 golden gate)"]
    notes.append(
        "PENDING: env-blocked gate — RDKit absent; featurizer goldens "
        "(reference calc_property.py:31-36, rdkit==2023.3.1) have never "
        "executed in this image"
        if importlib.util.find_spec("rdkit") is None else
        "RUN NOW: RDKit present — run the pinned-value featurizer goldens "
        "(tests/test_chem.py)")
    return notes


class Bench:
    """The workloads, each a generator of lines, on ``device`` with
    ``attention`` ("kernel" or "plain") on every timed path."""

    def __init__(self, device: torch.device, attention: str = "kernel",
                 setup: Setup = Setup()):
        if attention not in ("kernel", "plain"):
            raise ValueError(f"unknown attention {attention!r}")
        self.dev, self.attention, self.setup = device, attention, setup
        self.baseline = read_baseline()
        self.common = {
            "device": device.type,
            "card": card_description() if device.type == "cuda" else None,
            "torch": torch.__version__, "cuda": torch.version.cuda}

    def line(self, metric: str, value: Optional[float], correct: bool,
             batch_ms: list, **fields) -> dict:
        base = self.baseline.get(BASELINE_KEYS.get(metric))
        return {"metric": metric, "value": value, "unit": UNITS[metric],
                "vs_baseline": value / base if base and value else None,
                "baseline": BASELINE_LABEL if base else None, **fields,
                "median_batch_ms": statistics.median(batch_ms),
                "batch_ms": batch_ms, "n_samples": len(batch_ms),
                **self.common, "correct": bool(correct)}

    def tensors(self, *arrays) -> tuple:
        return tuple(torch.as_tensor(a, device=self.dev) for a in arrays)

    # ---- PV -> SMILES ----

    def decode(self) -> Iterator[dict]:
        s, dev = self.setup, self.dev
        model = SPMM.random_init(s.seed, s.text_cfg, s.prop_cfg, device=dev)
        decoder = decoder_for(model, bf16=True)
        for metric, steps in zip(DECODE_METRICS, s.decode_steps):
            spec = decode_spec(steps, self.attention)

            def run(pv):
                return pv_beam_batch(model, decoder, pv, None, spec)

            def fetch(out):
                return int(out["lengths"].sum()), out["steps"]

            def measure(batch):
                warm, = self.tensors(decode_inputs(s.seed, 0, batch))
                sums = [fetch(warm_up(dev, f"{metric} batch {batch}", run,
                                      warm))[0]]
                correct = self.decode_check(model, warm[:CHECK_ROWS], steps)
                n = max(s.n_molecules // batch, 1)
                inputs = [self.tensors(decode_inputs(s.seed, i + 1, batch))[0]
                          for i in range(n)]
                secs, got, wall = timed(dev, inputs, run, fetch)
                sums += [g[0] for g in got]
                return self.line(
                    metric, n * batch / wall, correct and min(sums) > 0,
                    [1e3 * x for x in secs], batch=batch, k=K,
                    max_steps=steps, steps=[g[1] for g in got], dtype="bf16",
                    attention=self.attention, molecules=n * batch)

            yield first_that_fits(dev, s.decode_batches, measure)

    def decode_check(self, model: SPMM, pv: torch.Tensor, steps: int) -> bool:
        """fp32 beam search of ``pv`` through kernel 1 and through its
        plain version: seqs and n_finished equal, logp within 1e-5 +
        5e-7 |logp| (tests/test_torch_decoding.py's bar)."""
        return beams_agree(*(
            pv_beam_batch(model, model.text_encoder, pv, None,
                          decode_spec(steps, attention))
            for attention in ("kernel", "plain")))

    # ---- the host pipeline ----

    def pipeline(self) -> Iterator[dict]:
        s = self.setup
        texts, pv = pipeline_corpus(s.seed, s.pipeline_lines)
        tok = SmilesTokenizer()
        native = tok.native_encoder() is not None   # its first use builds it
        it = prefetch(batch_pretrain(tok, _Corpus(texts, pv), PIPELINE_BATCH,
                                     shuffle=True, seed=s.seed), depth=4)
        n, rows = 0, []
        stamps = [time.perf_counter()]
        for batch in it:
            n += batch["ids"].shape[0]
            rows.append(batch["ids"].shape[0])
            stamps.append(time.perf_counter())
        wall = stamps[-1] - stamps[0]
        yield self.line(
            "host_pipeline_samples_per_sec", n / wall,
            n == len(texts) // PIPELINE_BATCH * PIPELINE_BATCH,
            (1e3 * np.diff(stamps)).tolist(), batch=PIPELINE_BATCH,
            lines=len(texts), samples=n,
            native_tokenizer=native, uses_device=False)

    # ---- SMILES -> PV ----

    def smiles2pv(self) -> Iterator[dict]:
        s, dev = self.setup, self.dev
        model = SPMM.random_init(s.seed, s.text_cfg, s.prop_cfg, device=dev)
        length = S2P_SEQ_LEN

        def run(x, attention=self.attention):
            return predict_pv(model, *x, attention_impl=attention, device=dev)

        def measure(batch):
            warm = self.tensors(*token_inputs(s.seed, _S2P, 0, batch, length))
            run(warm)
            part = tuple(t[:CHECK_ROWS] for t in warm)
            correct = close(run(part, "kernel"), run(part, "plain"), 2e-5)
            inputs = [self.tensors(*token_inputs(s.seed, _S2P, i + 1, batch,
                                                 length))
                      for i in range(s.s2p_timed)]
            secs, sums, wall = timed(dev, inputs, run,
                                     lambda out: float(out.abs().sum()))
            return self.line(
                "smiles2pv_mol_per_sec", s.s2p_timed * batch / wall,
                correct and bool(np.isfinite(sums).all()),
                [1e3 * x for x in secs], batch=batch, seq_len=length,
                dtype="fp32", attention=self.attention,
                molecules=s.s2p_timed * batch)

        yield first_that_fits(dev, s.s2p_batches, measure)

    # ---- reaction prediction ----

    def rxn_model(self) -> tuple[Rxn, torch.nn.Module]:
        s = self.setup
        model = Rxn.random_init(s.seed, s.text_cfg, s.smiles_cfg,
                                device=self.dev)
        return model, decoder_for(model, bf16=True)

    def rxn_inputs(self, salt: int, i: int, batch: int) -> tuple:
        return self.tensors(*token_inputs(self.setup.seed, salt, i, batch,
                                          RXN_SRC_LEN, cls_first=True))

    def rxn_greedy(self) -> Iterator[dict]:
        s, dev = self.setup, self.dev
        model, decoder = self.rxn_model()
        steps = s.rxn_max_steps

        def run(x, decoder=decoder, attention=self.attention):
            return _greedy_batch(model, decoder, *x, max_steps=steps,
                                 attention=attention)

        def fetch(out):
            return int(out["seqs"].sum()), out["steps"]

        def measure(batch):
            warm = self.rxn_inputs(_RXN, 0, batch)
            sums = [fetch(warm_up(dev, f"rxn greedy batch {batch}", run,
                                  warm))[0]]
            part = tuple(t[:CHECK_ROWS] for t in warm)
            got, want = (run(part, model.text_encoder, attention)
                         for attention in ("kernel", "plain"))
            correct = (torch.equal(got["seqs"], want["seqs"])
                       and got["steps"] == want["steps"])
            inputs = [self.rxn_inputs(_RXN, i + 1, batch)
                      for i in range(s.rxn_timed)]
            secs, out, wall = timed(dev, inputs, run, fetch)
            sums += [o[0] for o in out]
            return self.line(
                "rxn_greedy_mol_per_sec", s.rxn_timed * batch / wall,
                correct and min(sums) > 0, [1e3 * x for x in secs],
                batch=batch, src_len=RXN_SRC_LEN, max_steps=steps,
                steps=[o[1] for o in out], dtype="bf16",
                attention=self.attention, molecules=s.rxn_timed * batch)

        yield first_that_fits(dev, s.rxn_batches, measure)

    def rxn_beam(self) -> Iterator[dict]:
        s, dev = self.setup, self.dev
        model, decoder = self.rxn_model()
        steps, batch = s.rxn_max_steps, s.beam_batch

        def run(x, decoder=decoder, attention=self.attention):
            return rxn_beam_batch(model, decoder, *x,
                                  rxn_beam_spec(steps, attention))

        def fetch(out):
            return int(out["lengths"].sum()), out["steps"]

        def measure(batch):
            warm = self.rxn_inputs(_BEAM, 0, batch)
            sums = [fetch(warm_up(dev, f"rxn k=5 beam batch {batch}", run,
                                  warm))[0]]
            part = tuple(t[:CHECK_ROWS] for t in warm)
            correct = beams_agree(*(run(part, model.text_encoder, attention)
                                    for attention in ("kernel", "plain")))
            inputs = [self.rxn_inputs(_BEAM, i + 1, batch)
                      for i in range(s.rxn_timed)]
            secs, out, wall = timed(dev, inputs, run, fetch)
            sums += [o[0] for o in out]
            return self.line(
                "rxn_beam_k5_mol_per_sec", s.rxn_timed * batch / wall,
                correct and min(sums) > 0, [1e3 * x for x in secs],
                batch=batch, k=RXN_K, src_len=RXN_SRC_LEN,
                max_steps=steps, steps=[o[1] for o in out], dtype="bf16",
                attention=self.attention, molecules=s.rxn_timed * batch)

        yield first_that_fits(dev, (batch,), measure)

    # ---- pretraining ----

    def pretrain(self) -> Iterator[dict]:
        lines = []
        for batch, compute in self.setup.pretrain_runs:
            lines.append(self.pretrain_line(batch, compute))
            yield lines[-1]
        measured = [ln for ln in lines if ln["mfu"] is not None]
        best = max(measured, key=lambda ln: ln["mfu"]) if measured \
            else lines[0]
        yield self.line(
            "pretrain_mfu", best["mfu"], all(ln["correct"] for ln in lines),
            best["batch_ms"], samples_per_sec=best["value"],
            **{key: best[key] for key in (
                "batch", "accum", "compute", "step_ms_best", "step_ms_device",
                "flops_per_step", "peak_flops")})

    def pretrain_batch(self, i: int, batch: int) -> dict:
        ids, mask = token_inputs(self.setup.seed, _PRETRAIN, i, batch,
                                 PRETRAIN_SEQ_LEN, cls_first=True)
        prop = _rng(self.setup.seed, _PRETRAIN + 100, i).normal(
            size=(batch, N_PROPERTIES)).astype(np.float32)
        return dict(zip(("prop", "ids", "mask"),
                        self.tensors(prop, ids, mask)))

    def pretrain_line(self, batch: int, compute: str) -> dict:
        """The JAX bench's ``run_at_batch`` (bench.py:534-660): warm-up
        steps, one step under FlopCounterMode, ``windows`` windows of
        ``window`` steps dispatched back to back, each ended by a fetch of
        its last loss, then a window under torch.profiler for the device
        time of a step.  A fresh batch and dropout generator every step."""
        s, dev = self.setup, self.dev
        marks = [time.perf_counter()]
        pcfg = PretrainConfig(batch_size=batch, bf16_compute=compute == "bf16",
                              remat=True, bf16_moments=True)
        model = init_pretrain_state(s.seed, pcfg, s.text_cfg, s.prop_cfg,
                                    device=dev)
        _, step = make_pretrain_step(model, pcfg, steps_per_epoch=1000)
        n_steps = WARMUP_STEPS + 1 + s.windows * s.window + DEVICE_WINDOW
        batches = [self.pretrain_batch(i, batch) for i in range(n_steps)]

        def run(i):
            return step(i, batches[i], step_generator(s.seed, i, dev))["loss"]

        marks.append(time.perf_counter())
        losses = [run(i) for i in range(WARMUP_STEPS)]
        _, flops = count_flops(lambda: losses.append(run(WARMUP_STEPS)))
        marks.append(time.perf_counter())
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        windows, i = [], WARMUP_STEPS + 1
        for _ in range(s.windows):
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(s.window):
                losses.append(run(i))
                i += 1
            float(losses[-1])          # a hard dependency on the window
            _sync(dev)
            windows.append((time.perf_counter() - t0) / s.window)
        step_s = sum(windows) / len(windows)
        marks.append(time.perf_counter())
        extra = {"mfu": None, "step_ms_device": None, "peak_flops": None,
                 "max_memory_gib": None}
        if dev.type == "cuda":
            peak = H100_PEAK_FLOPS[compute]
            prof = device_breakdown(lambda: losses.extend(
                run(i + j) for j in range(DEVICE_WINDOW)))
            extra = {"mfu": mfu(flops, step_s, peak_per_chip=peak),
                     "step_ms_device": None if prof["device_busy_s"] is None
                     else 1e3 * prof["device_busy_s"] / DEVICE_WINDOW,
                     "peak_flops": peak,
                     "max_memory_gib": torch.cuda.max_memory_allocated(dev)
                     / 2 ** 30}
        marks.append(time.perf_counter())
        log(f"pretrain {compute} batch {batch}: " + ", ".join(
            f"{what} {b - a:.1f} s" for what, a, b in zip(
                ("state", "warm-up and FLOP count", "timed windows",
                 "profiled window"), marks, marks[1:])))
        finite = all(np.isfinite(float(x)) for x in losses)
        del model, step, batches
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return self.line(
            "pretrain_samples_per_sec_chip", batch / step_s, finite,
            [1e3 * w for w in windows], batch=batch, accum=1,
            seq_len=PRETRAIN_SEQ_LEN, compute=compute, remat=True,
            bf16_moments=True, queue=pcfg.queue_size, steps_per_window=s.window,
            step_ms_best=1e3 * min(windows), flops_per_step=flops, **extra)


def beams_agree(got: dict, want: dict) -> bool:
    """Two beam searches agree: seqs and n_finished equal, logp within
    1e-5 + 5e-7 |logp|."""
    return (torch.equal(got["seqs"], want["seqs"])
            and torch.equal(got["n_finished"], want["n_finished"])
            and close(got["logp"], want["logp"], 1e-5, 5e-7))


def build_kernels() -> float:
    """Build both kernels' libraries, one nvcc each, started together;
    the seconds it took."""
    from concurrent.futures import ThreadPoolExecutor

    from spmm_tpu_torch.ops import decode_attention, fused_attention

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for fut in [pool.submit(m.build)
                    for m in (decode_attention, fused_attention)]:
            fut.result()
    return time.perf_counter() - t0


def main(argv: Optional[list] = None, setup: Setup = Setup()) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--attention", choices=("kernel", "plain"),
                        default="kernel",
                        help="both kernels, or both plain versions")
    parser.add_argument("--only", choices=WORKLOADS, default=None,
                        help="run this workload alone")
    parser.add_argument("--device", default=None,
                        help="the GPU unless given (e.g. cpu)")
    parser.add_argument("--seed", type=int, default=setup.seed,
                        help="seed of the weights and every input")
    parser.add_argument("--budget_s", type=float, default=1500.0,
                        help="start no workload after this many seconds")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    t_start = time.monotonic()
    for note in pending_gates():
        print(note, flush=True)
    names = (args.only,) if args.only else WORKLOADS
    if dev.type == "cuda":
        fp32_matmuls()
        if set(names) & KERNEL_WORKLOADS:
            log(f"kernels built in {build_kernels():.1f} s")
    bench = Bench(dev, args.attention, dataclasses.replace(setup,
                                                           seed=args.seed))
    failed, headline = [], None
    for name in names:
        if time.monotonic() - t_start > args.budget_s:
            log(f"{name}: skipped, the {args.budget_s:.0f} s budget is spent")
            failed.append(name)
            continue
        t0 = time.monotonic()
        try:
            for rec in getattr(bench, name)():
                print(json.dumps(rec), flush=True)
                if not rec["correct"]:
                    failed.append(rec["metric"])
                if rec["metric"] == HEADLINE:
                    headline = rec
        except Exception:    # one workload's failure does not stop the rest
            traceback.print_exc()
            failed.append(name)
        log(f"{name}: {time.monotonic() - t0:.1f} s")
    if headline is not None:
        print(json.dumps(headline), flush=True)
    if failed:
        log(f"failed or not run: {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
