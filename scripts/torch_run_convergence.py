"""Convergence evidence run of the PyTorch port (counterpart of
scripts/run_convergence.py): ``spmm_tpu_torch.cli.pretrain`` on the GPU for
a few hundred steps, with a checkpoint and resume in the middle.

  1. phase A: ``cli.pretrain --max_steps N --save_every N//3`` from
     scratch (bf16 autocast, remat, batch 32, queue 256), in a process of
     its own so that it owns the card;
  2. phase B: ``--resume <phase A>/step_{2N/3}.pt`` into its own output
     directory, trained to N: restore and data fast-forward mid-run;
  3. gates (the JAX script's): all four losses (mlm, mpm, ita, itm) fall
     from the mean of the first 20 logged steps to the mean of the last
     20; from 600 steps on, ITA falls by at least 1.5 nats; phase B's
     logged steps start at 2N/3+1 with no gap.

The corpus (``make_corpus``) is the JAX script's, byte for byte: 20,000
synthetic SMILES and a property cache whose vectors cluster by the line's
seed molecule.  Outputs: <evidence_dir>/torch_metrics_phaseA.jsonl,
torch_metrics_phaseB.jsonl and torch_convergence_summary.json (the JAX
summary's keys, plus the card, its power limit, torch and CUDA versions,
each phase's wall and the samples/s the CLI prints).  Exits 1 when a gate
fails.

    python scripts/torch_run_convergence.py [--steps 300] [--batch_size 32]
        [--device cuda|cpu] [--workdir DIR] [--evidence_dir DIR]

Without a GPU it stops unless given ``--device cpu``.  Each CLI runs
through ``run(module, argv)``: by default ``python -m module argv`` from
the repository root (``run_module``); ``main(argv, run=...)`` takes any
function with that signature that returns the CLI's standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_KEYS = ("loss_mlm", "loss_mpm", "loss_ita", "loss_itm")
ITA_MIN_DROP = 1.5          # nats, gated from ITA_GATE_FROM steps on
ITA_GATE_FROM = 600
WINDOW = 20


def make_corpus(path: str, n: int, seed: int = 0) -> tuple[str, str]:
    """Synthetic-but-tokenizable SMILES corpus + aligned property cache
    (a copy of scripts/run_convergence.py's: the same files)."""
    import numpy as np

    rng = random.Random(seed)
    seeds = ["CC(=O)O", "c1ccccc1", "CCO", "CCN", "C1CCCCC1", "CC(C)O",
             "CCCl", "OC=O", "c1ccncc1", "CC(N)C(=O)O", "COC", "CC#N"]
    frags = ["C", "CC", "c1ccccc1", "C(=O)O", "N", "Cl", "CCO", "O",
             "C1CCCCC1", "Br", "C(C)(C)"]
    lines = []
    for i in range(n):
        s = seeds[i % len(seeds)]
        s += "".join(rng.choice(frags) for _ in range(rng.randrange(0, 4)))
        lines.append(s)
    corpus = os.path.join(path, "corpus.txt")
    with open(corpus, "w") as f:
        f.write("\n".join(lines) + "\n")
    # a per-molecule PV near its seed molecule's: ITA has a learnable
    # text<->pv correspondence
    np_rng = np.random.default_rng(seed)
    base = np_rng.normal(size=(len(seeds), 53))
    pv = np.stack([base[i % len(seeds)]
                   + 0.1 * np_rng.normal(size=53) for i in range(n)])
    cache = os.path.join(path, "corpus.pv.npz")
    np.savez(cache, pv=pv.astype(np.float32))
    return corpus, cache


def run_module(module: str, argv: list) -> str:
    """``python -m module argv`` from the repository root, its output shown
    as it comes and returned; raises CalledProcessError on failure."""
    cmd = [sys.executable, "-m", module, *argv]
    print("+", " ".join(cmd), flush=True)
    lines = []
    with subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True) as proc:
        for line in proc.stdout:
            sys.stdout.write(line)
            sys.stdout.flush()
            lines.append(line)
    if proc.returncode:
        raise subprocess.CalledProcessError(proc.returncode, cmd,
                                            "".join(lines[-50:]))
    return "".join(lines)


def load_metrics(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def window_means(records: list, keys, w: int = WINDOW,
                 tail: bool = False) -> dict:
    """Mean of each key over the first (or last) ``min(w, len // 2)``
    records, at least one."""
    w = min(w, max(len(records) // 2, 1))
    rows = records[-w:] if tail else records[:w]
    return {k: sum(r[k] for r in rows) / w for k in keys}


def samples_per_s(output: str) -> list:
    """The samples/s of every progress line the pretrain CLI printed."""
    return [float(x) for x in re.findall(r"\(([0-9.]+) samples/s", output)]


def card_info() -> dict:
    """The card's name and power limit (nvidia-smi), torch and CUDA."""
    import torch

    card = power = None
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            card, _, power = smi.stdout.strip().splitlines()[0].rpartition(
                ", ")
    except OSError:
        pass
    return {"card": card, "power_limit": power, "torch": torch.__version__,
            "cuda": torch.version.cuda}


def convergence_summary(ma: list, mb: list, steps: int,
                        batch_size: int) -> dict:
    """The JAX script's verdict over phase A's records ``ma`` and phase B's
    ``mb`` (one dict per logged step)."""
    third = steps // 3
    first = window_means(ma, LOSS_KEYS)
    last = window_means(ma, LOSS_KEYS, tail=True)
    decreased = {k: last[k] < first[k] for k in LOSS_KEYS}
    # the contrastive loss over a queue of Q momentum negatives starts near
    # 2 ln(Q + B) nats and falls only once the queue holds embeddings of a
    # trained encoder: long runs must show a visible fall
    ita_drop = first["loss_ita"] - last["loss_ita"]
    ita_gate = ita_drop >= ITA_MIN_DROP if steps >= ITA_GATE_FROM else None
    resume_start = mb[0]["step"] if mb else None
    contiguous = bool(mb) and [m["step"] for m in mb] == list(
        range(resume_start, resume_start + len(mb)))
    return {
        "steps": steps,
        "batch_size": batch_size,
        "first20_mean": first,
        "last20_mean": last,
        "decreased": decreased,
        "ita_drop_nats": ita_drop,
        "ita_gate_min_drop": ITA_MIN_DROP,
        "ita_gate": ita_gate if ita_gate is not None else
        f"not gated below {ITA_GATE_FROM} steps (this run: {steps}); at "
        f"queue {batch_size * 8} >> batch {batch_size} the queue needs "
        "hundreds of steps to cycle trained embeddings",
        "resume_from_step": 2 * third,
        "resume_first_logged_step": resume_start,
        "resume_steps_contiguous": contiguous,
        "resumed_last20_mean": (window_means(mb, LOSS_KEYS, tail=True)
                                if mb else None),
        "ok": all(decreased.values()) and contiguous
        and resume_start == 2 * third + 1
        and (ita_gate is None or ita_gate),
    }


def pretrain_argv(corpus: str, cache: str, out_dir: str, steps: int,
                  save_every: int, batch_size: int, device: str,
                  resume: str | None = None) -> list:
    argv = ["--data_path", corpus, "--property_cache", cache,
            "--output_dir", out_dir, "--batch_size", str(batch_size),
            "--queue_size", str(batch_size * 8), "--epochs", "100",
            "--save_every", str(save_every), "--max_steps", str(steps),
            "--bf16", "--remat", "--device", device]
    return argv + (["--resume", resume] if resume else [])


def default_workdir(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def convergence(args, run=run_module) -> dict:
    """Both phases and the summary (written to ``args.evidence_dir``)."""
    os.makedirs(args.workdir, exist_ok=True)
    os.makedirs(args.evidence_dir, exist_ok=True)
    corpus, cache = make_corpus(args.workdir, n=20_000)
    third = args.steps // 3
    outs, walls, rates, metrics = {}, {}, {}, {}
    for phase, resume in (("phaseA", None), ("phaseB", "phaseA")):
        out = outs[phase] = os.path.join(args.workdir, phase)
        shutil.rmtree(out, ignore_errors=True)    # the logger appends
        ckpt = (os.path.join(outs[resume], f"step_{2 * third}.pt")
                if resume else None)
        t0 = time.perf_counter()
        output = run("spmm_tpu_torch.cli.pretrain", pretrain_argv(
            corpus, cache, out, args.steps, third, args.batch_size,
            args.device, ckpt))
        walls[phase] = time.perf_counter() - t0
        rates[phase] = samples_per_s(output)
        metrics[phase] = os.path.join(out, "metrics.jsonl")
        shutil.copyfile(metrics[phase], os.path.join(
            args.evidence_dir, f"torch_metrics_{phase}.jsonl"))

    summary = convergence_summary(load_metrics(metrics["phaseA"]),
                                  load_metrics(metrics["phaseB"]),
                                  args.steps, args.batch_size)
    summary.update(device=args.device, **card_info(), wall_s=walls,
                   samples_per_s=rates)
    summary["ok"] = summary.pop("ok")             # last, as in JAX's file
    with open(os.path.join(args.evidence_dir,
                           "torch_convergence_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    return summary


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--workdir",
                    default=default_workdir("spmm_torch_convergence"))
    ap.add_argument("--evidence_dir", default=os.path.join(REPO, "evidence"))
    return ap.parse_args(argv)


def main(argv=None, run=run_module) -> dict:
    args = parse_args(argv)
    sys.path.insert(0, REPO)
    from spmm_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)         # no GPU and no --device cpu: raise
    summary = convergence(args, run)
    if not summary["ok"]:
        sys.exit(1)
    return summary


if __name__ == "__main__":
    main()
