#!/usr/bin/env python3
"""Time the one-process pretrain step of several checkouts on one GPU.

    python3 scripts/time_pretrain_steps.py NAME=DIR [NAME=DIR ...]

Each DIR is a checkout of the repo (another commit unpacked with ``git
archive``, or this one).  Each version runs in a process of its own, which
imports ``spmm_tpu_torch`` from its DIR, builds the full-width pretrain
state from the seed (``init_pretrain_state``) and times its
``make_pretrain_step`` at batch 96, queue 36,864, dropout on (a generator
per step), without a process group: WARMUP steps, then STEPS steps timed
between synchronizations, in fp32 and in ``bf16_compute``.  The versions
run in turns, first to last and then last to first, and each row reports a
version's two timings.  Prints the card's name and power limit first.
Needs CUDA; run from the repo's root.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WARMUP, STEPS = 2, 8


def child(where: str) -> None:
    """One version's timings, as one JSON line on stdout."""
    sys.path.insert(0, where)
    import torch

    import chip_smoke as cs
    from spmm_tpu_torch.configs import PretrainConfig
    from spmm_tpu_torch.training.pretrain import (
        init_pretrain_state, make_pretrain_step, step_generator)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    n, queue = cs.PRETRAIN
    batch, _ = cs.pretrain_batch(dev, n, cs.SEED + 21)
    out = {}
    for dtype in ("fp32", "bf16"):
        pcfg = PretrainConfig(queue_size=queue, bf16_compute=dtype == "bf16")
        model = init_pretrain_state(cs.SEED, pcfg, device=dev)
        _, step = make_pretrain_step(model, pcfg, 1000)
        for i in range(WARMUP):
            step(i, batch, step_generator(cs.SEED, i, dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(WARMUP, WARMUP + STEPS):
            step(i, batch, step_generator(cs.SEED, i, dev))
        torch.cuda.synchronize()
        out[f"{dtype}_ms"] = 1e3 * (time.perf_counter() - t0) / STEPS
        del model, step
        torch.cuda.empty_cache()
    print(json.dumps(out))


def main(argv: list) -> int:
    if argv[:1] == ["--child"]:
        child(argv[1])
        return 0
    versions = dict(arg.split("=", 1) for arg in argv)
    if not versions:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    rows = {name: [] for name in versions}
    order = list(versions) + list(reversed(versions))
    for name in order:
        where = os.path.abspath(versions[name])
        proc = subprocess.run(
            [sys.executable, __file__, "--child", where], cwd=where,
            capture_output=True, text=True, timeout=900,
            env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-3000:], file=sys.stderr)
            return 1
        rows[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"  {name}: {rows[name][-1]}", flush=True)
    for name, runs in rows.items():
        print(f"{name}: fp32 " + ", ".join(f"{r['fp32_ms']:.1f}" for r in runs)
              + " ms a step; bf16 "
              + ", ".join(f"{r['bf16_ms']:.1f}" for r in runs) + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
