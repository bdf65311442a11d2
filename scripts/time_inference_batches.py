#!/usr/bin/env python3
"""Time one PV->SMILES and one SMILES->PV batch of several checkouts on one
GPU, on the unsharded path the inference CLIs take on one card.

    python3 scripts/time_inference_batches.py NAME=DIR [NAME=DIR ...]

Each DIR is a checkout of the repo (another commit unpacked with ``git
archive``, or this one).  Each version runs in a process of its own, which
imports ``spmm_tpu_torch`` from its DIR (building both kernels into that
checkout's ``build/`` at first use), makes the full-width SPMM from the
seed and times, between synchronizations, a bf16 k=2 beam search of 128
PVs (``inference.pv2smiles._beam_batch`` with the bf16 decoder, as the
service runs it) and an fp32 ``predict_pv`` of 128 SMILES (L=100, through
kernel 2): WARMUP calls, then CALLS timed calls each.  The versions run in
turns, first to last and then last to first, and each row reports a
version's two timings.  Prints the card's name and power limit first.
Needs CUDA; run from the repo's root.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

WARMUP, CALLS = 2, 5


def child(where: str) -> None:
    """One version's timings, as one JSON line on stdout."""
    sys.path.insert(0, where)
    import numpy as np
    import torch

    import chip_smoke as cs
    from spmm_tpu_torch.inference import pv2smiles
    from spmm_tpu_torch.inference.decoding import BeamSpec
    from spmm_tpu_torch.inference.smiles2pv import predict_pv
    from spmm_tpu_torch.models.spmm import SPMM

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    model = SPMM.random_init(cs.SEED, device=dev)
    decoder = pv2smiles.decoder_for(model, bf16=True)
    pv = torch.as_tensor(np.random.default_rng(cs.SEED + 40).normal(
        size=(128, 53)).astype(np.float32), device=dev)
    _, ids, mask = cs.s2p_batch()
    calls = {
        "pv2smiles_s": lambda: pv2smiles.to_host(pv2smiles._beam_batch(
            model, decoder, pv, None, BeamSpec(k=2, stop_count=2))),
        "smiles2pv_s": lambda: predict_pv(model, ids, mask,
                                          device=dev).cpu(),
    }
    out = {}
    for name, fn in calls.items():
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(CALLS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = times
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
            [sys.executable, os.path.abspath(__file__), "--child", where],
            cwd=where, capture_output=True, text=True, timeout=900,
            env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-3000:], file=sys.stderr)
            return 1
        rows[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"  {name}: {rows[name][-1]}", flush=True)
    for name, runs in rows.items():
        for key in ("pv2smiles_s", "smiles2pv_s"):
            print(f"{name} {key}: " + "; ".join(
                ", ".join(f"{t:.3f}" for t in r[key]) for r in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
