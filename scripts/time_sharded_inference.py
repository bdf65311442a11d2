#!/usr/bin/env python3
"""Time sharded inference on one GPU: a batch in this process against the
same batch split over worker processes (``parallel.replicas``), in pairs.

    python3 scripts/time_sharded_inference.py [--pairs 10] [--workers 2]

Builds both kernels, makes the full-width SPMM from the seed and starts
one pool of ``--workers`` processes on the card (``devices=[cuda:0] *
workers``) and one of a single process.  For each path (fp32 and bf16 k=2
PV->SMILES beam search of 128 PVs, 100 steps; fp32 predict_pv of 128
SMILES, L=100) it runs one warm-up batch of each kind, then ``--pairs``
pairs of (unsharded, sharded), alternating which of the two runs first,
then three batches through the single worker.  Prints the card's name and
power limit, the pools' start-up seconds, then one JSON line a path: every
wall, each side's median and quartiles, and the ratio of the medians.
Exits 1 if a sharded fp32 batch differs from the unsharded one (seqs
exact, logp within 1e-5 + 5e-7 x |logp|; PVs within 1e-5).  Needs CUDA;
run from the repo's root.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def wall(fn):
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def quartiles(xs: list) -> list:
    import numpy as np

    return [float(q) for q in np.percentile(xs, [25, 50, 75])]


def timed_path(name: str, unsharded, sharded, alone, pairs: int) -> dict:
    """Warm both, then ``pairs`` pairs in alternating order, then three
    batches in the single worker (the first warms it)."""
    unsharded()
    sharded()
    walls = {"unsharded": [], "sharded": []}
    results = {}
    for i in range(pairs):
        order = ("unsharded", "sharded") if i % 2 == 0 else ("sharded",
                                                            "unsharded")
        for kind in order:
            res, secs = wall(unsharded if kind == "unsharded" else sharded)
            results.setdefault(kind, res)
            walls[kind].append(secs)
    alone_s = [wall(alone)[1] for _ in range(3)][1:]
    q_u, q_s = quartiles(walls["unsharded"]), quartiles(walls["sharded"])
    return {"path": name, "unsharded_s": walls["unsharded"],
            "sharded_s": walls["sharded"], "one_worker_s": alone_s,
            "unsharded_quartiles_s": q_u, "sharded_quartiles_s": q_s,
            "sharded_over_unsharded": q_s[1] / q_u[1],
            "sharded_won": sum(s < u for u, s in zip(walls["unsharded"],
                                                     walls["sharded"])),
            "results": results}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--workers", type=int, default=2)
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from spmm_tpu_torch.inference import pv2smiles
    from spmm_tpu_torch.inference.decoding import BeamSpec
    from spmm_tpu_torch.inference.smiles2pv import predict_pv, predict_pv_rows
    from spmm_tpu_torch.models.spmm import SPMM
    from spmm_tpu_torch.ops import decode_attention, fused_attention
    from spmm_tpu_torch.parallel.replicas import Replicas, WorkerPool

    if not torch.cuda.is_available():
        print("time_sharded_inference: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    decode_attention.build()
    fused_attention.build()
    model = SPMM.random_init(cs.SEED, device=dev)
    pv = np.random.default_rng(cs.SEED + 30).normal(
        size=(128, 53)).astype(np.float32)
    spec = BeamSpec(k=2, stop_count=2)
    _, ids, mask = cs.s2p_batch()
    ok = True
    t0 = time.perf_counter()
    with WorkerPool([dev] * args.workers) as pool, WorkerPool([dev]) as one:
        print(json.dumps({"spawn_s": time.perf_counter() - t0,
                          "workers": args.workers, "card": card}),
              flush=True)
        for bf16 in (False, True):
            decoder = pv2smiles.decoder_for(model, bf16)
            t0 = time.perf_counter()
            with pv2smiles.replicas_for(model, pool, bf16) as reps, \
                    pv2smiles.replicas_for(model, one, bf16) as alone:
                weights_s = time.perf_counter() - t0
                row = timed_path(
                    f"pv2smiles_{'bf16' if bf16 else 'fp32'}",
                    lambda: pv2smiles.to_host(pv2smiles._beam_batch(
                        model, decoder, torch.as_tensor(pv, device=dev),
                        None, spec)),
                    lambda: pv2smiles.beam_rows(reps, pv, None, spec, None),
                    lambda: pv2smiles.beam_rows(alone, pv, None, spec, None),
                    args.pairs)
            want, got = row["results"].pop("unsharded"), \
                row["results"].pop("sharded")
            same = (want["seqs"] == got["seqs"]).all(axis=(1, 2))
            row.update(weights_s=weights_s, steps=want["steps"],
                       rows_with_equal_seqs=int(same.sum()), card=card)
            if not bf16 and not (same.all() and np.allclose(
                    got["logp"], want["logp"], atol=1e-5, rtol=5e-7)):
                ok = False
            del row["results"]
            print(json.dumps(row), flush=True)
        t0 = time.perf_counter()
        with Replicas(model, pool) as reps, Replicas(model, one) as alone:
            weights_s = time.perf_counter() - t0
            row = timed_path(
                "smiles2pv_fp32",
                lambda: predict_pv(model, ids, mask, device=dev).cpu().numpy(),
                lambda: predict_pv_rows(reps, ids, mask),
                lambda: predict_pv_rows(alone, ids, mask), args.pairs)
        err = float(np.abs(row["results"]["sharded"]
                           - row["results"]["unsharded"]).max())
        ok = ok and err <= 1e-5
        del row["results"]
        row.update(weights_s=weights_s, max_abs_diff=err, card=card)
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
