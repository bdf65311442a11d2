"""SPMM pretraining CLI on one GPU (counterpart of ``spmm_tpu.cli.pretrain``;
reference SPMM_pretrain.py).

    python -m spmm_tpu_torch.cli.pretrain --data_path corpus.txt \\
        --property_cache corpus.pv.npz --output_dir ./Pretrain

One process and one device (the GPU unless ``--device cpu``), so the global
batch is ``--batch_size``.  The corpus is one SMILES per line; the
property cache is an ``.npz`` whose ``pv`` [N, 53] holds the raw property
vectors of those lines (the port computes no descriptors: it has no RDKit).
A checkpoint (``checkpoint.io``) is written to ``<output_dir>/step_<n>.pt``
every ``--save_every`` steps and at ``--max_steps``, and to ``final.pt``
after the last epoch; ``--resume`` reads one back, checks ``run_meta.json``
beside it and fast-forwards the data to the step it holds.  Each step's
dropout, property mask and hard negatives draw from a generator seeded from
``--seed`` and the step, so a resumed run draws what an uninterrupted one
draws.  Every 50 steps it prints the losses, samples/s and, on the GPU,
MFU against the H100's peak for the dtype that runs (FLOPs counted over
the first step).

Not here yet: ``--zero1``, ``--bf16_moments`` and ``--async_save`` (ROADMAP
queue 1 item 2), ``--tp``, ``--fsdp`` and ``--sp`` (queue 1 item 5).
``--donate`` and ``--prng`` have no meaning in the port: PyTorch updates
the state in place, and randomness comes from ``torch.Generator``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from spmm_tpu_torch.checkpoint.io import restore_checkpoint, save_checkpoint
from spmm_tpu_torch.cli._common import make_tokenizer, seed_everything
from spmm_tpu_torch.configs import PretrainConfig, property_config, text_config
from spmm_tpu_torch.data.datasets import PretrainDataset
from spmm_tpu_torch.data.pipeline import batch_pretrain, prefetch
from spmm_tpu_torch.training.pretrain import (
    LOSS_KEYS, init_pretrain_state, make_pretrain_step, step_generator)
from spmm_tpu_torch.utils.device import resolve_device
from spmm_tpu_torch.utils.logging import MetricLogger
from spmm_tpu_torch.utils.profiling import (
    H100_PEAK_FLOPS, card_description, count_flops, mfu)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_path", required=True)
    p.add_argument("--property_cache", required=True,
                   help=".npz with 'pv' [N, 53]: the raw property vectors "
                        "of the corpus lines")
    p.add_argument("--resume", default=None,
                   help="a step_<n>.pt written by this CLI")
    p.add_argument("--output_dir", default="./Pretrain")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch_size", type=int, default=96)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--queue_size", type=int, default=36864)
    p.add_argument("--save_every", type=int, default=10000)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 encoder compute (reference: fp16 AMP)")
    p.add_argument("--remat", action="store_true",
                   help="objective+layer recomputation (memory for FLOPs)")
    p.add_argument("--accum", type=int, default=1,
                   help="gradient-accumulation microbatches per step "
                        "(in-batch negatives become microbatch-local)")
    p.add_argument("--metrics_log", default=None,
                   help="JSONL metrics path (default "
                        "<output_dir>/metrics.jsonl)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run there)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    seed = seed_everything(args.seed)
    tok = make_tokenizer()
    global_bs = args.batch_size
    if args.queue_size % global_bs:
        p.error("--queue_size must divide by --batch_size")
    ds = PretrainDataset(args.data_path, property_cache=args.property_cache)
    steps_per_epoch = len(ds) // global_bs
    if steps_per_epoch == 0:
        p.error(f"{len(ds)} lines make no batch of {global_bs}")
    print(f"#data: {len(ds)}  device: {dev}  batch: {global_bs}  "
          f"steps/epoch: {steps_per_epoch}")

    pcfg = PretrainConfig(batch_size=global_bs, epochs=args.epochs,
                          queue_size=args.queue_size, bf16_compute=args.bf16,
                          remat=args.remat)
    model = init_pretrain_state(seed, pcfg, text_config(), property_config(),
                                device=dev)
    opt, step_fn = make_pretrain_step(model, pcfg, steps_per_epoch,
                                      accum=args.accum)
    start_step = 0
    if args.resume:
        start_step = restore_checkpoint(args.resume, model, opt)
        print("resumed at step", start_step)
        _check_run_meta(args.resume, global_bs, seed)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "run_meta.json"), "w") as f:
        json.dump({"global_bs": global_bs, "seed": seed, "n_dev": 1,
                   "batch_size": global_bs}, f)
    peak = None
    if dev.type == "cuda":
        peak = H100_PEAK_FLOPS["bf16" if args.bf16 else "fp32"]
        print(f"MFU against {peak / 1e12:.0f} TFLOP/s "
              f"({'bf16' if args.bf16 else 'fp32'} peak of an H100) on "
              f"{card_description()}")

    start_epoch = min(start_step // steps_per_epoch, args.epochs)
    if args.resume and start_step:
        print(f"resume fast-forward: epoch {start_epoch}, "
              f"skipping {start_step % steps_per_epoch} batches")
    logger = MetricLogger(args.metrics_log
                          or os.path.join(args.output_dir, "metrics.jsonl"))
    try:
        _train_loop(args, model, opt, step_fn, tok, ds, logger, dev,
                    steps_per_epoch, start_epoch, start_step, seed, peak)
    finally:
        logger.close()


def _check_run_meta(resume: str, global_bs: int, seed: int) -> None:
    """The data fast-forward recomputes the position from the CURRENT seed
    and batch; a resume under other values lands on other samples with no
    error, so compare with the metadata written beside the checkpoint."""
    meta_path = os.path.join(os.path.dirname(os.path.abspath(resume)),
                             "run_meta.json")
    if not os.path.exists(meta_path):
        print(f"WARNING: no run_meta.json next to {resume}; cannot verify "
              "the resume uses the original batch size/seed",
              file=sys.stderr)
        return
    with open(meta_path) as f:
        meta = json.load(f)
    for key, cur in (("global_bs", global_bs), ("seed", seed), ("n_dev", 1)):
        if meta.get(key, cur) != cur:
            print(f"WARNING: resume {key}={cur} differs from the original "
                  f"run's {meta[key]} ({meta_path}): the data fast-forward "
                  "will land at a different position (duplicated/skipped "
                  "samples)", file=sys.stderr)


def _train_loop(args, model, opt, step_fn, tok, ds, logger, dev,
                steps_per_epoch, start_epoch, step, seed, peak):
    def save(name: str) -> None:
        save_checkpoint(os.path.join(args.output_dir, f"{name}.pt"), model,
                        opt, step)

    flops_per_step = None
    losses = []
    t0 = time.time()
    for epoch in range(start_epoch, args.epochs):
        skip = step % steps_per_epoch if epoch == start_epoch else 0
        for b in prefetch(batch_pretrain(
                tok, ds, args.batch_size, shuffle=True, seed=seed + epoch,
                skip_batches=skip), depth=4):
            batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
            gen = step_generator(seed, step, dev)
            if peak is not None and flops_per_step is None:
                metrics, flops_per_step = count_flops(
                    lambda: step_fn(step, batch, gen))
            else:
                metrics = step_fn(step, batch, gen)
            step += 1
            losses.append([float(metrics[k]) for k in LOSS_KEYS])
            logger.log(step, {k: metrics[k] for k in
                              ("loss", *LOSS_KEYS, "lr", "skipped")})
            if step % 50 == 0:
                m = np.mean(losses[-50:], axis=0)
                dt = time.time() - t0
                util = mfu(flops_per_step, dt / 50, 1, peak) if peak else None
                util_s = f" mfu {util:.1%}" if util else ""
                print(f"step {step} lr {metrics['lr']:.2e} "
                      f"mlm {m[0]:.4f} mpm {m[1]:.4f} ita {m[2]:.4f} "
                      f"itm {m[3]:.4f} ({args.batch_size * 50 / dt:.1f} "
                      f"samples/s{util_s})")
                t0 = time.time()
            if step % args.save_every == 0:
                save(f"step_{step}")
            if args.max_steps and step >= args.max_steps:
                if step % args.save_every != 0:
                    save(f"step_{step}")
                return
        m = np.mean(losses[-1000:], axis=0)
        print(f"\n mean loss: {m[0]:.4f}, {m[1]:.4f}, {m[2]:.4f}, {m[3]:.4f}")
        losses.clear()
    save("final")


if __name__ == "__main__":
    main()
