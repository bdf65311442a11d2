"""SPMM pretraining CLI (counterpart of ``spmm_tpu.cli.pretrain``; reference
SPMM_pretrain.py), on one GPU or data-parallel over several.

    python -m spmm_tpu_torch.cli.pretrain --data_path corpus.txt \\
        --property_cache corpus.pv.npz --output_dir ./Pretrain
    python -m torch.distributed.run --nproc_per_node 8 \\
        -m spmm_tpu_torch.cli.pretrain --data_path ... --zero1
    python -m torch.distributed.run --nproc_per_node 8 \\
        -m spmm_tpu_torch.cli.pretrain --data_path ... --tp 2 --sp

Without ``torch.distributed.run``'s environment it is one process on one
device (the GPU unless ``--device cpu``) with no process group.  Under it
each rank is one process on ``cuda:LOCAL_RANK`` (NCCL), or on the CPU with
``--device cpu`` (gloo), and the step is data-parallel
(``training.pretrain.make_pretrain_step``).  ``--batch_size`` is per dp
rank, as in the JAX CLI, so the global batch is ``batch_size x dp`` (dp is
the world without ``--tp`` or ``--fsdp``); it must divide
``--queue_size``.  Every rank builds the same global batch from the seed
and keeps its dp rank's rows (``parallel.multihost.local_rows``).  Global
rank 0 alone prints, logs and writes checkpoints.

The corpus is one SMILES per line; the property cache is an ``.npz`` whose
``pv`` [N, 53] holds the raw property vectors of those lines (the port
computes no descriptors: it has no RDKit).  A checkpoint
(``checkpoint.io``, a plain AdamW's optimizer layout whatever the world
size or ``--zero1``) is written to ``<output_dir>/step_<n>.pt`` every
``--save_every`` steps and at ``--max_steps``, and to ``final.pt`` after
the last epoch; ``--async_save`` writes it from a background thread once
the state is on the host.  ``--resume`` reads one back, checks
``run_meta.json`` beside it and fast-forwards the data to the step it
holds.  Each chunk of a step's global batch draws its dropout, property
mask and hard negatives from a generator seeded from ``--seed``, the step
and the chunk, so a resumed run draws what an uninterrupted one draws, and
N ranks draw what one process at N times the ``--accum`` draws.  Every 50
steps it prints the losses, samples/s and, on the GPU, MFU against the
H100's peak for the dtype that runs (FLOPs counted per rank over the first
step).

``--tp T`` lays the ranks out as a dp x tp mesh (T adjacent ranks share
one dp rank's rows) with the model Megatron-sharded over tp
(``parallel.tp``); ``--sp`` adds sequence parallelism over the tp group
(``parallel.sp``); ``--fsdp F`` lays them out as dp x fsdp with every
parameter, twin and AdamW moment sharded over fsdp (``parallel.fsdp``).
As in the JAX CLI, ``--sp`` needs ``--tp`` > 1, ``--fsdp`` excludes
``--tp`` and ``--zero1``, ``--tp`` excludes ``--zero1``, and tp must divide
the heads and the MLP width.  ``--batch_size`` is per dp rank and the
global batch ``batch_size x dp``.  Checkpoints keep the plain layout, so a
tp or fsdp run resumes in one process and the reverse.

``--donate`` (an XLA buffer flag) and ``--prng`` have no meaning in the
port: PyTorch updates the state in place, and randomness comes from
``torch.Generator``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from spmm_tpu_torch.checkpoint.io import (
    AsyncSaver, restore_checkpoint, save_checkpoint)
from spmm_tpu_torch.cli._common import make_tokenizer, seed_everything
from spmm_tpu_torch.configs import PretrainConfig, property_config, text_config
from spmm_tpu_torch.data.datasets import PretrainDataset
from spmm_tpu_torch.data.pipeline import batch_pretrain, prefetch
from spmm_tpu_torch.parallel import multihost
from spmm_tpu_torch.parallel.fsdp import dp_fsdp_mesh
from spmm_tpu_torch.parallel.mesh import dp_rank, dp_size, is_main
from spmm_tpu_torch.parallel.tp import assert_tp_compatible, dp_tp_mesh
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
    p.add_argument("--batch_size", type=int, default=96,
                   help="per-rank batch (reference: 96 x 8 GPUs)")
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
    p.add_argument("--zero1", action="store_true",
                   help="shard the AdamW moments and, between steps, the "
                        "EMA twins over the ranks (ZeRO-1; the parameters "
                        "stay replicated); needs torch.distributed.run")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel factor: the ranks form a dp x tp "
                        "mesh and the blocks are Megatron-sharded over tp; "
                        "must divide the heads (12) and the MLP width")
    p.add_argument("--fsdp", type=int, default=1,
                   help="fully-sharded data parallelism: the ranks form a "
                        "dp x fsdp mesh and every parameter, twin and AdamW "
                        "moment is sharded over fsdp")
    p.add_argument("--sp", action="store_true",
                   help="sequence parallelism over the tp group (needs "
                        "--tp > 1)")
    p.add_argument("--bf16_moments", action="store_true",
                   help="bf16 AdamW first moment (optax mu_dtype)")
    p.add_argument("--async_save", action="store_true",
                   help="write checkpoints from a background thread once "
                        "the state is on the host")
    p.add_argument("--metrics_log", default=None,
                   help="JSONL metrics path (default "
                        "<output_dir>/metrics.jsonl)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run there)")
    args = p.parse_args(argv)

    if args.sp and args.tp <= 1:
        p.error("--sp needs --tp > 1 (sequence parallelism shards over the "
                "tensor-parallel group)")
    if args.fsdp > 1 and (args.tp > 1 or args.zero1):
        p.error("--fsdp excludes --tp and --zero1 (fsdp already shards the "
                "parameters, twins and optimizer state)")
    if args.tp > 1 and args.zero1:
        p.error("--tp excludes --zero1")
    if args.tp > 1:
        try:
            assert_tp_compatible(text_config(), args.tp)
            assert_tp_compatible(property_config(), args.tp)
        except ValueError as exc:
            p.error(str(exc))
    if multihost.launched():
        dev = multihost.initialize(args.device)
        if args.tp > 1:
            dp_tp_mesh(tp=args.tp)
        elif args.fsdp > 1:
            dp_fsdp_mesh(fsdp=args.fsdp)
    else:
        if args.zero1 or args.tp > 1 or args.fsdp > 1:
            p.error("--zero1, --tp and --fsdp shard over ranks: run under "
                    "torch.distributed.run")
        dev = resolve_device(args.device)
    try:
        with contextlib.redirect_stdout(sys.stdout if is_main() else None):
            _run(p, args, dev)
        if dist.is_initialized():
            dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(p, args, dev) -> None:
    t_start = time.perf_counter()
    world, rank = dp_size(), dp_rank()
    seed = seed_everything(args.seed)
    tok = make_tokenizer()
    global_bs = args.batch_size * world
    if args.queue_size % global_bs:
        p.error(f"--queue_size must divide by the global batch {global_bs}")
    if args.batch_size % args.accum:
        p.error("--batch_size must divide by --accum")
    ds = PretrainDataset(args.data_path, property_cache=args.property_cache)
    steps_per_epoch = len(ds) // global_bs
    if steps_per_epoch == 0:
        p.error(f"{len(ds)} lines make no batch of {global_bs}")
    print(f"#data: {len(ds)}  device: {dev}  ranks: {world}  global batch: "
          f"{global_bs}  steps/epoch: {steps_per_epoch}")

    pcfg = PretrainConfig(batch_size=args.batch_size, epochs=args.epochs,
                          queue_size=args.queue_size, bf16_compute=args.bf16,
                          remat=args.remat, bf16_moments=args.bf16_moments,
                          zero1=args.zero1)
    model = init_pretrain_state(seed, pcfg, text_config(), property_config(),
                                device=dev)
    opt, step_fn = make_pretrain_step(model, pcfg, steps_per_epoch,
                                      accum=args.accum, sp=args.sp)
    start_step = 0
    if args.resume:
        start_step = restore_checkpoint(args.resume, model, opt)
        print("resumed at step", start_step)
        if is_main():
            _check_run_meta(args.resume, global_bs, seed, world)
    if is_main():
        os.makedirs(args.output_dir, exist_ok=True)
        with open(os.path.join(args.output_dir, "run_meta.json"), "w") as f:
            json.dump({"global_bs": global_bs, "seed": seed, "n_dev": world,
                       "batch_size": args.batch_size}, f)
    peak = None
    if dev.type == "cuda":
        peak = H100_PEAK_FLOPS["bf16" if args.bf16 else "fp32"]
        print(f"MFU against {peak / 1e12:.0f} TFLOP/s "
              f"({'bf16' if args.bf16 else 'fp32'} peak of an H100) on "
              f"{card_description()}")

    print(f"state ready after {time.perf_counter() - t_start:.1f} s")
    start_epoch = min(start_step // steps_per_epoch, args.epochs)
    if args.resume and start_step:
        print(f"resume fast-forward: epoch {start_epoch}, "
              f"skipping {start_step % steps_per_epoch} batches")
    rows = (None if world == 1 else
            multihost.local_rows(global_bs, rank, world, args.accum))
    logger = MetricLogger(None if not is_main() else args.metrics_log
                          or os.path.join(args.output_dir, "metrics.jsonl"))
    saver = AsyncSaver() if args.async_save else None
    try:
        _train_loop(args, model, opt, step_fn, tok, ds, logger, saver, dev,
                    steps_per_epoch, start_epoch, start_step, seed, peak,
                    rows, world)
    finally:
        logger.close()
        if saver is not None:
            saver.close()


def _check_run_meta(resume: str, global_bs: int, seed: int,
                    world: int) -> None:
    """The data fast-forward recomputes the position from the CURRENT seed
    and global batch; a resume under other values lands on other samples
    with no error, so compare with the metadata written beside the
    checkpoint (a changed world size too, as the JAX CLI does)."""
    meta_path = os.path.join(os.path.dirname(os.path.abspath(resume)),
                             "run_meta.json")
    if not os.path.exists(meta_path):
        print(f"WARNING: no run_meta.json next to {resume}; cannot verify "
              "the resume uses the original batch size/seed",
              file=sys.stderr)
        return
    with open(meta_path) as f:
        meta = json.load(f)
    for key, cur in (("global_bs", global_bs), ("seed", seed),
                     ("n_dev", world)):
        if meta.get(key, cur) != cur:
            print(f"WARNING: resume {key}={cur} differs from the original "
                  f"run's {meta[key]} ({meta_path}): the data fast-forward "
                  "will land at a different position (duplicated/skipped "
                  "samples)", file=sys.stderr)


def _train_loop(args, model, opt, step_fn, tok, ds, logger, saver, dev,
                steps_per_epoch, start_epoch, step, seed, peak, rows, world):
    def save(name: str) -> None:
        path = os.path.join(args.output_dir, f"{name}.pt")
        t0 = time.perf_counter()
        if saver is None:
            save_checkpoint(path, model, opt, step)
            note = ""
        else:
            saver.wait()
            waited = time.perf_counter() - t0
            saver.save(path, model, opt, step)
            note = (f" ({waited:.3f} s of it waiting for the previous write;"
                    " this write goes on)")
        print(f"saved {name}.pt: the loop stood still "
              f"{time.perf_counter() - t0:.3f} s{note}")

    global_bs = args.batch_size * world
    flops_per_step = None
    losses = []
    t0 = time.time()
    for epoch in range(start_epoch, args.epochs):
        skip = step % steps_per_epoch if epoch == start_epoch else 0
        for b in prefetch(batch_pretrain(
                tok, ds, global_bs, shuffle=True, seed=seed + epoch,
                skip_batches=skip, rows=rows), depth=4):
            batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
            gens = functools.partial(step_generator, seed, step, dev)
            if peak is not None and flops_per_step is None:
                metrics, flops_per_step = count_flops(
                    lambda: step_fn(step, batch, gens))
            else:
                metrics = step_fn(step, batch, gens)
            step += 1
            losses.append([float(metrics[k]) for k in LOSS_KEYS])
            logger.log(step, {k: metrics[k] for k in
                              ("loss", *LOSS_KEYS, "lr", "skipped")})
            if step % 50 == 0:
                m = np.mean(losses[-50:], axis=0)
                dt = time.time() - t0
                # FLOPs are counted per rank; mfu wants the whole step's
                ranks = dist.get_world_size() if dist.is_initialized() else 1
                util = (mfu(flops_per_step * ranks, dt / 50, ranks, peak)
                        if peak else None)
                util_s = f" mfu {util:.1%}" if util else ""
                print(f"step {step} lr {metrics['lr']:.2e} "
                      f"mlm {m[0]:.4f} mpm {m[1]:.4f} ita {m[2]:.4f} "
                      f"itm {m[3]:.4f} ({global_bs * 50 / dt:.1f} "
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
