"""MoleculeNet regression fine-tune CLI (counterpart of
``spmm_tpu.cli.regression``; reference d_regression.py).

Datasets: bace / lipo / esol / freesolv / clearance; metric: denormalized
test RMSE at best-val epoch (step_size 100 warmup chunks).

Run: python -m spmm_tpu_torch.cli.regression --name esol
         [--checkpoint <ref pretrain .ckpt>] [--data_dir DIR]
         [--output_dir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

from spmm_tpu_torch.configs import FinetuneConfig
from spmm_tpu_torch.data.datasets import (
    load_bace_r, load_clearance, load_esol, load_freesolv, load_lipo)

DATASETS = {
    "bace": (load_bace_r, ("BACER_train.csv", "BACER_valid.csv",
                           "BACER_test.csv")),
    "lipo": (load_lipo, ("LIPO_train.csv", "LIPO_valid.csv", "LIPO_test.csv")),
    "esol": (load_esol, ("ESOL_train.csv", "ESOL_valid.csv", "ESOL_test.csv")),
    "freesolv": (load_freesolv, ("freesolv_train.csv", "freesolv_valid.csv",
                                 "freesolv_test.csv")),
    "clearance": (load_clearance, ("Clearance_train.csv",
                                   "Clearance_valid.csv",
                                   "Clearance_test.csv")),
}


def main(argv=None):
    from spmm_tpu_torch.cli._common import seed_everything
    from spmm_tpu_torch.cli._finetune_driver import run_finetune
    from spmm_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--name", default="bace", choices=sorted(DATASETS))
    p.add_argument("--data_dir", default="data/4_MoleculeNet")
    p.add_argument("--seed", type=int, default=40)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--min_lr", type=float, default=3e-6)
    p.add_argument("--epoch", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--output_dir", default=None,
                   help="also write metrics.jsonl + result.json here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    seed = seed_everything(args.seed)
    loader, files = DATASETS[args.name]
    train, valid, test = (loader(os.path.join(args.data_dir, f))
                          for f in files)
    print("DATASET:", args.name, len(train), len(valid), len(test))

    fcfg = FinetuneConfig(lr=args.lr, min_lr=args.min_lr, epochs=args.epoch,
                          batch_size_train=args.batch_size,
                          batch_size_test=16, step_size=100)
    return run_finetune("regression", train, valid, test, fcfg,
                        args.checkpoint, seed, n_output=1,
                        output_dir=args.output_dir, device=dev)


if __name__ == "__main__":
    main()
