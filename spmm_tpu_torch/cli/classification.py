"""MoleculeNet classification fine-tune CLI (counterpart of
``spmm_tpu.cli.classification``; reference d_classification.py).

Datasets: bace / bbbp / lidi(DILI); metric: test AUROC at best-val epoch.

Run: python -m spmm_tpu_torch.cli.classification --name bbbp
         [--checkpoint <ref pretrain .ckpt>] [--data_dir DIR]
         [--output_dir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

from spmm_tpu_torch.configs import FinetuneConfig
from spmm_tpu_torch.data.datasets import load_bace_c, load_bbbp, load_dili

DATASETS = {
    "bace": (load_bace_c, ("BACEC_train.csv", "BACEC_valid.csv",
                           "BACEC_test.csv")),
    "bbbp": (load_bbbp, ("BBBP_train.csv", "BBBP_valid.csv", "BBBP_test.csv")),
    "lidi": (load_dili, ("lidi_train.csv", "lidi_ltkb.csv", "lidi_ltkb.csv")),
}


def main(argv=None):
    from spmm_tpu_torch.cli._common import seed_everything
    from spmm_tpu_torch.cli._finetune_driver import run_finetune
    from spmm_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--name", default="bbbp", choices=sorted(DATASETS))
    p.add_argument("--data_dir", default="data/4_MoleculeNet")
    p.add_argument("--seed", type=int, default=41)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--min_lr", type=float, default=5e-6)
    p.add_argument("--epoch", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=16)
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
                          batch_size_train=args.batch_size, step_size=50)
    return run_finetune("classification", train, valid, test, fcfg,
                        args.checkpoint, seed,
                        extended_metrics=(args.name == "lidi"),
                        output_dir=args.output_dir, device=dev)


if __name__ == "__main__":
    main()
