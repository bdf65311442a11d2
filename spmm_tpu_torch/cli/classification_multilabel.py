"""Multi-label classification fine-tune CLI (counterpart of
``spmm_tpu.cli.classification_multilabel``; reference
d_classification_multilabel.py).

Datasets: clintox (2 labels) / sider (27 labels); metric: macro AUROC.

Run: python -m spmm_tpu_torch.cli.classification_multilabel --name clintox
         [--checkpoint <ref pretrain .ckpt>] [--data_dir DIR]
         [--output_dir DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

from spmm_tpu_torch.configs import FinetuneConfig
from spmm_tpu_torch.data.datasets import load_clintox, load_sider

DATASETS = {
    "clintox": (load_clintox, ("clintox_train.csv", "clintox_valid.csv",
                               "clintox_test.csv")),
    "sider": (load_sider, ("sider_train.csv", "sider_valid.csv",
                           "sider_test.csv")),
}


def main(argv=None):
    from spmm_tpu_torch.cli._common import seed_everything
    from spmm_tpu_torch.cli._finetune_driver import run_finetune
    from spmm_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--name", default="clintox", choices=sorted(DATASETS))
    p.add_argument("--data_dir", default="data/4_MoleculeNet")
    p.add_argument("--seed", type=int, default=42)
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
    return run_finetune("multilabel", train, valid, test, fcfg,
                        args.checkpoint, seed, n_output=train.n_output,
                        output_dir=args.output_dir, device=dev)


if __name__ == "__main__":
    main()
