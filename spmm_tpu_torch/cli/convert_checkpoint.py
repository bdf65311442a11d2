"""Convert between reference SPMM checkpoints and the port's resumable
pretrain checkpoints (counterpart of ``spmm_tpu.cli.convert_checkpoint``).

  --as_pretrain_state  a reference ``.ckpt`` -> a checkpoint that
      ``python -m spmm_tpu_torch.cli.pretrain --resume <out>`` continues:
      weights, ``temp`` and the momentum twins from the file, its queues
      and ``queue_ptr`` (fresh ones if it has none), a fresh optimizer,
      step 0 (``training.pretrain.pretrain_state_from_reference``).
  --to_torch  a checkpoint of the port's pretraining -> a reference-
      loadable ``{"state_dict": ...}``: the key set of the JAX package's
      ``export_spmm_state_dict`` (the twins included; ``temp``, the queues
      and the optimizer not).

    python -m spmm_tpu_torch.cli.convert_checkpoint \\
        --torch_ckpt checkpoint_SPMM.ckpt --out resumable.pt --as_pretrain_state
    python -m spmm_tpu_torch.cli.convert_checkpoint \\
        --torch_ckpt Pretrain/final.pt --out exported.ckpt --to_torch

The JAX CLI's ``--verify`` (the golden gate against the reference code and
the released checkpoint) is not here: neither is in this repository.  Its
plain mode (an inference params tree) has no counterpart either: the
port's CLIs read a reference ``.ckpt`` directly.
"""

from __future__ import annotations

import argparse

import torch

from spmm_tpu_torch.checkpoint.convert import load_reference_checkpoint
from spmm_tpu_torch.checkpoint.io import save_checkpoint
from spmm_tpu_torch.configs import PretrainConfig, property_config, text_config
from spmm_tpu_torch.training.pretrain import (
    make_pretrain_optimizer, pretrain_state_from_reference)

# training state that is no module weight of the reference's export
NOT_EXPORTED = ("temp", "prop_queue", "text_queue", "queue_ptr")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--torch_ckpt", required=True, help="the checkpoint to read")
    p.add_argument("--out", required=True)
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--as_pretrain_state", action="store_true",
                      help="reference .ckpt -> resumable pretrain checkpoint")
    mode.add_argument("--to_torch", action="store_true",
                      help="pretrain checkpoint -> reference-loadable "
                           "{'state_dict': ...}")
    p.add_argument("--queue_size", type=int, default=36864)
    args = p.parse_args(argv)

    if args.to_torch:
        state = torch.load(args.torch_ckpt, map_location="cpu",
                           weights_only=True)["state_dict"]
        out = {k: v for k, v in state.items() if k not in NOT_EXPORTED}
        torch.save({"state_dict": out}, args.out)
        print(f"exported {len(out)} tensors -> {args.out} (torch state_dict)")
        return

    pcfg = PretrainConfig(queue_size=args.queue_size)
    model = pretrain_state_from_reference(
        load_reference_checkpoint(args.torch_ckpt), pcfg, text_config(),
        property_config(), device="cpu")
    save_checkpoint(args.out, model, make_pretrain_optimizer(model, pcfg), 0)
    n = sum(p.numel() for p in model.parameters())
    print(f"converted {n:,} parameters -> {args.out} (resumable, step 0)")


if __name__ == "__main__":
    main()
