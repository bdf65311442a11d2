"""Reaction-prediction fine-tune and evaluation CLI (counterpart of
``spmm_tpu.cli.rxn_prediction``; reference d_rxn_prediction.py).

--mode forward (USPTO-480k tab-separated pairs) or retro (the USPTO-50k
pickle, needs RDKit).  Without --evaluate it trains (``make_rxn_step``:
AdamW over ``rxn_loss`` with dropout, the reference cosine schedule with
one warmup epoch in chunks of 100 steps) and, after each epoch, decodes the
validation and test sets; the best-validation ``Rxn`` state is saved to
``<output_dir>/checkpoint_best.pt``, which ``--checkpoint`` reads back.
With --evaluate it decodes once.  Greedy decoding for --n_beam 1,
per-source k-beam (stop_count k**2) otherwise; metric: top-k
canonical-SMILES exact-match accuracy.  Per-step loss goes to
``<output_dir>/metrics.jsonl``, the outcome with the run's settings to
``<output_dir>/result.json``.

Run: python -m spmm_tpu_torch.cli.rxn_prediction [--evaluate]
         [--checkpoint <.ckpt>] [--mode forward] [--data_dir DIR]
         [--n_beam 5] [--epoch 300] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from spmm_tpu_torch.chem.featurizer import canonicalize


def load_rxn_checkpoint(model, path: str):
    """Load ``--checkpoint`` into an ``Rxn`` model, in place (reference
    d_rxn_prediction.py:160-168; spmm_tpu/cli/rxn_prediction.py:39-57):

      a reaction state (``text_encoder2.`` keys, e.g. a saved ``Rxn``
        state dict, or one the reference saved, whose ``position_ids``
        buffers are dropped) -> loaded strictly, decoder and encoder;
      a reference SPMM pretrain state -> its text encoder initialises the
        reactant encoder (``load_encoder_from_pretrain``)."""
    from spmm_tpu_torch.checkpoint.convert import (
        drop_position_ids, load_reference_checkpoint)
    from spmm_tpu_torch.models.rxn import load_encoder_from_pretrain

    state = load_reference_checkpoint(path)
    if any(k.startswith("text_encoder2.") for k in state):
        model.load_state_dict(drop_position_ids(state), strict=True)
        return model
    return load_encoder_from_pretrain(model, state)


def metric_eval(refs: list[str], cands) -> float:
    """Canonical exact-match accuracy, top-k any-hit (reference
    d_rxn_prediction.py:126-145)."""
    correct = 0
    for r, c in zip(refs, cands):
        rc = canonicalize(r)
        if rc is None:
            continue
        cs = [c] if isinstance(c, str) else c
        if any(canonicalize(cand) == rc for cand in cs):
            correct += 1
    return correct / max(len(refs), 1)


def evaluate(model, tok, dataset, n_beam: int, batch_size: int,
             device=None, devices=None) -> float:
    """Decode every source of ``dataset`` (bf16 decoder) and score it
    against its target: greedy for n_beam 1, else k-beam with k = n_beam
    over whole batches (the reference decodes its beams one source at a
    time)."""
    from spmm_tpu_torch.inference.rxn import predict_beam, predict_greedy

    sources, refs = [], []
    for i in range(len(dataset)):
        src, tgt = dataset[i]
        sources.append(src.replace("[CLS]", ""))
        refs.append(tgt.replace("[CLS]", ""))
    if n_beam == 1:
        cands = predict_greedy(model, tok, sources, batch_size=batch_size,
                               device=device, devices=devices)
    else:
        cands = predict_beam(model, tok, sources, k=n_beam,
                             batch_size=batch_size, device=device,
                             devices=devices)
    return metric_eval(refs, cands)


def save_rxn_checkpoint(model, path: str) -> None:
    """The reference-named ``Rxn`` state as ``{"state_dict": ...}`` on the
    CPU, which ``load_rxn_checkpoint`` loads back strictly."""
    torch.save({"state_dict": {k: v.detach().cpu()
                               for k, v in model.state_dict().items()}}, path)


def main(argv=None):
    from spmm_tpu_torch.cli._common import (
        inference_devices, make_tokenizer, seed_everything)
    from spmm_tpu_torch.configs import FinetuneConfig
    from spmm_tpu_torch.data.datasets import USPTODataset, USPTORetroDataset
    from spmm_tpu_torch.data.pipeline import batch_pairs, prefetch
    from spmm_tpu_torch.models.rxn import Rxn
    from spmm_tpu_torch.training.finetune import make_rxn_step
    from spmm_tpu_torch.utils.device import fp32_matmuls, resolve_device
    from spmm_tpu_torch.utils.logging import MetricLogger

    p = argparse.ArgumentParser()
    p.add_argument("--output_dir", default="./output/RXN")
    p.add_argument("--checkpoint", default=None,
                   help="reference pretrain .ckpt, or a reaction state dict")
    p.add_argument("--mode", default="forward", choices=["forward", "retro"])
    p.add_argument("--data_dir", default="./data/6_RXNprediction")
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--n_beam", type=int, default=5)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--min_lr", type=float, default=5e-6)
    p.add_argument("--epoch", type=int, default=300)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--batch_size_eval", type=int, default=32,
                   help="decode batch, greedy and beam")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    fp32_matmuls()
    seed = seed_everything(args.seed)
    tok = make_tokenizer()
    train_ds = None
    if args.mode == "forward":
        d = os.path.join(args.data_dir, "USPTO-480k")
        if not args.evaluate:
            train_ds = USPTODataset(os.path.join(d, "train_parsed.txt"),
                                    augment=True)
        valid_ds = USPTODataset(os.path.join(d, "valid_parsed.txt"))
        test_ds = USPTODataset(os.path.join(d, "test_parsed.txt"))
    else:
        pkl = os.path.join(args.data_dir, "USPTO-50k", "uspto_50.pickle")
        if not args.evaluate:
            train_ds = USPTORetroDataset(pkl, "train", augment=True)
        valid_ds = USPTORetroDataset(pkl, "test")
        test_ds = USPTORetroDataset(pkl, "test")
    print(len(train_ds or ()), len(valid_ds), len(test_ds))

    model = Rxn.random_init(seed, device=dev)
    if args.checkpoint:
        load_rxn_checkpoint(model, args.checkpoint)
    if train_ds is not None:
        fcfg = FinetuneConfig(lr=args.lr, min_lr=args.min_lr,
                              epochs=args.epoch,
                              batch_size_train=args.batch_size,
                              warmup_epochs=1, step_size=100)
        steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
        _, step = make_rxn_step(model, fcfg, steps_per_epoch)
        generator = torch.Generator(device=dev).manual_seed(seed)

    devices, eval_bs = inference_devices(dev, args.batch_size_eval)
    best_valid, best_test = 0.0, 0.0
    global_step = 0
    t0 = time.time()
    os.makedirs(args.output_dir, exist_ok=True)
    logger = MetricLogger(os.path.join(args.output_dir, "metrics.jsonl"))
    epochs_out = []
    try:
        for epoch in range(args.epoch):
            if train_ds is not None:
                print("TRAIN", epoch)
                for b in prefetch(batch_pairs(tok, train_ds, args.batch_size,
                                              shuffle=True,
                                              seed=seed + epoch)):
                    batch = {k: torch.as_tensor(v, device=dev)
                             for k, v in b.items() if k != "n_real"}
                    metrics = step(global_step, batch, generator)
                    global_step += 1
                    logger.log(global_step, metrics)
            print("VALIDATION")
            val = evaluate(model, tok, valid_ds, args.n_beam, eval_bs,
                           device=dev, devices=devices)
            print("Accuracy:", val)
            print("TEST")
            tst = evaluate(model, tok, test_ds, args.n_beam, eval_bs,
                           device=dev, devices=devices)
            print("Accuracy:", tst)
            epochs_out.append({"epoch": epoch, "valid_acc": val,
                               "test_acc": tst})
            if args.evaluate:
                best_valid, best_test = val, tst
                break
            if val >= best_valid:
                print("SAVING...", tst)
                save_rxn_checkpoint(model, os.path.join(
                    args.output_dir, "checkpoint_best.pt"))
                best_valid, best_test = val, tst
    finally:
        logger.close()
    print(f"{'Evaluation' if args.evaluate else 'Training'} time "
          f"{time.time() - t0:.1f}s")
    print("test ACC of checkpoint with best val ACC:", best_test)
    with open(os.path.join(args.output_dir, "result.json"), "w") as f:
        json.dump({"best_valid_acc": best_valid, "best_test_acc": best_test,
                   "epochs": epochs_out, "steps": global_step,
                   "n_beam": args.n_beam, "mode": args.mode,
                   "device": str(dev)}, f, indent=1)


if __name__ == "__main__":
    main()
