"""Reaction-prediction evaluation CLI (counterpart of
``spmm_tpu.cli.rxn_prediction``; reference d_rxn_prediction.py).

--mode forward (USPTO-480k tab-separated pairs) or retro (the USPTO-50k
pickle, needs RDKit); greedy decoding for --n_beam 1, per-source k-beam
(stop_count k**2) otherwise; metric: top-k canonical-SMILES exact-match
accuracy, written with the run's settings to ``<output_dir>/result.json``.
Reaction training (AdamW over ``rxn_loss``) is not ported yet (ROADMAP.md
queue 1, item 11), so ``--evaluate`` is required.

Run: python -m spmm_tpu_torch.cli.rxn_prediction --evaluate
         [--checkpoint <.ckpt>] [--mode forward] [--data_dir DIR]
         [--n_beam 5] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

from spmm_tpu_torch.chem.featurizer import canonicalize


def load_rxn_checkpoint(model, path: str):
    """Load ``--checkpoint`` into an ``Rxn`` model, in place (reference
    d_rxn_prediction.py:160-168; spmm_tpu/cli/rxn_prediction.py:39-57):

      a reaction state (``text_encoder2.`` keys, e.g. a saved ``Rxn``
        state dict)              -> loaded strictly, decoder and encoder;
      a reference SPMM pretrain state -> its text encoder initialises the
        reactant encoder (``load_encoder_from_pretrain``)."""
    from spmm_tpu_torch.checkpoint.convert import load_reference_checkpoint
    from spmm_tpu_torch.models.rxn import load_encoder_from_pretrain

    state = load_reference_checkpoint(path)
    if any(k.startswith("text_encoder2.") for k in state):
        model.load_state_dict(state, strict=True)
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
             device=None) -> float:
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
                               device=device)
    else:
        cands = predict_beam(model, tok, sources, k=n_beam,
                             batch_size=batch_size, device=device)
    return metric_eval(refs, cands)


def main(argv=None):
    from spmm_tpu_torch.cli._common import make_tokenizer, seed_everything
    from spmm_tpu_torch.data.datasets import USPTODataset, USPTORetroDataset
    from spmm_tpu_torch.models.rxn import Rxn
    from spmm_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--output_dir", default="./output/RXN")
    p.add_argument("--checkpoint", default=None,
                   help="reference pretrain .ckpt, or a reaction state dict")
    p.add_argument("--mode", default="forward", choices=["forward", "retro"])
    p.add_argument("--data_dir", default="./data/6_RXNprediction")
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--n_beam", type=int, default=5)
    p.add_argument("--batch_size_eval", type=int, default=32,
                   help="decode batch, greedy and beam")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not args.evaluate:
        p.error("reaction training is not ported yet (ROADMAP.md queue 1, "
                "item 11); pass --evaluate")

    dev = resolve_device(args.device)
    seed = seed_everything(args.seed)
    tok = make_tokenizer()
    if args.mode == "forward":
        d = os.path.join(args.data_dir, "USPTO-480k")
        valid_ds = USPTODataset(os.path.join(d, "valid_parsed.txt"))
        test_ds = USPTODataset(os.path.join(d, "test_parsed.txt"))
    else:
        pkl = os.path.join(args.data_dir, "USPTO-50k", "uspto_50.pickle")
        valid_ds = USPTORetroDataset(pkl, "test")
        test_ds = USPTORetroDataset(pkl, "test")
    print(len(valid_ds), len(test_ds))

    model = Rxn.random_init(seed, device=dev)
    if args.checkpoint:
        load_rxn_checkpoint(model, args.checkpoint)

    t0 = time.time()
    print("VALIDATION")
    val = evaluate(model, tok, valid_ds, args.n_beam, args.batch_size_eval,
                   device=dev)
    print("Accuracy:", val)
    print("TEST")
    tst = evaluate(model, tok, test_ds, args.n_beam, args.batch_size_eval,
                   device=dev)
    print("Accuracy:", tst)
    print(f"Evaluation time {time.time() - t0:.1f}s")
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "result.json"), "w") as f:
        json.dump({"best_valid_acc": val, "best_test_acc": tst,
                   "epochs": [{"epoch": 0, "valid_acc": val,
                               "test_acc": tst}],
                   "steps": 0, "n_beam": args.n_beam, "mode": args.mode,
                   "device": str(dev)}, f, indent=1)


if __name__ == "__main__":
    main()
