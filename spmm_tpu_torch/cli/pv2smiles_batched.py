"""PV -> SMILES batched / file-mode generation CLI (counterpart of
``spmm_tpu.cli.pv2smiles_batched``; reference d_pv2smiles_batched.py).

Reads each input molecule's PV from a property cache, decodes one
deterministic k-beam per molecule (stop_count=k, the reference's k**1
quirk; bf16 decoder), and reports normalized RMSE against the source
molecule (needs RDKit), validity, uniqueness and, given a corpus, novelty.
The reference's main() ignores --input_file for a hard-coded path
(d_pv2smiles_batched.py:122-123); here the flag is honoured.

Run: python -m spmm_tpu_torch.cli.pv2smiles_batched --checkpoint <ref .ckpt>
         --input_file smiles.txt --property_cache pv.npz [--k 2]
         [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

from spmm_tpu_torch.chem.featurizer import (
    HAS_RDKIT, calculate_property, canonicalize, is_valid_smiles)


def novelty(valids, corpus_path):
    """Fraction of unique valid molecules absent from a corpus (the
    reference's commented-out novelty block, d_pv2smiles_batched.py:94-103)."""
    with open(corpus_path) as f:
        corpus = {line.strip() for line in f}
    uniq = {canonicalize(s) or s for s in valids}
    if not uniq:
        return 0.0
    return sum(1 for s in uniq if s not in corpus) / len(uniq)


def metric_eval(refs, cands, stats, out_file, novelty_corpus=None):
    """Reference metric_eval (d_pv2smiles_batched.py:62-107)."""
    valids, n_mse = [], []
    for ref, cand in zip(refs, cands):
        if not is_valid_smiles(cand):
            continue
        if HAS_RDKIT:
            try:
                pv_r = calculate_property(ref, stats)
                pv_c = calculate_property(cand, stats)
            except ValueError:
                continue
            n_mse.append((stats.normalize(pv_r) - stats.normalize(pv_c)) ** 2)
        valids.append(cand)
    if n_mse:
        n_rmse = np.sqrt(np.mean(np.stack(n_mse), axis=0))
        print("mean of controlled properties' normalized RMSE:",
              float(n_rmse.mean()))
    else:
        print("normalized RMSE unavailable (RDKit required)")
    v = len(valids)
    print("validity:", v / max(len(cands), 1))
    canon = [canonicalize(s) or s for s in valids]
    print("uniqueness:", len(set(canon)) / max(v, 1))
    if novelty_corpus:
        print("novelty:", novelty(valids, novelty_corpus))
    with open(out_file, "w") as w:
        for s in valids:
            w.write(s + "\n")
    print(f"Generated molecules are saved in '{out_file}'")


def main(argv=None):
    from spmm_tpu_torch.checkpoint.convert import load_spmm_checkpoint
    from spmm_tpu_torch.cli._common import (
        inference_devices, load_stats, make_tokenizer, seed_everything)
    from spmm_tpu_torch.data.datasets import PretrainDataset
    from spmm_tpu_torch.inference.pv2smiles import generate_batched
    from spmm_tpu_torch.models.spmm import SPMM
    from spmm_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True,
                   help="reference {'state_dict': ...} .ckpt")
    p.add_argument("--input_file", required=True)
    p.add_argument("--property_cache", required=True,
                   help=".npz with raw PVs aligned to the input lines")
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--stochastic", type=lambda s: s == "True", default=False)
    p.add_argument("--data_range", type=int, nargs=2, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--output_file", default="generated_molecules.txt")
    p.add_argument("--kv_fp8", action="store_true",
                   help="store the decode KV cache in float8_e4m3fn")
    p.add_argument("--novelty_corpus", default=None,
                   help="corpus file to compute novelty against")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    seed = seed_everything(args.seed)
    tok = make_tokenizer()
    stats = load_stats()
    model = load_spmm_checkpoint(SPMM(), args.checkpoint).to(dev).eval()
    devices, device_batch = inference_devices(dev, 128)

    ds = PretrainDataset(args.input_file, property_cache=args.property_cache,
                         data_range=args.data_range)
    pvs, sources = [], []
    for i in range(len(ds)):
        pv, text = ds[i]
        pvs.append(pv)
        sources.append(text.replace("[CLS]", ""))
    print(f"PV-to-SMILES generation in "
          f"{'stochastic' if args.stochastic else 'deterministic'} manner "
          f"with k={args.k}...")
    cands = generate_batched(model, tok, np.stack(pvs), k=args.k,
                             stochastic=args.stochastic, seed=seed,
                             device_batch=device_batch, kv_fp8=args.kv_fp8,
                             device=dev, devices=devices)
    metric_eval(sources, cands, stats, args.output_file,
                novelty_corpus=args.novelty_corpus)


if __name__ == "__main__":
    main()
