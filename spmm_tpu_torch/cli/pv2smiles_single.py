"""PV -> SMILES single-query generation CLI (counterpart of
``spmm_tpu.cli.pv2smiles_single``; reference d_pv2smiles_single.py).

The property condition comes from a CSV of ``property,input_value`` rows
(reference p2s_input.csv); the properties it does not list are masked.
``n_generate`` k-beam searches over that one condition (bf16 decoder).
Metrics: normalized RMSE over the controlled properties (needs RDKit),
validity, uniqueness; the valid molecules are written to ``--output_file``
(reference d_pv2smiles_single.py:115-149).

Run: python -m spmm_tpu_torch.cli.pv2smiles_single --checkpoint <ref .ckpt>
         --input_csv examples/p2s_input.csv [--n_generate 1000] [--k 2]
         [--device cuda]
"""

from __future__ import annotations

import argparse
import csv
import random

import numpy as np

from spmm_tpu_torch.chem.featurizer import (
    HAS_RDKIT, calculate_property, canonicalize, is_valid_smiles)


def read_condition(path: str, stats):
    """CSV rows (property,input_value) -> (prop_input[53], prop_mask[53])."""
    prop_input = np.zeros(53, np.float32)
    prop_mask = np.ones(53, np.float32)
    with open(path) as f:
        for row in csv.DictReader(f):
            idx = stats.index_of(row["property"])
            prop_input[idx] = float(row["input_value"])
            prop_mask[idx] = 0.0
    return prop_input, prop_mask


def metric_eval(prop_input, cand, prop_mask, stats, out_file):
    """Reference metric_eval (d_pv2smiles_single.py:115-149); shuffles
    ``cand`` in place with the global ``random`` state, as the reference
    does."""
    random.shuffle(cand)
    valids, mse = [], []
    for s in cand:
        if not is_valid_smiles(s):
            continue
        if HAS_RDKIT:
            try:
                pv = calculate_property(s, stats)
            except ValueError:
                continue
            mse.append((stats.normalize(prop_input) - stats.normalize(pv)) ** 2)
        valids.append(s)
    if mse:
        rmse = np.sqrt(np.mean(np.stack(mse), axis=0))
        print("mean of controlled properties' normalized RMSE:",
              float(rmse[prop_mask == 0].mean()))
    else:
        print("normalized RMSE unavailable (RDKit required)")
    v = len(valids)
    print("validity:", v / max(len(cand), 1))
    canon = [canonicalize(s) or s for s in valids]
    print("uniqueness:", len(set(canon)) / max(v, 1))
    with open(out_file, "w") as w:
        for s in (canon if HAS_RDKIT else valids):
            w.write(s + "\n")
    print(f"Generated molecules are saved in '{out_file}'")


def main(argv=None):
    from spmm_tpu_torch.checkpoint.convert import load_spmm_checkpoint
    from spmm_tpu_torch.cli._common import (
        inference_devices, load_stats, make_tokenizer, seed_everything)
    from spmm_tpu_torch.inference.pv2smiles import generate_with_property
    from spmm_tpu_torch.models.spmm import SPMM
    from spmm_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True,
                   help="reference {'state_dict': ...} .ckpt")
    p.add_argument("--input_csv", default="p2s_input.csv")
    p.add_argument("--n_generate", type=int, default=1000)
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--stochastic", type=lambda s: s != "False", default=True)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--output_file", default="generated_molecules.txt")
    p.add_argument("--kv_fp8", action="store_true",
                   help="store the decode KV cache in float8_e4m3fn")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    seed = seed_everything(args.seed)
    tok = make_tokenizer()
    stats = load_stats()
    model = load_spmm_checkpoint(SPMM(), args.checkpoint).to(dev).eval()
    devices, device_batch = inference_devices(dev, 128)

    prop_input, prop_mask = read_condition(args.input_csv, stats)
    # masked entries carry the learned mask vector; their values are unused
    pv_norm = stats.normalize(prop_input)
    print(f"PV-to-SMILES generation in "
          f"{'stochastic' if args.stochastic else 'deterministic'} manner "
          f"with k={args.k}...")
    samples = generate_with_property(
        model, tok, pv_norm, prop_mask, n_generate=args.n_generate, k=args.k,
        stochastic=args.stochastic, seed=seed, device_batch=device_batch,
        kv_fp8=args.kv_fp8, device=dev, devices=devices)
    metric_eval(prop_input, samples, prop_mask, stats, args.output_file)


if __name__ == "__main__":
    main()
