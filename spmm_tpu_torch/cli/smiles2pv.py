"""SMILES -> property-vector generation CLI (counterpart of
``spmm_tpu.cli.smiles2pv``; reference d_smiles2pv.py).

Decodes the 53 properties of each input molecule and, given reference PVs
from a ``.npz`` property cache, reports the reference's metrics: mean
normalized RMSE and mean r^2 over the 53 properties (reference
d_smiles2pv.py:80-107).

Run: python -m spmm_tpu_torch.cli.smiles2pv --checkpoint <reference .ckpt>
         --input_file smiles.txt [--property_cache pv.npz]
         [--output_file out.txt] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

from spmm_tpu_torch.tokenizer import default_buckets


def pv_generate(model, tok, smiles_list, stats, batch_size: int = 128,
                bf16: bool = False, device=None, devices=None) -> np.ndarray:
    """Denormalized PVs [N, 53] of a list of SMILES strings (reference
    d_smiles2pv.py:39-57): batches of ``batch_size``, each padded to the
    smallest of ``default_buckets(100)`` that holds it.  With ``devices``
    each batch is padded to ``batch_size`` rows and split over them
    (``batch_size`` must divide over them), as JAX's ``mesh=``."""
    from spmm_tpu_torch.inference.smiles2pv import (
        cast_params_bf16, predict_pv, predict_pv_rows)
    from spmm_tpu_torch.parallel.replicas import Replicas, pad_rows

    if bf16:
        model = cast_params_bf16(model)
    replicas = None if devices is None else Replicas(model, devices)
    out = []
    try:
        if replicas is not None:
            replicas.check_batch(batch_size)
        for start in range(0, len(smiles_list), batch_size):
            chunk = smiles_list[start: start + batch_size]
            texts = [s if s.startswith("[CLS]") else "[CLS]" + s
                     for s in chunk]
            ids, mask = tok.encode_batch(texts, max_len=100,
                                         buckets=default_buckets(100))
            if replicas is None:
                preds = predict_pv(model, ids, mask,
                                   device=device).cpu().numpy()
            else:
                ids, mask = pad_rows(ids, mask, batch_size, tok.cls_token_id)
                preds = predict_pv_rows(replicas, ids, mask)[:len(chunk)]
            out.append(stats.denormalize(preds))
    finally:
        if replicas is not None:
            replicas.close()
    return np.concatenate(out)


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Coefficient of determination, as sklearn.metrics.r2_score gives it
    for one target (a constant target scores 1.0 when predicted exactly,
    else 0.0)."""
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    num = np.sum((y_true - y_pred) ** 2)
    den = np.sum((y_true - y_true.mean()) ** 2)
    if den == 0.0:
        return 1.0 if num == 0.0 else 0.0
    return float(1.0 - num / den)


def metric_eval(ref_norm: np.ndarray, cand_norm: np.ndarray, stats):
    """Reference metric_eval (d_smiles2pv.py:80-107); returns (mean
    normalized RMSE, mean r^2)."""
    r = stats.denormalize(ref_norm)
    c = stats.denormalize(cand_norm)
    n_rmse = np.sqrt(np.mean((ref_norm - cand_norm) ** 2, axis=0))
    print("mean of 53 properties' normalized RMSE:", float(n_rmse.mean()))
    r2 = np.array([r2_score(r[:, i], c[:, i]) for i in range(r.shape[1])])
    print("mean r^2 coefficient of determination:", float(r2.mean()))
    return float(n_rmse.mean()), float(r2.mean())


def main(argv=None):
    from spmm_tpu_torch.checkpoint.convert import load_spmm_checkpoint
    from spmm_tpu_torch.chem.featurizer import HAS_RDKIT, canonicalize
    from spmm_tpu_torch.cli._common import (
        inference_devices, load_stats, make_tokenizer, seed_everything)
    from spmm_tpu_torch.data.datasets import PretrainDataset
    from spmm_tpu_torch.models.spmm import SPMM
    from spmm_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True,
                   help="reference {'state_dict': ...} .ckpt")
    p.add_argument("--input_file", required=True)
    p.add_argument("--property_cache", default=None,
                   help=".npz with raw PVs aligned to input lines "
                        "(needed for the metrics)")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 weights/activations (fp32 LayerNorm, "
                        "scores and softmax)")
    p.add_argument("--output_file", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    seed_everything(args.seed)
    dev = resolve_device(args.device)
    tok = make_tokenizer()
    stats = load_stats()
    model = load_spmm_checkpoint(SPMM(), args.checkpoint).to(dev).eval()
    devices, args.batch_size = inference_devices(dev, args.batch_size)

    print("SMILES-to-PV generation...")
    if args.property_cache:
        ds = PretrainDataset(args.input_file,
                             property_cache=args.property_cache)
        refs, texts = zip(*(ds[i] for i in range(len(ds))))
        cand_denorm = pv_generate(model, tok, list(texts), stats,
                                  args.batch_size, bf16=args.bf16, device=dev,
                                  devices=devices)
        metric_eval(np.stack(refs), stats.normalize(cand_denorm), stats)
    else:
        with open(args.input_file) as f:
            smiles = [line.strip() for line in f if line.strip()]
        smiles = [canonicalize(s) or s for s in smiles]
        cand_denorm = pv_generate(model, tok, smiles, stats, args.batch_size,
                                  bf16=args.bf16, device=dev, devices=devices)
        print("no property cache: skipping metrics"
              + ("" if HAS_RDKIT else " (RDKit is not installed)"))

    if args.output_file:
        np.savetxt(args.output_file, cand_denorm, fmt="%.6f")
        print("predictions saved to", args.output_file)
    print("SMILES-to-PV generation done")


if __name__ == "__main__":
    main()
