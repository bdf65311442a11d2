"""Shared MoleculeNet fine-tune driver (classification / multilabel /
regression; counterpart of ``spmm_tpu.cli._finetune_driver``), mirroring the
reference training loops (d_classification.py:106-183, d_regression.py:
105-197, d_classification_multilabel.py).

Training runs the plain attention with dropout on (a ``torch.Generator``
seeded from the run's seed); evaluation runs under ``torch.no_grad()``
with every attention through kernel 2 (``attention_impl="kernel"``), as
``predict_pv`` does.  TF32 is off on both paths.  Metrics are numpy.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from spmm_tpu_torch.checkpoint.convert import load_reference_checkpoint
from spmm_tpu_torch.configs import FinetuneConfig, text_config
from spmm_tpu_torch.data.pipeline import batch_supervised, prefetch
from spmm_tpu_torch.models.downstream import (
    Downstream, downstream_forward, load_encoder_from_pretrain)
from spmm_tpu_torch.tokenizer import SmilesTokenizer
from spmm_tpu_torch.training.finetune import (
    auroc, macro_auroc, make_downstream_step, rmse)
from spmm_tpu_torch.utils.device import DeviceLike, fp32_matmuls, resolve_device
from spmm_tpu_torch.utils.logging import MetricLogger


@torch.no_grad()
def evaluate_scores(model: Downstream, tok: SmilesTokenizer, dataset,
                    batch_size: int = 64,
                    attention_impl: str = "kernel") -> tuple:
    """(predictions, targets) over an eval set, on the model's device.

    NO truncation at eval: the reference evaluates with padding='longest'
    and no max_length (d_classification.py:86), so a long molecule grows
    its bucket in steps of 32 and kernel 2 takes any number of keys;
    positions past the 512-row table read its last row, as JAX's gather
    clamps.  The last batch is padded to ``batch_size`` and cut back."""
    fp32_matmuls()
    dev = next(model.parameters()).device
    preds, targets = [], []
    for b in batch_supervised(tok, dataset.texts, dataset.targets,
                              batch_size, truncation=False, pad_batch=True):
        out = downstream_forward(
            model, torch.as_tensor(b["ids"], device=dev),
            torch.as_tensor(b["mask"], device=dev),
            attention_impl=attention_impl)
        preds.append(out.float().cpu().numpy()[: b["n_real"]])
        targets.append(np.asarray(b["target"])[: b["n_real"]])
    return np.concatenate(preds), np.concatenate(targets)


def _recall(targets: np.ndarray, hard: np.ndarray, label: int) -> float:
    """sklearn's recall_score for one label (0.0 where it has no rows)."""
    rows = targets == label
    return float((hard[rows] == label).mean()) if rows.any() else 0.0


def eval_metric(model: Downstream, tok: SmilesTokenizer, dataset, task: str,
                extended: bool = False, batch_size: int = 64) -> float:
    """AUROC (classification), macro AUROC (multilabel) or denormalized RMSE
    (regression).  ``extended`` also prints Acc/SP/SE for binary tasks — the
    DILI metrics whose gate in the reference can never fire
    (d_classification.py:99-101, isinstance check against the wrong type)."""
    preds, targets = evaluate_scores(model, tok, dataset,
                                     batch_size=batch_size)
    if task == "classification":
        scores = np.exp(preds[:, 1]) / np.exp(preds).sum(axis=1)
        if extended:
            hard = (scores > 0.5).astype(np.int32)
            print(f"Acc: {float((targets == hard).mean()):.4f}, "
                  f"SP: {_recall(targets, hard, 0):.4f}, "
                  f"SE: {_recall(targets, hard, 1):.4f}, "
                  f"AUROC: {auroc(targets, scores):.4f}")
        return auroc(targets, scores)
    if task == "multilabel":
        return macro_auroc(targets, 1.0 / (1.0 + np.exp(-preds)))
    # regression: both sides de-normalized with the train stats whether or
    # not the targets were normalized (the reference asymmetry,
    # d_regression.py:96-102)
    return rmse(preds[:, 0], targets, dataset.value_mean, dataset.value_std)


def run_finetune(
    task: str,
    train_ds,
    valid_ds,
    test_ds,
    fcfg: FinetuneConfig,
    checkpoint: Optional[str],
    seed: int,
    n_output: int = 2,
    extended_metrics: bool = False,
    cfg=None,
    output_dir: Optional[str] = None,
    device: DeviceLike = None,
) -> float:
    """Train ``fcfg.epochs`` epochs, evaluating valid and test after each;
    returns the test metric of the best-validation epoch.

    ``checkpoint`` is a reference-named torch state (a reference pretrain
    ``.ckpt``, or any ``{"state_dict": ...}`` with ``text_encoder.bert.*``
    keys): its text encoder's unimodal layers initialise the model.  The
    JAX driver also restores its own Orbax trees; the port has no
    counterpart of those.  ``output_dir`` also records per-step loss
    (metrics.jsonl) and the best-val outcome (result.json), as the JAX
    driver does (d_classification.py:139-151).  ``device`` defaults to the
    GPU and raises without one."""
    dev = resolve_device(device)
    tok = SmilesTokenizer()
    model = Downstream.random_init(seed, task, cfg or text_config(), n_output,
                                   device=dev)
    if checkpoint:
        print("LOADING PRETRAINED MODEL..")
        load_encoder_from_pretrain(model, load_reference_checkpoint(checkpoint))

    steps_per_epoch = max(len(train_ds) // fcfg.batch_size_train, 1)
    _, step = make_downstream_step(model, fcfg, steps_per_epoch)
    generator = torch.Generator(device=dev).manual_seed(seed)
    target_dtype = torch.int64 if task == "classification" else torch.float32

    higher_better = task != "regression"
    best_valid = -np.inf if higher_better else np.inf
    best_test = 0.0
    global_step = 0
    t0 = time.time()
    logger = None
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        logger = MetricLogger(os.path.join(output_dir, "metrics.jsonl"))
    epochs_out = []
    try:
        for epoch in range(fcfg.epochs):
            print("TRAIN", epoch)
            for b in prefetch(batch_supervised(
                    tok, train_ds.texts, train_ds.targets,
                    fcfg.batch_size_train, shuffle=True, seed=seed + epoch,
                    drop_last=True)):
                batch = {"ids": torch.as_tensor(b["ids"], device=dev),
                         "mask": torch.as_tensor(b["mask"], device=dev),
                         "target": torch.as_tensor(b["target"], device=dev,
                                                   dtype=target_dtype)}
                metrics = step(global_step, batch, generator)
                global_step += 1
                if logger:
                    logger.log(global_step, metrics)
            val = eval_metric(model, tok, valid_ds, task,
                              batch_size=fcfg.batch_size_test)
            tst = eval_metric(model, tok, test_ds, task,
                              extended=extended_metrics,
                              batch_size=fcfg.batch_size_test)
            print(f"VALID: {val:.4f}  TEST: {tst:.4f}")
            epochs_out.append({"epoch": epoch, "valid": val, "test": tst})
            if (higher_better and val >= best_valid) or \
               (not higher_better and val < best_valid):
                best_valid, best_test = val, tst
    finally:
        if logger:
            logger.close()
    print(f"Training time {time.time() - t0:.1f}s")
    print("Test metric of the checkpoint with best validation:", best_test)
    if output_dir:
        with open(os.path.join(output_dir, "result.json"), "w") as f:
            json.dump({"task": task, "best_valid": best_valid,
                       "best_test": best_test, "epochs": epochs_out,
                       "steps": global_step, "device": str(dev)}, f,
                      indent=1)
    return best_test
