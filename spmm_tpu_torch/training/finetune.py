"""Fine-tuning steps and metrics for MoleculeNet and reaction prediction
(counterpart of ``spmm_tpu.training.finetune``).

Mirrors the reference drivers (d_classification.py:52-103, d_regression.py:
52-102, d_classification_multilabel.py:50-91, d_rxn_prediction.py:27-52):
AdamW(wd=0.02) over all params, no grad clipping, reference cosine schedule
with epoch-0 warmup chunks (step_size 50 for classification, 100 for
regression/rxn), best-validation model selection.

The optimizer is ``torch.optim.AdamW(betas=(0.9, 0.999), eps=1e-8)``, whose
update ``p - lr * (adam + wd * p)`` is ``optax.adamw``'s arithmetic.  Two
points keep the parameters equal to JAX's step for step:

  - every gradient is a zero tensor, not None, before each backward: optax
    decays every leaf, also those the loss does not reach (the reaction
    encoder's MLM head ``text_encoder2.cls``), and moves their moments,
    where AdamW skips a parameter whose ``.grad`` is None;
  - tied weights are one ``Parameter`` (the LM head's decoder weight is the
    word table, ``cls.predictions.bias`` the decoder bias):
    ``model.parameters()`` lists each once and autograd sums both uses, as
    JAX's tree has one leaf.

The step writes ``schedule(global_step)`` into the param group before
``step()``, as ``optax.inject_hyperparams`` does.  Metrics are numpy: the
card's machine has no sklearn.

Under a process-wide ('dp', 'tp') mesh (``parallel.mesh``) the MoleculeNet
step is JAX's step on its dp x tp mesh (tests/test_tensor_parallel.py:
96-143): the truncated encoder is laid out by ``parallel.tp.apply_tp``, each
dp rank trains on its own rows (tp peers on the same ones), its loss is
backpropagated over the dp size and the gradients are summed over the dp
group as one flat buffer, and AdamW updates each rank's local shards
(``training.optim.AdamW``: the card's torch refuses foreach lists that mix
DTensors and tensors).  Without a mesh the step is the one-process step.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from spmm_tpu_torch.configs import FinetuneConfig
from spmm_tpu_torch.models.downstream import (
    Downstream, downstream_forward, downstream_loss)
from spmm_tpu_torch.models.rxn import Rxn, rxn_loss
from spmm_tpu_torch.parallel import mesh as _mesh
from spmm_tpu_torch.parallel.mesh import all_reduce_flat, local_tensor
from spmm_tpu_torch.training.optim import AdamW
from spmm_tpu_torch.training.schedules import reference_cosine_schedule
from spmm_tpu_torch.utils.device import fp32_matmuls

Tensor = torch.Tensor


def make_finetune_optimizer(model: torch.nn.Module,
                            fcfg: FinetuneConfig) -> torch.optim.Optimizer:
    """AdamW over every parameter (each tied one once); the lr is set per
    step.  ``torch.optim.AdamW``, or the port's ``training.optim.AdamW``
    (local shards) where the model holds a DTensor."""
    params = list(model.parameters())
    cls = (AdamW if any(isinstance(p, DTensor) for p in params)
           else torch.optim.AdamW)
    return cls(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
               weight_decay=fcfg.weight_decay)


def _schedule(fcfg: FinetuneConfig, steps_per_epoch: int):
    return reference_cosine_schedule(
        fcfg.lr, fcfg.min_lr, fcfg.warmup_lr, fcfg.epochs,
        fcfg.warmup_epochs, steps_per_epoch, step_size=fcfg.step_size)


def _step(opt: torch.optim.Optimizer, lr: float,
          loss_fn: Callable[[], Tensor],
          dp: Optional[dist.ProcessGroup] = None) -> Tensor:
    """Zeroed (not None) gradients, backward, lr into the group, step.
    Over a data-parallel group ``dp`` each rank's loss is backpropagated
    over its size and the gradients and the loss are summed over it."""
    params = [p for group in opt.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            p.grad.zero_()
    loss = loss_fn()
    if dp is not None:
        loss = loss / dist.get_world_size(dp)
    loss.backward()
    loss = loss.detach()
    if dp is not None:
        all_reduce_flat([local_tensor(p.grad) for p in params], dp)
        dist.all_reduce(loss, group=dp)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    return loss


def make_downstream_step(model: Downstream, fcfg: FinetuneConfig,
                         steps_per_epoch: int):
    """(optimizer, step) for ``model``'s task; ``step(global_step, batch,
    generator=None)`` trains on one batch {"ids", "mask", "target"} of
    tensors on the model's device and returns {"loss": tensor, "lr": float}.
    Dropout is on where a generator is passed (the JAX step's rng).

    Under a ('dp', 'tp') mesh the model is laid out by ``parallel.tp.
    apply_tp`` here (unless it already is), ``batch`` holds this dp rank's
    rows (``parallel.multihost.process_rows`` of the global batch, as many
    on every rank) and the loss returned is the global batch's."""
    fp32_matmuls()
    dp = None
    if _mesh.get_mesh() is not None:
        if _mesh.minor_dim() != _mesh.TP_AXIS:
            raise ValueError("a fine-tune step shards over a ('dp', 'tp') "
                             f"mesh, not a {_mesh.minor_dim()!r} one")
        if not any(isinstance(p, DTensor) for p in model.parameters()):
            from spmm_tpu_torch.parallel import tp

            tp.apply_tp(model)
        dp = _mesh.dp_group()
    opt = make_finetune_optimizer(model, fcfg)
    schedule = _schedule(fcfg, steps_per_epoch)

    def step(global_step: int, batch: dict,
             generator: Optional[torch.Generator] = None) -> dict:
        lr = schedule(global_step)
        loss = _step(opt, lr, lambda: downstream_loss(
            model, batch["ids"], batch["mask"], batch["target"], generator),
            dp)
        return {"loss": loss, "lr": lr}

    return opt, step


def make_rxn_step(model: Rxn, fcfg: FinetuneConfig, steps_per_epoch: int):
    """(optimizer, step) of reaction training; ``step(global_step, batch,
    generator=None)`` on {"src_ids", "src_mask", "tgt_ids", "tgt_mask"}.
    The JAX step always trains with dropout (deterministic=False): pass a
    generator."""
    fp32_matmuls()
    opt = make_finetune_optimizer(model, fcfg)
    schedule = _schedule(fcfg, steps_per_epoch)

    def step(global_step: int, batch: dict,
             generator: Optional[torch.Generator] = None) -> dict:
        lr = schedule(global_step)
        loss = _step(opt, lr, lambda: rxn_loss(
            model, batch["src_ids"], batch["src_mask"], batch["tgt_ids"],
            batch["tgt_mask"], generator))
        return {"loss": loss, "lr": lr}

    return opt, step


# --------------------------------------------------------------------------- #
# metrics (reference metric harnesses, SURVEY §6), in numpy
# --------------------------------------------------------------------------- #


def auroc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Binary AUROC, equal to sklearn's ``roc_auc_score`` (which the
    reference uses, d_classification.py:103): the rank statistic with tied
    scores given their average rank.  The greater of the two label values is
    the positive class; one class only raises ValueError, as sklearn does."""
    y = np.asarray(labels).ravel()
    s = np.asarray(scores, np.float64).ravel()
    classes = np.unique(y)
    if len(classes) != 2:
        raise ValueError("Only one class present in y_true. ROC AUC score "
                         "is not defined in that case.")
    pos = y == classes[1]
    _, inverse, counts = np.unique(s, return_inverse=True, return_counts=True)
    ranks = (np.cumsum(counts) - (counts - 1) / 2.0)[inverse]
    n_pos = int(pos.sum())
    n_neg = len(y) - n_pos
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def macro_auroc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Macro AUROC over label columns (d_classification_multilabel.py:91):
    the mean of the per-column binary AUROCs."""
    labels = np.asarray(labels)
    if labels.ndim == 1:
        return auroc(labels, scores)
    scores = np.asarray(scores)
    return float(np.mean([auroc(labels[:, j], scores[:, j])
                          for j in range(labels.shape[1])]))


def rmse(preds: np.ndarray, targets: np.ndarray,
         mean: float = 0.0, std: float = 1.0) -> float:
    """Denormalized RMSE (reference d_regression.py:96-102 de-normalizes BOTH
    sides with the train-set stats even for datasets whose targets were never
    normalized — the asymmetry is replicated by the caller's dataset flags)."""
    p = preds * std + mean
    t = targets * std + mean
    return float(np.sqrt(np.mean(np.square(p - t))))


@torch.no_grad()
def classification_scores(model: Downstream, batches,
                          attention_impl: str = "kernel"
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Softmax positive-class scores + labels over an eval set of numpy
    batches {"ids", "mask", "target"}, on the model's device."""
    dev = next(model.parameters()).device
    scores, labels = [], []
    for batch in batches:
        out = downstream_forward(
            model, torch.as_tensor(batch["ids"], device=dev),
            torch.as_tensor(batch["mask"], device=dev),
            attention_impl=attention_impl)
        scores.append(torch.softmax(out, dim=-1)[:, 1].cpu().numpy())
        labels.append(np.asarray(batch["target"]))
    return np.concatenate(labels), np.concatenate(scores)
