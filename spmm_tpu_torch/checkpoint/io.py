"""Pretrain checkpoints on disk (the port's counterpart of the JAX
package's Orbax module, ``spmm_tpu.checkpoint.io``).

One ``torch.save`` per checkpoint holds the ``PretrainModel``'s
reference-named state dict (weights, ``temp``, the momentum twins, the
queues and ``queue_ptr``: a reference loader reads its ``state_dict``),
the optimizer's ``state_dict`` and the step.  It is written under a
temporary name and moved into place with ``os.replace``, so a crash while
saving leaves the previous checkpoint whole.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, step: int) -> None:
    """Write {"state_dict", "optimizer", "step"} to ``path`` atomically."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save({"state_dict": model.state_dict(),
                "optimizer": optimizer.state_dict(), "step": int(step)}, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, model: torch.nn.Module,
                       optimizer: Optional[torch.optim.Optimizer] = None
                       ) -> int:
    """Load a ``save_checkpoint`` file into ``model`` (strictly) and
    ``optimizer``, in place; returns the step."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
    return int(ckpt["step"])
