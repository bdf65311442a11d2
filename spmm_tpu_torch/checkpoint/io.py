"""Pretrain checkpoints on disk (the port's counterpart of the JAX
package's Orbax module, ``spmm_tpu.checkpoint.io``).

One ``torch.save`` per checkpoint holds the ``PretrainModel``'s
reference-named state dict (weights, ``temp``, the momentum twins, the
queues and ``queue_ptr``: a reference loader reads its ``state_dict``),
the optimizer's ``state_dict`` and the step.  It is written under a
temporary name and moved into place with ``os.replace``, so a crash while
saving leaves the previous checkpoint whole.

The optimizer state is stored in the layout of a plain AdamW over the
online parameters, whatever the world size and whether ``zero1`` sharded
it: a ``ZeroRedundancyOptimizer``'s shards are gathered to rank 0 first.
So a checkpoint written by N ranks with ``zero1`` resumes in one process
without it, and the reverse, as JAX's Orbax checkpoints do.  The same
holds for tensor and fully-sharded parallelism: a DTensor parameter or
moment is written whole (``full_tensor``), and a whole tensor read back
into one is cut to this rank's part; the EMA twins that ZeRO-1 keeps as
per-rank shards (``training.pretrain.TwinShards``) are written whole and
read back into this rank's share.  Under a process group every rank
calls ``save_checkpoint`` / ``AsyncSaver.save`` (the gathers are
collectives) and global rank 0 writes; every rank restores.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from spmm_tpu_torch.parallel.mesh import is_main


def optimizer_state(optimizer: torch.optim.Optimizer) -> Optional[dict]:
    """The optimizer's ``state_dict`` in a plain AdamW's layout.  For a
    ``ZeroRedundancyOptimizer`` this is a collective that every rank must
    call; ranks other than 0 get None."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    if not isinstance(optimizer, ZeroRedundancyOptimizer):
        return whole(optimizer.state_dict())
    optimizer.consolidate_state_dict(to=0)
    if optimizer.rank != 0:
        return None
    params = optimizer.param_groups[0]["params"]
    if params[0].device.type == "cuda":
        torch.cuda.synchronize()     # the gathered shards were copied async
    # the local AdamW's hyperparameters: a plain AdamW's keys
    hyper = {k: v for k, v in optimizer.optim.param_groups[0].items()
             if k != "params"}
    return {"state": optimizer.state_dict()["state"],
            "param_groups": [dict(hyper, params=list(range(len(params))))]}


def whole(obj):
    """``obj`` (a state dict, nested) with every DTensor gathered whole: a
    collective that every rank of its mesh calls."""
    if isinstance(obj, dict):
        return {k: whole(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(whole(v) for v in obj)
    return obj.full_tensor() if isinstance(obj, DTensor) else obj


def _like(value: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """A whole ``value`` laid out as ``target``: this rank's part of it as
    a DTensor of ``target``'s mesh and placements, or ``value``."""
    if not isinstance(target, DTensor):
        return value
    return distribute_tensor(value.to(target.device, target.dtype),
                             target.device_mesh, target.placements)


def model_state(model: torch.nn.Module) -> dict:
    """``model``'s state dict with every DTensor whole and, under ZeRO-1,
    the twins gathered: a collective that every rank calls."""
    from spmm_tpu_torch.training.pretrain import whole_twins

    with whole_twins(model):
        return whole(model.state_dict())


def _write(path: str, state: dict) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, step: int) -> None:
    """Write {"state_dict", "optimizer", "step"} to ``path`` atomically
    (rank 0 writes; every rank of a process group calls it)."""
    opt_state = optimizer_state(optimizer)
    state = model_state(model)
    if is_main():
        _write(path, {"state_dict": state,
                      "optimizer": opt_state, "step": int(step)})


class AsyncSaver:
    """``save_checkpoint`` with the write off the training loop.

    ``save`` returns once the state is on the host: the card's tensors are
    copied into pinned buffers kept from one save to the next, the CPU's
    are cloned.  A background thread then writes the same file
    ``save_checkpoint`` writes, atomically.  A second ``save`` waits for the
    first.  ``wait()`` blocks until the last write is on disk; ``close()``
    (or leaving a ``with`` block) does too.  An error in the thread is
    raised again at the next ``save``, ``wait`` or ``close``.

    The reference has nothing comparable: PL's ``ModelCheckpoint`` blocks
    the loop for the whole ``torch.save`` (SPMM_pretrain.py:29-34)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pinned: dict = {}

    def save(self, path: str, model: torch.nn.Module,
             optimizer: torch.optim.Optimizer, step: int) -> None:
        self.wait()
        opt_state = optimizer_state(optimizer)
        weights = model_state(model)
        if not is_main():
            return
        state = self._to_host({"state_dict": weights,
                               "optimizer": opt_state}, "")
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        state["step"] = int(step)
        self._thread = threading.Thread(target=self._run, args=(path, state),
                                        name="AsyncSaver")
        self._thread.start()

    def _to_host(self, obj, key: str):
        if isinstance(obj, dict):
            return {k: self._to_host(v, f"{key}/{k}") for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._to_host(v, f"{key}/{i}")
                             for i, v in enumerate(obj))
        if not isinstance(obj, torch.Tensor):
            return obj
        if obj.device.type != "cuda":
            return obj.detach().clone()
        buf = self._pinned.get(key)
        if buf is None or buf.shape != obj.shape or buf.dtype != obj.dtype:
            buf = self._pinned[key] = torch.empty(
                obj.shape, dtype=obj.dtype, pin_memory=True)
        return buf.copy_(obj.detach(), non_blocking=True)

    def _run(self, path: str, state: dict) -> None:
        try:
            _write(path, state)
        except BaseException as exc:  # noqa: BLE001 - raised in wait()
            self._error = exc

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise RuntimeError("an asynchronous checkpoint write failed") \
                from exc

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "AsyncSaver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def restore_checkpoint(path: str, model: torch.nn.Module,
                       optimizer: Optional[torch.optim.Optimizer] = None
                       ) -> int:
    """Load a ``save_checkpoint`` file into ``model`` (strictly) and
    ``optimizer``, in place; returns the step.  Every rank loads it; a
    ``ZeroRedundancyOptimizer`` keeps its own share of the state."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    shards = getattr(model, "twin_shards", None)
    if shards is not None:
        shards.materialize()
    try:
        own = model.state_dict()
        model.load_state_dict({k: _like(v, own[k]) if k in own else v
                               for k, v in ckpt["state_dict"].items()},
                              strict=True)
        if shards is not None:
            shards.take()
    finally:
        if shards is not None:
            shards.release()
    if optimizer is not None:
        state = ckpt["optimizer"]
        params = [p for g in optimizer.param_groups for p in g["params"]]
        if any(isinstance(p, DTensor) for p in params):
            state = dict(state, state={
                i: {k: _like(v, params[i]) if k.startswith("exp_avg")
                    else v for k, v in st.items()}
                for i, st in state["state"].items()})
        optimizer.load_state_dict(state)
    if isinstance(optimizer, ZeroRedundancyOptimizer):
        # ZeRO puts every 0-dim state tensor on the CPU, a 0-dim
        # parameter's (``temp``'s) moments too; they belong on its device
        for param, state in optimizer.optim.state.items():
            for key in ("exp_avg", "exp_avg_sq"):
                state[key] = state[key].to(param.device)
    return int(ckpt["step"])
