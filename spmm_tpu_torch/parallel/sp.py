"""Sequence parallelism (Megatron-SP) on top of tensor parallelism
(counterpart of ``spmm_tpu.parallel.sp``).

Tensor parallelism (``parallel.tp``) leaves the residual stream between
the matmul sandwiches replicated over the tp group: every tp peer runs
the same dropout, residual add and LayerNorm over the whole [B, L, H].
Inside :func:`sequence_parallel` those regions run on this rank's L / tp
positions instead:

- ``models.bert.BertModel`` cuts its input to this rank's positions
  (:func:`scatter`) and gathers its output whole (:func:`gather`), so that
  what goes in and comes out of an encoder is what it is without
  sequence parallelism;
- each attention and MLP block gathers its input whole before the
  column-parallel projections (:func:`gather`), and the row-parallel
  out-projection reduce-scatters over positions instead of all-reducing
  (``parallel.tp``'s row-parallel style reads :func:`active`);
- the dropout before each residual add draws its mask over the whole
  [B, L, H], as one process does, and keeps this rank's positions
  (:func:`residual_dropout`);
- the block LayerNorms then see only this rank's positions, so their
  gradients are partial sums: the train step adds them over the tp group
  (:func:`partial_parameters`).

JAX constrains the same points of the residual stream (spmm_tpu/models/
bert.py:45,154) and lets GSPMD place the collectives.  As there, only
rank-3 [B, L, H] activations are cut, and tp must divide L: other lengths
raise rather than pad.  The context is read when a forward runs, and by
``torch.utils.checkpoint``'s recompute in the backward too, so the train
step keeps the backward inside it.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Optional

import torch
from torch import nn

from spmm_tpu_torch.ops.attention import dropout

Tensor = torch.Tensor

_ACTIVE: ContextVar = ContextVar("spmm_torch_sequence_parallel",
                                 default=None)


@contextmanager
def sequence_parallel(tp_mesh):
    """Run the model code in this context sequence-parallel over
    ``tp_mesh``, the 1-D mesh of this rank's tp peers
    (``parallel.mesh.minor_mesh()``)."""
    if tp_mesh.ndim != 1:
        raise ValueError("sequence parallelism runs over the 1-D tp mesh")
    token = _ACTIVE.set(tp_mesh)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> bool:
    return _ACTIVE.get() is not None


def _mesh_for(x: Tensor):
    mesh = _ACTIVE.get()
    if mesh is None or x.dim() != 3:
        return None
    return mesh


def scatter(x: Tensor) -> Tensor:
    """A whole [B, L, H] -> this rank's positions [B, L / tp, H]; the
    identity outside the context.  Its backward gathers the gradient."""
    mesh = _mesh_for(x)
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if x.shape[1] % mesh.size():
        raise ValueError(f"sequence parallelism: tp={mesh.size()} does not "
                         f"divide the sequence length {x.shape[1]}")
    full = DTensor.from_local(x, mesh, [Replicate()], run_check=False)
    return full.redistribute(mesh, [Shard(1)]).to_local()


def gather(x: Tensor) -> Tensor:
    """This rank's positions -> the whole [B, L, H]; the identity outside
    the context.  Its backward keeps this rank's positions of the gradient,
    which the peers hold alike (the column-parallel input all-reduces
    it)."""
    mesh = _mesh_for(x)
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Shard

    return DTensor.from_local(x, mesh, [Shard(1)],
                              run_check=False).full_tensor()


def residual_dropout(x: Tensor, rate: float,
                     generator: Optional[torch.Generator]) -> Tensor:
    """``ops.attention.dropout`` of the residual stream: inside the context
    the mask is drawn over all L positions and cut to this rank's."""
    mesh = _mesh_for(x)
    if mesh is None:
        return dropout(x, rate, generator)
    n, r, l = mesh.size(), mesh.get_local_rank(), x.shape[1]
    return dropout(x, rate, generator, (x.shape[0], n * l, x.shape[2]),
                   (slice(None), slice(r * l, (r + 1) * l)))


def partial_parameters(model: nn.Module) -> list:
    """The parameters whose gradients are partial sums over the tp group
    under sequence parallelism: every LayerNorm after an attention or MLP
    block (the others see whole sequences)."""
    from spmm_tpu_torch.models.bert import BertLayer

    out = []
    for layer in model.modules():
        if isinstance(layer, BertLayer):
            blocks = [layer.attention.output, layer.output]
            if layer.has_cross:
                blocks.insert(1, layer.crossattention.output)
            for block in blocks:
                out += [p for p in block.LayerNorm.parameters()
                        if p.requires_grad]
    return out
