"""Tensor parallelism for the SPMM model family on a dp x tp mesh
(counterpart of ``spmm_tpu.parallel.tp``).

The Megatron layout of JAX's ``_leaf_spec`` (spmm_tpu/parallel/tp.py:85-96),
applied with ``torch.distributed.tensor.parallel.parallelize_module`` over
the mesh's ``tp`` dim:

  - column-parallel (output features sharded): ``query``, ``key`` and
    ``value`` of every self- and cross-attention, and the MLP's
    ``intermediate.dense``: a rank's q, k and v are [B, L, H / tp], that
    is ``num_heads / tp`` whole heads of 64 (``models.bert`` splits them so);
  - row-parallel (input features sharded, one all-reduce at the block's
    exit): ``attention.output.dense``, ``crossattention.output.dense`` and
    the MLP's ``output.dense``;
  - replicated: embeddings, LayerNorms, heads, projections, ``temp`` and
    the queues.

The momentum twins take the same layout, as JAX's ``tp_shardings`` lays
out the whole state.  Dropout on the attention probabilities draws the
mask of all heads and keeps this rank's (``ops.attention``), so a tp run
draws what one process draws; the dropouts after the row-parallel
projections act on the replicated stream and match as they are.  Under
``parallel.sp.sequence_parallel`` the row-parallel projections
reduce-scatter over positions instead.

Use: ``mesh.set_mesh(dp, tp)`` (or :func:`dp_tp_mesh`), then
:func:`apply_tp` on the model before ``training.pretrain.
make_pretrain_step`` or an inference call.
"""

from __future__ import annotations

from typing import Optional

from torch import nn
from torch.distributed.tensor import Shard
from torch.distributed.tensor.parallel import (
    ColwiseParallel, RowwiseParallel, parallelize_module)

from spmm_tpu_torch.configs import BertArchConfig
from spmm_tpu_torch.parallel import mesh as _mesh
from spmm_tpu_torch.parallel import sp

TP_AXIS = _mesh.TP_AXIS

# per BertLayer: the column- and row-parallel linears, by their names under
# the layer (crossattention.* only in fusion layers)
COLWISE = ("attention.self.query", "attention.self.key",
           "attention.self.value", "crossattention.self.query",
           "crossattention.self.key", "crossattention.self.value",
           "intermediate.dense")
ROWWISE = ("attention.output.dense", "crossattention.output.dense",
           "output.dense")


def dp_tp_mesh(dp: Optional[int] = None, tp: int = 1):
    """The process-wide ('dp', 'tp') mesh over every rank (``mesh.
    set_mesh``); 'tp' is the minor dim, so tensor-parallel peers are
    adjacent ranks.  ``dp=None`` takes world / tp, which tp must divide."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp is None:
        if world % tp:
            raise ValueError(f"{world} ranks not divisible by tp={tp}")
        dp = world // tp
    return _mesh.set_mesh(dp, tp, TP_AXIS)


def _layers(model: nn.Module):
    from spmm_tpu_torch.models.bert import BertLayer

    for name, mod in model.named_modules():
        if isinstance(mod, BertLayer):
            yield name, mod


def tp_plan(model: nn.Module) -> dict:
    """{module name: ParallelStyle} of every BertLayer in ``model``."""
    plan = {}
    for name, layer in _layers(model):
        for sub, style in ([(s, ColwiseParallel) for s in COLWISE]
                           + [(s, _RowwiseParallel) for s in ROWWISE]):
            if sub.startswith("crossattention") and not layer.has_cross:
                continue
            plan[f"{name}.{sub}" if name else sub] = style()
    return plan


def tp_param_specs(model: nn.Module) -> dict:
    """{parameter name: "colwise" | "rowwise" | None} under the plan: a
    column-parallel weight and bias are sharded on dim 0 (output
    features), a row-parallel weight on dim 1 (input features) and its
    bias replicated, every other parameter replicated (None)."""
    plan = tp_plan(model)
    specs = {}
    for name, _ in model.named_parameters(remove_duplicate=False):
        owner, _, leaf = name.rpartition(".")
        style = plan.get(owner)
        if isinstance(style, _RowwiseParallel):
            specs[name] = "rowwise" if leaf == "weight" else None
        elif isinstance(style, ColwiseParallel):
            specs[name] = "colwise"
        else:
            specs[name] = None
    return specs


def apply_tp(model: nn.Module) -> nn.Module:
    """Shard ``model``'s blocks over the process-wide mesh's tp dim, in
    place; returns it.  Parameters under the plan become DTensors."""
    if _mesh.minor_dim() != TP_AXIS:
        raise ValueError("tensor parallelism needs a ('dp', 'tp') mesh "
                         "(parallel.tp.dp_tp_mesh)")
    return parallelize_module(model, _mesh.minor_mesh(), tp_plan(model))


def assert_tp_compatible(cfg: BertArchConfig, tp: int) -> None:
    """tp must divide the heads and the MLP width
    (spmm_tpu/parallel/tp.py:118-127)."""
    if cfg.num_attention_heads % tp:
        raise ValueError(
            f"tp={tp} does not divide num_attention_heads="
            f"{cfg.num_attention_heads}")
    if cfg.intermediate_size % tp:
        raise ValueError(
            f"tp={tp} does not divide intermediate_size="
            f"{cfg.intermediate_size}")


class _RowwiseParallel(RowwiseParallel):
    """``RowwiseParallel`` whose output follows ``parallel.sp``: all-reduced
    to a replicated [B, L, H], or inside ``sp.sequence_parallel``
    reduce-scattered to this rank's positions."""

    @staticmethod
    def _prepare_output_fn(output_layouts, use_local_output, mod, outputs,
                           device_mesh):
        if sp.active() and outputs.dim() == 3:
            output_layouts = (Shard(1),)
        if outputs.placements != tuple(output_layouts):
            outputs = outputs.redistribute(placements=output_layouts)
        return outputs.to_local() if use_local_output else outputs
