"""Fully-sharded data parallelism (ZeRO-3) for the SPMM family on a
dp x fsdp mesh (counterpart of ``spmm_tpu.parallel.fsdp``).

The layout rule of JAX's ``_leaf_spec`` (spmm_tpu/parallel/fsdp.py:79-92):
each parameter is sharded over the mesh's ``fsdp`` dim on its largest dim
that fsdp divides (on a tie, the later dim, read in JAX's layout of the
leaf); a parameter with no such dim stays replicated.  It is applied with
FSDP2's ``fully_shard``: one unit per ``BertLayer`` (the online encoders'
and the momentum twins'), and the whole ``PretrainModel`` as the root unit
for the rest (embeddings, heads, projections), with a
``shard_placement_fn`` that returns the rule's dim.
So the parameters, the EMA twins and both AdamW moments are sharded at
rest; ``temp`` (a scalar), the replicated leaves, the queues and
``queue_ptr`` are not (spmm_tpu/parallel/fsdp.py:109-125).

fsdp shards state, not rows.  The rows, the in-batch negatives, the queue
order and the generator chunks depend on the dp extent alone
(``training.pretrain.make_pretrain_step`` keys them on the dp rank), so
the F fsdp peers of a dp group compute the same rows and a dp=D x fsdp=F
run equals a 1-D dp=D run (spmm_tpu/parallel/fsdp.py:29-33).  FSDP2's
reduce-scatter therefore divides the peers' identical gradients by F
(``set_gradient_divide_factor``) rather than summing them, and the step
all-reduces the shards over dp.  FSDP2 gathers a unit's parameters around
its forward and backward, the twins' around the momentum forward, and
``ema_update`` runs on the local shards.

Checkpoints keep the plain layout (``checkpoint.io``): every tensor whole.
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from spmm_tpu_torch.parallel import mesh as _mesh

FSDP_AXIS = _mesh.FSDP_AXIS


def dp_fsdp_mesh(dp: Optional[int] = None, fsdp: int = 1):
    """The process-wide ('dp', 'fsdp') mesh (``mesh.set_mesh``); 'fsdp' is
    the minor dim.  ``dp=None`` takes world / fsdp, which fsdp must divide;
    a ``dp`` with ``dp * fsdp`` other than the world size raises, as JAX's
    does (spmm_tpu/parallel/fsdp.py:66-76)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp is None:
        if world % fsdp:
            raise ValueError(f"{world} ranks not divisible by fsdp={fsdp}")
        dp = world // fsdp
    return _mesh.set_mesh(dp, fsdp, FSDP_AXIS)


def shard_dim(shape, fsdp_size: int) -> Optional[int]:
    """The dim a leaf of ``shape`` is sharded on: its largest that
    ``fsdp_size`` divides, the later one on a tie; None (replicated) for a
    scalar or a leaf with no such dim."""
    best, best_dim = -1, None
    for d, n in enumerate(shape):
        if n % fsdp_size == 0 and n >= best:
            best, best_dim = n, d
    return best_dim


def fsdp_param_specs(model: nn.Module, fsdp_size: int) -> dict:
    """{parameter name: the dim it is sharded on, or None}, each parameter
    under the first name it has.  The rule reads JAX's layout of the
    leaf: a linear weight is [out, in] here and [in, out] in JAX, so it is
    judged on the transposed shape and sharded on the dim JAX shards."""
    linears = {id(m.weight) for m in model.modules()
               if isinstance(m, nn.Linear)}
    embeddings = {id(m.weight) for m in model.modules()
                  if isinstance(m, nn.Embedding)}
    specs = {}
    for name, p in model.named_parameters():
        if id(p) in linears and id(p) not in embeddings:
            d = shard_dim(p.shape[::-1], fsdp_size)
            specs[name] = None if d is None else 1 - d
        else:
            specs[name] = shard_dim(p.shape, fsdp_size)
    return specs


def apply_fsdp(model: nn.Module) -> nn.Module:
    """Shard ``model`` over the process-wide mesh's fsdp dim with FSDP2, in
    place; returns it.  ``model`` is the root unit: its ``forward`` (for a
    ``PretrainModel``, the pretrain loss) gathers what the layer units do
    not hold."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from spmm_tpu_torch.models.bert import BertLayer, Linear

    if _mesh.minor_dim() != FSDP_AXIS:
        raise ValueError("fully-sharded data parallelism needs a ('dp', "
                         "'fsdp') mesh (parallel.fsdp.dp_fsdp_mesh)")
    fmesh = _mesh.minor_mesh()
    size = fmesh.size()
    params = dict(model.named_parameters())
    dims = {id(params[name]): d
            for name, d in fsdp_param_specs(model, size).items()}
    replicated = {p for p in params.values() if dims[id(p)] is None}

    def placement(param):
        return Shard(dims[id(param)])

    units = [m for m in model.modules() if isinstance(m, BertLayer)]
    for unit in units + [model]:
        fully_shard(unit, mesh=fmesh, shard_placement_fn=placement,
                    ignored_params=replicated & set(unit.parameters()))
        unit.set_gradient_divide_factor(float(size))
    for m in model.modules():
        if isinstance(m, Linear):
            m.split = False     # a gathered weight is refilled in place
    return model
