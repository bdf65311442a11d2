"""The device mesh and its groups (counterpart of ``spmm_tpu.parallel.mesh``).

JAX lays its devices out as a mesh whose major axis is ``dp`` and whose
minor axis, when there is one, is ``tp`` or ``fsdp`` (``parallel.tp.
dp_tp_mesh``, ``parallel.fsdp.dp_fsdp_mesh``).  The port's counterpart is
a process-wide ``torch.distributed.device_mesh.DeviceMesh`` over one
process per GPU (or per CPU rank under gloo), set up by :func:`set_mesh`
with dims ``("dp", "tp")`` or ``("dp", "fsdp")``: the minor dim varies
fastest, so its peers are adjacent ranks.

- :func:`dp_group`, :func:`dp_size` and :func:`dp_rank` read the mesh's
  ``dp`` dim; with no mesh set up they read the default group (every rank
  is data parallel), and with no process group they answer as one
  process: world 1, rank 0, no group.
- :func:`minor_dim` names the mesh's minor dim, :func:`minor_mesh` is its
  1-D sub-mesh, :func:`tp_rank` this rank's place along ``tp``.
- :func:`local_tensor` is this rank's part of a DTensor (tp or fsdp
  shards), which elementwise updates work on; :func:`all_reduce_flat`
  sums a list of tensors over a group as one flat buffer;
- :func:`is_main` says whether this process is the one that prints and
  writes files (global rank 0).
- :func:`auto_mesh` lists the cards the inference entry points shard
  their rows over.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

DP_AXIS = "dp"
TP_AXIS = "tp"
FSDP_AXIS = "fsdp"

_MESH = None      # the process-wide DeviceMesh, see set_mesh


def set_mesh(dp: int, minor: int = 1, minor_name: str = TP_AXIS,
             device_type: Optional[str] = None):
    """Build the process-wide 2-D mesh ``(dp, minor)`` with dims
    ``("dp", minor_name)`` over the default process group and return it.
    ``dp * minor`` must be the world size.  Every rank calls it (a mesh
    makes its groups collectively); ``clear_mesh`` (or destroying the
    process group) drops it."""
    from torch.distributed.device_mesh import init_device_mesh

    global _MESH
    if minor_name not in (TP_AXIS, FSDP_AXIS):
        raise ValueError(f"the minor dim is 'tp' or 'fsdp', not "
                         f"{minor_name!r}")
    if not dist.is_initialized():
        raise ValueError("a mesh is made over a process group: start one "
                         "first (parallel.multihost.initialize)")
    world = dist.get_world_size()
    if dp * minor != world:
        raise ValueError(f"dp={dp} x {minor_name}={minor} != {world} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    _MESH = init_device_mesh(device_type, (dp, minor),
                             mesh_dim_names=(DP_AXIS, minor_name))
    return _MESH


def clear_mesh() -> None:
    global _MESH
    _MESH = None


def get_mesh():
    """The process-wide mesh, or None (none set up, or its process group
    is gone)."""
    if _MESH is not None and not dist.is_initialized():
        clear_mesh()
    return _MESH


def minor_dim() -> Optional[str]:
    """"tp" or "fsdp", the mesh's minor dim; None without a mesh."""
    mesh = get_mesh()
    return None if mesh is None else mesh.mesh_dim_names[1]


def minor_mesh():
    """The 1-D sub-mesh of the minor dim (this rank's tp or fsdp peers)."""
    mesh = get_mesh()
    if mesh is None:
        raise ValueError("no mesh: set one up first (parallel.mesh.set_mesh)")
    return mesh[mesh.mesh_dim_names[1]]


def dp_group() -> Optional[dist.ProcessGroup]:
    """The data-parallel group: the mesh's ``dp`` dim, else the default
    group once ``torch.distributed`` is initialized, else None."""
    mesh = get_mesh()
    if mesh is not None:
        return mesh.get_group(DP_AXIS)
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def dp_size() -> int:
    """Ranks in the data-parallel group (1 without a process group)."""
    group = dp_group()
    return 1 if group is None else dist.get_world_size(group)


def dp_rank() -> int:
    """This process's rank in the data-parallel group (0 without one)."""
    group = dp_group()
    return 0 if group is None else dist.get_rank(group)


def tp_rank() -> int:
    """This rank's coordinate along the mesh's ``tp`` dim (0 without
    one): the first of its heads is ``tp_rank() * local heads``."""
    mesh = get_mesh()
    if mesh is None or minor_dim() != TP_AXIS:
        return 0
    return mesh.get_local_rank(TP_AXIS)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of a DTensor (a view: writing to it writes the
    DTensor), or ``t`` itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def all_reduce_flat(tensors: list, group: dist.ProcessGroup) -> None:
    """Sum ``tensors`` over ``group`` in place, as one flat buffer: one
    collective for all of them."""
    sizes = [t.numel() for t in tensors]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    torch._foreach_copy_(tensors, [x.view_as(t) for x, t in
                                   zip(flat.split(sizes), tensors)])


def is_main() -> bool:
    """Whether this process prints, logs and writes files: global rank 0,
    or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def auto_mesh() -> Optional[list]:
    """Every visible CUDA device when there are two or more, else None.

    The inference CLIs call it with no flag, as JAX's call
    ``spmm_tpu.parallel.mesh.auto_mesh``, and pass the list as
    ``devices=``: each card then decodes a contiguous block of a batch's
    rows.  On one card they keep the unsharded path."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n <= 1:
        return None
    return [torch.device("cuda", i) for i in range(n)]
