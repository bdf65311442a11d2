"""The data-parallel group (counterpart of ``spmm_tpu.parallel.mesh``).

JAX lays its devices out as a 1-D mesh whose axis is named ``DP_AXIS`` and
reduces over that axis inside ``shard_map``.  The port's counterpart is the
default ``torch.distributed`` process group: one process per GPU (or per
CPU rank under gloo), ranked 0 .. world - 1.  With no process group every
helper answers as one process: world 1, rank 0, no group.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

DP_AXIS = "dp"


def dp_group() -> Optional[dist.ProcessGroup]:
    """The data-parallel group: the default group once
    ``torch.distributed`` is initialized, else None."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def dp_size() -> int:
    """Ranks in the data-parallel group (1 without a process group)."""
    return 1 if dp_group() is None else dist.get_world_size()


def dp_rank() -> int:
    """This process's rank in the data-parallel group (0 without one)."""
    return 0 if dp_group() is None else dist.get_rank()
