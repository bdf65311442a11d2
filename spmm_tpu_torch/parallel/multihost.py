"""Multi-process glue (counterpart of ``spmm_tpu.parallel.multihost``).

- :func:`initialize` starts the process group, from
  ``torch.distributed.run``'s environment (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) or from explicit
  arguments: NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU;
- :func:`process_rows`: the contiguous rows of a global batch that one
  process loads, as JAX's;
- :func:`local_rows`: a data-parallel rank's rows of a global batch that
  the step splits into ``accum`` microbatches.

The reference runs single-node DDP over 8 GPUs under PyTorch Lightning
(SPMM_pretrain.py:35-36); here each rank is one process started by
``torch.distributed.run`` and the step reduces explicitly
(``training.pretrain.make_pretrain_step``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from spmm_tpu_torch.utils.device import DeviceLike, resolve_device


def launched() -> bool:
    """Whether ``torch.distributed.run`` (or an equivalent launcher) set
    this process's rank and world size."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize(device: DeviceLike = None, init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> torch.device:
    """Start the default process group and return this rank's device.

    Without arguments it reads ``torch.distributed.run``'s environment
    (``init_method`` ``env://``).  ``device`` is resolved as every entry
    point resolves it (None means the GPU, which must be there): on CUDA
    the rank takes ``cuda:LOCAL_RANK`` (unless ``device`` names an index)
    and NCCL, on the CPU gloo.  A second
    call raises, as ``jax.distributed.initialize`` does: carrying on would
    run N disconnected jobs."""
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, **kwargs)
    return dev


def process_rows(n_global: int, process_index: int,
                 process_count: int) -> range:
    """Rows of the global batch process ``process_index`` of
    ``process_count`` loads: a contiguous block, in rank order."""
    if n_global % process_count:
        raise ValueError(f"global batch {n_global} not divisible by "
                         f"{process_count} processes")
    per = n_global // process_count
    return range(process_index * per, (process_index + 1) * per)


def local_rows(n_global: int, rank: int, world: int,
               accum: int = 1) -> np.ndarray:
    """The global rows a data-parallel rank trains on when the step splits
    its rows into ``accum`` microbatches, in the order it holds them.

    JAX first cuts the global batch into ``accum`` microbatches of ``M =
    n_global / accum`` rows, then splits each over the ranks
    (spmm_tpu/training/pretrain.py:576-578), so microbatch ``i`` of rank
    ``r`` holds rows ``[i*M + r*m, i*M + (r+1)*m)``, ``m = M / world``: not
    one contiguous block per rank unless ``accum`` is 1."""
    if n_global % (accum * world):
        raise ValueError(f"global batch {n_global} not divisible by accum "
                         f"{accum} x {world} ranks")
    big, small = n_global // accum, n_global // (accum * world)
    return np.concatenate([np.arange(i * big + rank * small,
                                     i * big + (rank + 1) * small)
                           for i in range(accum)])
