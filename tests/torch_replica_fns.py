"""Functions the replica tests send to ``parallel.replicas`` workers.

A worker unpickles a function by its import path, so it imports this
module: it imports torch and the port only (tests/test_torch_isolation.py
checks what a worker has loaded through ``forbidden_modules``).  Each takes
``map``'s arguments: the worker's model, its device, its rows and its
blocks.
"""

import os
import sys
import time

from spmm_tpu_torch.ops._build import count_launch
from spmm_tpu_torch.ops.decode_attention import beam_decode_attention
from spmm_tpu_torch.ops.fused_attention import fused_mha


def rows_and_pid(model, dev, rows, x):
    """This worker's rows, its process id and its block."""
    return {"rows": (rows.start, rows.stop), "pid": os.getpid(), "x": x}


def fail_to_prepare(model):
    raise RuntimeError("this model cannot be prepared")


def raise_in_worker(model, dev, rows, x):
    raise ValueError(f"rows {rows.start}:{rows.stop} cannot be decoded")


def exit_worker(model, dev, rows, x):
    """The worker dies in the middle of a call, as one the kernel killed
    for its memory would."""
    os._exit(3)


def sleep_in_worker(model, dev, rows, x, seconds):
    time.sleep(seconds)


def count_launches(model, dev, rows, x):
    """Count what a shard's decode would launch: rows.start + 1 launches
    of kernel 1 and twice as many of kernel 2 (on the CPU the wrappers run
    their plain versions and launch nothing)."""
    for _ in range(rows.start + 1):
        count_launch(beam_decode_attention)
        count_launch(fused_mha)
        count_launch(fused_mha)


def forbidden_modules(model, dev, rows, x):
    """Modules of jax or spmm_tpu loaded in this worker."""
    return sorted(n for n in sys.modules
                  if n.split(".")[0] in ("jax", "jaxlib", "spmm_tpu"))
