"""Data-parallel inference over several cards (counterpart of the
``mesh=`` arguments of ``spmm_tpu.inference``: ``_mesh_put``, which
replicates the weights and shards a batch's rows over the dp axis).

:class:`Replicas` keeps one copy of a model on each card of ``devices``
(a card named twice holds one copy) and one worker thread per entry:
:meth:`Replicas.map` cuts a batch's rows into contiguous blocks, one per
entry, as ``batch_sharding`` splits dim 0, runs a function on each block
in its worker, on its card and its own CUDA stream, and returns the
results in row order.  One thread per card matters because the inference
paths are bound by the host (the device is busy 15-25% of a PV->SMILES or
reaction batch): one Python thread launching N cards' shards in turn
would give N cards the throughput of one.  Rows are independent in every
path, so a sharded batch equals the unsharded one.
"""

from __future__ import annotations

import contextlib
import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn


class Replicas:
    """``model`` on every card of ``devices``; ``prepare(copy)`` makes what
    each worker runs (e.g. a bf16 decoder) once per card."""

    def __init__(self, model: nn.Module, devices: Sequence,
                 prepare: Optional[Callable] = None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("no devices to shard over")
        home = next(model.parameters()).device
        copies = {}
        for dev in self.devices:
            if dev not in copies:
                rep = model if dev == home else copy.deepcopy(model).to(dev)
                copies[dev] = rep if prepare is None else prepare(rep)
        self.models = [copies[dev] for dev in self.devices]
        if any(d.type == "cuda" for d in self.devices):
            torch.cuda.synchronize()
        self._pool = ThreadPoolExecutor(len(self.devices),
                                        thread_name_prefix="replica")

    def __len__(self) -> int:
        return len(self.devices)

    def check_batch(self, batch: int) -> None:
        """A batch must split into equal blocks, as JAX asserts."""
        if batch % len(self):
            raise ValueError(f"batch {batch} does not divide over "
                             f"{len(self)} devices")

    def map(self, fn: Callable, *arrays) -> list:
        """[fn(model, device, rows, *blocks) for each entry], in row order:
        ``rows`` is the entry's slice of the batch and ``blocks`` the
        entry's rows of ``arrays`` (numpy arrays or tensors, None passes
        through), on its device."""
        n = next(a for a in arrays if a is not None).shape[0]
        self.check_batch(n)
        per = n // len(self)

        def work(i: int):
            dev, rows = self.devices[i], slice(i * per, (i + 1) * per)
            stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                      else None)
            ctx = (contextlib.nullcontext() if stream is None
                   else torch.cuda.stream(stream))
            with ctx:
                if stream is not None:
                    stream.wait_stream(torch.cuda.default_stream(dev))
                blocks = [None if a is None else
                          torch.as_tensor(a[rows]).to(dev) for a in arrays]
                out = fn(self.models[i], dev, rows, *blocks)
                if stream is not None:
                    stream.synchronize()
            return out

        futures = [self._pool.submit(work, i) for i in range(len(self))]
        return [f.result() for f in futures]

    def close(self) -> None:
        self._pool.shutdown()

    def __enter__(self) -> "Replicas":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def concat_rows(parts: list) -> dict:
    """The shards' host results as one: arrays joined on the row dim, and
    ``steps`` (a decoder's step count) the largest, since the unsharded
    batch runs until its slowest row stops."""
    out = {}
    for key, first in parts[0].items():
        if isinstance(first, np.ndarray):
            out[key] = np.concatenate([p[key] for p in parts])
        else:
            out[key] = max(p[key] for p in parts)
    return out


def pad_rows(ids: np.ndarray, mask: np.ndarray, n: int,
             cls_id: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Pad a token batch to ``n`` rows (``_pad_rows`` of spmm_tpu/inference/
    rxn.py:84-93): a pad row is [CLS] then padding, so it stays well
    formed; its output is dropped by the caller."""
    pad = n - ids.shape[0]
    if pad <= 0:
        return ids, mask
    ids = np.pad(np.asarray(ids), [(0, pad), (0, 0)])
    ids[-pad:, 0] = cls_id
    return ids, np.pad(np.asarray(mask), [(0, pad), (0, 0)])
