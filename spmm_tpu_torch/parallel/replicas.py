"""Data-parallel inference over several cards (counterpart of the
``mesh=`` arguments of ``spmm_tpu.inference``: ``_mesh_put``, which
replicates the weights and shards a batch's rows over the dp axis).

:class:`Replicas` keeps one copy of a model in each of a set of worker
processes, one process per entry of ``devices`` (a card named twice gets
two processes, each with its own copy): :meth:`Replicas.map` cuts a
batch's rows into contiguous blocks, one per entry, as ``batch_sharding``
splits dim 0, runs a function on each block in its worker, on its card,
and returns the results in row order.  One process per card matters
because the inference paths are bound by the host (the device is busy
15-25% of a PV->SMILES or reaction batch): worker threads of one
interpreter serialize their Python work on its lock, so N cards driven
from one process would give the throughput of one.  Rows are independent
in every path, so a sharded batch equals the unsharded one.

The workers are started from a ``spawn`` context (CUDA cannot be used in
a forked child), so a script that shards must keep its entry point under
``if __name__ == "__main__":``, and what crosses to a worker is pickled:
the function given to ``map`` must be a module-level function (or a
``functools.partial`` of one), and blocks travel as numpy arrays.  The
weights cross once, when a :class:`Replicas` is made, as a CPU copy in
shared memory; each worker copies them to its card and applies
``prepare`` there.  A :class:`WorkerPool` (the processes) can be started
once and passed as ``devices`` to several :class:`Replicas`, each of which
then loads its own weights into it.

A worker that raises, dies or outlives the timeout makes the call raise
in the parent with the worker's traceback or exit code; nothing falls
back to running in the parent.
"""

from __future__ import annotations

import copy
import functools
import itertools
import math
import multiprocessing.connection
import threading
import time
import traceback
import weakref
from multiprocessing.reduction import ForkingPickler
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.multiprocessing as mp
from torch import nn

# seconds a pool may take to start (spawn, import torch, reach the card),
# and a call (a batch, or a model's load) may take in its workers; read at
# each start and call
START_TIMEOUT = 300.0
CALL_TIMEOUT = 600.0
# seconds close() waits for a worker to leave before it terminates it
JOIN_TIMEOUT = 10.0

_model_keys = itertools.count()


class WorkerError(RuntimeError):
    """A worker raised: the message holds its traceback."""


# --------------------------------------------------------------------------- #
# the worker process
# --------------------------------------------------------------------------- #


class _Slot:
    """Where a parameter or buffer stood in a model sent to the workers:
    its index in the model's flat copy, and what it was."""

    def __init__(self, index: int, param: bool, requires_grad: bool):
        self.index, self.param, self.requires_grad = index, param, requires_grad


def _pack(model: nn.Module) -> tuple:
    """(skeleton, flat, layout): ``model`` without its tensors (a
    :class:`_Slot` in each parameter's and buffer's place, tied ones
    sharing one), one shared-memory CPU buffer per dtype holding every
    tensor once, and each tensor's (dtype, offset, shape) in it."""
    tensors, memo = [], {}
    for module in model.modules():
        for store in (module._parameters, module._buffers):
            for t in store.values():
                if t is not None and id(t) not in memo:
                    memo[id(t)] = _Slot(len(tensors),
                                        isinstance(t, nn.Parameter),
                                        t.requires_grad)
                    tensors.append(t)
    skeleton = copy.deepcopy(model, memo)
    sizes: dict = {}
    layout = []
    for t in tensors:
        layout.append((t.dtype, sizes.get(t.dtype, 0), tuple(t.shape)))
        sizes[t.dtype] = sizes.get(t.dtype, 0) + t.numel()
    flat = {dt: torch.empty(n, dtype=dt).share_memory_()
            for dt, n in sizes.items()}
    with torch.no_grad():
        for t, (dt, off, shape) in zip(tensors, layout):
            flat[dt][off: off + t.numel()].copy_(t.detach().reshape(-1))
    return skeleton, flat, layout


def _unpack(skeleton: nn.Module, flat: dict, layout: list,
            device: torch.device) -> nn.Module:
    """The model of :func:`_pack` on ``device``: each tensor a copy of its
    span of ``flat`` in an allocation of its own, tied ones tied again."""
    made: dict = {}
    for module in skeleton.modules():
        for store in (module._parameters, module._buffers):
            for key, slot in store.items():
                if not isinstance(slot, _Slot):
                    continue
                if slot.index not in made:
                    dt, off, shape = layout[slot.index]
                    t = flat[dt][off: off + math.prod(shape)].view(shape).to(
                        device, copy=True)
                    made[slot.index] = (nn.Parameter(t, slot.requires_grad)
                                        if slot.param else t)
                store[key] = made[slot.index]
    return skeleton


def _host(obj):
    """``obj`` with every tensor in it (through dicts, lists and tuples) a
    numpy array on the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _launch_counts() -> dict:
    from spmm_tpu_torch.ops.decode_attention import beam_decode_attention
    from spmm_tpu_torch.ops.fused_attention import fused_mha

    return {"beam_decode_attention": beam_decode_attention.launches,
            "fused_mha": fused_mha.launches}


def _handle(msg: tuple, models: dict, device: torch.device) -> tuple:
    kind = msg[0]
    if kind == "load":
        _, key, skeleton, flat, layout, prepare = msg
        model = _unpack(skeleton, flat, layout, device)
        models[key] = model if prepare is None else prepare(model)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return ("ok", None)
    if kind == "drop":
        models.pop(msg[1], None)
        return ("ok", None)
    _, key, fn, rows, blocks, kwargs = msg
    tensors = [None if b is None else torch.as_tensor(b).to(device)
               for b in blocks]
    before = _launch_counts()
    out = _host(fn(models[key], device, rows, *tensors, **kwargs))
    after = _launch_counts()
    return ("ok", out, {k: after[k] - before[k] for k in after})


def _serve(conn, device: torch.device, settings: dict) -> None:
    """A worker's loop: answer each message of ``conn`` until "stop" or
    the parent's end closes.  An exception in a message's work is sent
    back with its traceback, and the worker goes on."""
    models: dict = {}
    try:
        torch.set_num_threads(settings["threads"])
        torch.set_float32_matmul_precision(settings["matmul_precision"])
        if device.type == "cuda":
            torch.cuda.set_device(device)
            _load_kernels()                     # built by the parent
        conn.send(("ok", None))
    except Exception:  # noqa: BLE001 — the parent raises it
        conn.send(("error", traceback.format_exc()))
        return
    while True:
        try:
            msg = conn.recv()
        except EOFError:                        # the parent is gone
            return
        if msg[0] == "stop":
            return
        try:
            reply = _handle(msg, models, device)
        except Exception:  # noqa: BLE001 — the parent raises it
            reply = ("error", traceback.format_exc())
        try:
            conn.send(reply)
        except (BrokenPipeError, ConnectionResetError):
            return


# --------------------------------------------------------------------------- #
# the parent's side
# --------------------------------------------------------------------------- #


def _stop(procs: list, conns: list, timeout: float) -> None:
    """Ask each worker to leave, wait up to ``timeout`` seconds in all,
    then terminate (and at last kill) any that stayed."""
    for conn in conns:
        try:
            conn.send(("stop",))
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
    deadline = time.monotonic() + timeout
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    for proc in procs:
        if proc.is_alive():
            proc.terminate()
            proc.join(5.0)
        if proc.is_alive():
            proc.kill()
            proc.join(5.0)
    for conn in conns:
        conn.close()


def _load_kernels() -> None:
    """Build (or load) both kernel libraries.  The parent calls it before
    any worker starts, so that the workers only load them and never race
    one build."""
    from spmm_tpu_torch.ops import decode_attention, fused_attention

    decode_attention.build()
    fused_attention.build()


def _indexed(device: torch.device) -> torch.device:
    """``device`` with its index: "cuda" is this process's current card."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class WorkerPool:
    """One worker process per entry of ``devices``, started together from
    a ``spawn`` context; :class:`Replicas` loads models into it.  Close it
    with :meth:`close` (or use it as a context manager): it joins the
    workers and terminates any that do not leave.  A pool that is never
    closed is stopped when it is collected or the interpreter exits."""

    def __init__(self, devices: Sequence):
        self.devices = [_indexed(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError("no devices to shard over")
        if any(d.type == "cuda" for d in self.devices):
            _load_kernels()
        ctx = mp.get_context("spawn")
        settings = {"threads": torch.get_num_threads(),
                    "matmul_precision": torch.get_float32_matmul_precision()}
        self._procs, self._conns = [], []
        self._finalizer = weakref.finalize(self, _stop, self._procs,
                                           self._conns, JOIN_TIMEOUT)
        self._lock = threading.Lock()
        self._closed = False
        try:
            for dev in self.devices:
                mine, theirs = ctx.Pipe()
                self._conns.append(mine)
                proc = ctx.Process(target=_serve, args=(theirs, dev, settings),
                                   daemon=True, name=f"replica-{dev}")
                proc.start()
                theirs.close()      # the worker's end lives in the worker
                self._procs.append(proc)
        except BaseException:
            self.close()
            raise
        self._gather(START_TIMEOUT, "start")

    def __len__(self) -> int:
        return len(self.devices)

    def call(self, messages: list) -> list:
        """Send ``messages[i]`` to worker i and return the replies in
        order.  A worker's exception raises :class:`WorkerError` once every
        worker has answered; a worker that dies, or a call past
        ``CALL_TIMEOUT`` seconds, stops the pool and raises."""
        payloads = [ForkingPickler.dumps(m) for m in messages]
        with self._lock:
            if self._closed:
                raise RuntimeError("the worker pool is closed")
            for i, payload in enumerate(payloads):
                try:
                    self._conns[i].send_bytes(payload)
                except (BrokenPipeError, ConnectionResetError):
                    self._fail(f"{self._name(i)} is gone (exit code "
                               f"{self._procs[i].exitcode})")
            return self._gather(CALL_TIMEOUT, messages[0][0])

    def _name(self, i: int) -> str:
        return f"worker {i} ({self.devices[i]}, pid {self._procs[i].pid})"

    def _fail(self, why: str, exc=RuntimeError):
        self.close(timeout=0.0)     # a worker is lost or stuck: stop them all
        raise exc(f"{why}; the worker pool is closed")

    def _gather(self, timeout: float, what: str) -> list:
        replies: list = [None] * len(self)
        pending = set(range(len(self)))
        deadline = time.monotonic() + timeout
        while pending:
            # a worker that dies closes its end: its pipe reads EOF
            waits = {self._conns[i]: i for i in pending}
            ready = multiprocessing.connection.wait(
                list(waits), max(0.0, deadline - time.monotonic()))
            if not ready:
                self._fail(f"{what}: no answer from "
                           + ", ".join(self._name(i) for i in sorted(pending))
                           + f" within {timeout:.0f} s", TimeoutError)
            for conn in ready:
                i = waits[conn]
                try:
                    replies[i] = conn.recv()
                except (EOFError, ConnectionResetError):
                    self._procs[i].join(5.0)
                    self._fail(f"{what}: {self._name(i)} died (exit code "
                               f"{self._procs[i].exitcode})")
                pending.discard(i)
        errors = [f"{self._name(i)} raised:\n{r[1]}"
                  for i, r in enumerate(replies) if r[0] == "error"]
        if errors:
            if what == "start":
                self._fail("\n".join(errors), WorkerError)
            raise WorkerError(f"{what}: " + "\n".join(errors))
        return [r[1:] for r in replies]

    def close(self, timeout: float = JOIN_TIMEOUT) -> None:
        """Stop every worker: join each (``timeout`` seconds in all),
        terminate any that stayed.  Safe to call twice."""
        self._closed = True
        if self._finalizer.detach() is not None:
            _stop(self._procs, self._conns, timeout)

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _check_module_level(fn: Callable, what: str) -> None:
    """A lambda or a nested function cannot cross to a worker process."""
    inner = fn
    while isinstance(inner, functools.partial):
        inner = inner.func
    name = getattr(inner, "__qualname__", "")
    if "<lambda>" in name or "<locals>" in name:
        raise TypeError(
            f"{what} must be a module-level function (or a functools."
            f"partial of one), since it is pickled into the worker "
            f"processes; got {name}")


def _host_rows(a, rows: slice) -> np.ndarray:
    block = a[rows]
    if isinstance(block, torch.Tensor):
        return block.detach().cpu().numpy()
    return np.asarray(block)


class Replicas:
    """``model`` in a worker process for each entry of ``devices`` (a list
    of devices, for which it starts a :class:`WorkerPool` and closes it
    with itself, or a started pool, which outlives it); ``prepare(copy)``
    makes what each worker runs (e.g. a bf16 decoder), on its card.
    ``prepare`` and the functions given to :meth:`map` must be
    module-level functions.  :meth:`map` may be called from one thread at
    a time (calls from several threads wait their turn)."""

    def __init__(self, model: nn.Module, devices,
                 prepare: Optional[Callable] = None):
        if prepare is not None:
            _check_module_level(prepare, "prepare")
        self._own = not isinstance(devices, WorkerPool)
        self.pool = WorkerPool(devices) if self._own else devices
        self.devices = self.pool.devices
        # each shard's kernel launches in the last map, by wrapper name
        self.launches: list = []
        self._key = next(_model_keys)
        self._loaded = True         # (some of) the workers may hold it
        try:
            skeleton, flat, layout = _pack(model)
            self.pool.call([("load", self._key, skeleton, flat, layout,
                             prepare)] * len(self.pool))
        except BaseException:
            self.close()
            raise

    def __len__(self) -> int:
        return len(self.devices)

    def check_batch(self, batch: int) -> None:
        """A batch must split into equal blocks, as JAX asserts."""
        if batch % len(self):
            raise ValueError(f"batch {batch} does not divide over "
                             f"{len(self)} devices")

    def map(self, fn: Callable, *arrays, **kwargs) -> list:
        """[fn(model, device, rows, *blocks, **kwargs) for each entry], in
        row order, each run in its worker: ``rows`` is the entry's slice of
        the batch and ``blocks`` the entry's rows of ``arrays`` (numpy
        arrays or tensors, None passes through) as tensors on its device.
        Results come back with every tensor a numpy array; each shard's
        kernel launches in the call are left in ``self.launches``."""
        _check_module_level(fn, "the function given to Replicas.map")
        n = next(a for a in arrays if a is not None).shape[0]
        self.check_batch(n)
        per = n // len(self)
        messages = []
        for i in range(len(self)):
            rows = slice(i * per, (i + 1) * per)
            messages.append(("map", self._key, fn, rows,
                             [None if a is None else _host_rows(a, rows)
                              for a in arrays], kwargs))
        replies = self.pool.call(messages)
        self.launches = [launches for _, launches in replies]
        return [out for out, _ in replies]

    def close(self) -> None:
        """Free the weights in the workers; stop the pool if it is this
        object's own."""
        if self._own:
            self.pool.close()
        elif self._loaded and not self.pool._closed:
            self._loaded = False
            self.pool.call([("drop", self._key)] * len(self))

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
