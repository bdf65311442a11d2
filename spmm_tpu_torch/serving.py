"""Dynamic-batching serving layer (counterpart of ``spmm_tpu.serving``).

A background worker coalesces requests into fixed-size batches — a batch
launches when it is full OR when the oldest request has waited
``max_wait_ms`` — pads short batches by repeating a real request, runs one
device call per batch, and resolves each caller's
``concurrent.futures.Future`` with its own result.

:class:`Pv2SmilesService` serves property vector -> SMILES and
:class:`Smiles2PvService` SMILES -> property vector.  With ``devices`` (a
list of cards, ``parallel.mesh.auto_mesh()``, or a started
``parallel.replicas.WorkerPool``) each batch's rows are split over one
replica of the model per entry, each in a worker process of its own
(``parallel.replicas``), as JAX's services shard over ``mesh``.  A service
holds its ``Replicas`` for its life and closes it in ``close()``; only the
service's one batching thread calls ``Replicas.map``, which takes one
caller at a time.
"""

from __future__ import annotations

import queue
import random
import threading
import time
from concurrent.futures import Future
from typing import Callable, Sequence

import numpy as np
import torch


class BatchingService:
    """Generic request coalescer: submit items, get Futures; a worker
    thread runs ``batch_fn`` on fixed-size padded batches.

    ``batch_fn(items, n)`` is always called with EXACTLY ``batch_size``
    items (short batches padded by repeating the last real item); ``n`` is
    the real request count.  It must return at least ``n`` results, the
    first ``n`` matching the real items in order.  Exceptions propagate to
    every future of the failing batch.
    """

    def __init__(self, batch_fn: Callable[[list, int], Sequence],
                 batch_size: int, max_wait_ms: float = 25.0):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self._batch_fn = batch_fn
        self._batch_size = batch_size
        self._max_wait = max_wait_ms / 1000.0
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._closed = threading.Event()
        # guards the closed-check-then-enqueue in submit() against close()
        self._submit_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "padded_slots": 0,
                      "batch_seconds": 0.0}
        self._worker = threading.Thread(
            target=self._loop, name=type(self).__name__, daemon=True)
        self._worker.start()

    def submit(self, item) -> Future:
        fut: Future = Future()
        with self._submit_lock:
            if self._closed.is_set():
                raise RuntimeError(f"{type(self).__name__} is closed")
            # the max_wait deadline runs from SUBMISSION
            self._q.put((time.monotonic(), item, fut))
        return fut

    def map(self, items: Sequence) -> list:
        """Submit all items, block until every result is in (order kept)."""
        return [f.result() for f in [self.submit(it) for it in items]]

    def close(self) -> None:
        """Stop accepting requests, drain the queue, join the worker."""
        with self._submit_lock:
            self._closed.set()
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _loop(self) -> None:
        while True:
            try:
                batch = [self._q.get(timeout=0.05)]
            except queue.Empty:
                if self._closed.is_set():
                    return
                continue
            deadline = batch[0][0] + self._max_wait
            while len(batch) < self._batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            items = [it for _, it, _ in batch]
            futures = [f for _, _, f in batch]
            n = len(items)
            padded = items + [items[-1]] * (self._batch_size - n)
            # stats BEFORE resolution: a client that saw its result never
            # reads counters that predate its own batch
            self.stats["requests"] += n
            self.stats["batches"] += 1
            self.stats["padded_slots"] += self._batch_size - n
            t0 = time.perf_counter()
            try:
                results = self._batch_fn(padded, n)
            except Exception as exc:  # noqa: BLE001 — the futures carry it
                for fut in futures:
                    fut.set_exception(exc)
                continue
            self.stats["batch_seconds"] += time.perf_counter() - t0
            for fut, res in zip(futures, results):
                fut.set_result(res)


def _checked(replicas, batch_size: int):
    """``replicas`` if ``batch_size`` divides over it; else it is closed
    and the batch's ValueError raised."""
    try:
        replicas.check_batch(batch_size)
    except ValueError:
        replicas.close()
        raise
    return replicas


class Pv2SmilesService(BatchingService):
    """PV -> SMILES serving: submit a z-normalized [53] property vector,
    receive the generated SMILES string.

    An item is a bare ``[53]`` vector or a ``(pv, mask)`` pair with
    ``mask[53]`` 1 = masked: generation is conditioned on the UNMASKED
    subset only (reference d_pv2smiles_single.py:60-66).  Masked slots'
    values are zeroed on the host, so requests with different masks share
    one batch; an all-zero mask row equals no mask bit for bit.

    Deterministic (default): k-beam with stop_count=k, best beam returned.
    ``stochastic=True``: multinomial beam expansion, k**2 stop, uniform pick
    among the finished beams.  The decoder runs in bf16 (fp32 LayerNorm,
    scores and softmax); ``kv_fp8`` stores its KV cache in float8_e4m3fn.
    """

    def __init__(self, model, tok, *, k: int = 2, stochastic: bool = False,
                 batch_size: int = 128, max_wait_ms: float = 25.0,
                 seed: int = 0, kv_fp8: bool = False, device=None,
                 devices=None):
        from spmm_tpu_torch.inference.decoding import BeamSpec
        from spmm_tpu_torch.inference.pv2smiles import (
            _beam_batch, _decode_beams, beam_rows, decoder_for,
            replicas_for, to_host)
        from spmm_tpu_torch.utils.device import check_on, resolve_device

        dev = resolve_device(device)
        check_on(model, dev)
        spec = BeamSpec(k=k, stop_count=k * k if stochastic else k,
                        stochastic=stochastic)
        self._replicas = None
        if devices is None:
            decoder = decoder_for(model, bf16=True)
        else:
            self._replicas = _checked(replicas_for(model, devices),
                                      batch_size)
        gen = torch.Generator(device=dev).manual_seed(seed)
        py_rng = random.Random(seed)

        def split_item(item):
            if isinstance(item, tuple):
                pv, msk = item
                pv = np.asarray(pv, np.float32)
                msk = np.asarray(msk, np.float32)
            else:
                pv = np.asarray(item, np.float32)
                msk = np.zeros_like(pv)
            # a client NaN in a masked slot would otherwise poison the row
            # (NaN * 0 == NaN in the mask blend)
            return np.where(msk > 0, 0.0, pv), msk

        def batch_fn(items: list, n: int) -> list[str]:
            pairs = [split_item(it) for it in items]
            pv = np.stack([p for p, _ in pairs])
            msk = np.stack([m for _, m in pairs])
            if self._replicas is not None:
                result = beam_rows(self._replicas, pv, msk, spec, gen,
                                   kv_fp8)
            else:
                result = to_host(_beam_batch(
                    model, decoder, torch.as_tensor(pv, device=dev),
                    torch.as_tensor(msk, device=dev), spec, gen, kv_fp8))
            # decode only the real rows
            return [_decode_beams(tok, result, i, k, stochastic, py_rng)
                    for i in range(n)]

        super().__init__(batch_fn, batch_size, max_wait_ms)

    def close(self) -> None:
        super().close()
        if self._replicas is not None:
            self._replicas.close()


class Smiles2PvService(BatchingService):
    """SMILES -> PV serving: submit a SMILES string, receive the 53-entry
    property vector (denormalized when ``stats`` is given, else normalized).

    One fixed-length bucket (``max_len``) so that every batch has one shape
    (reference d_smiles2pv.py truncates at 100 likewise).  fp32 by default,
    every attention through the fused kernel; ``bf16`` runs a bfloat16 copy
    of the model."""

    def __init__(self, model, tok, *, stats=None, batch_size: int = 128,
                 max_wait_ms: float = 25.0, max_len: int = 100,
                 bf16: bool = False, device=None, devices=None):
        from spmm_tpu_torch.inference.smiles2pv import (
            cast_params_bf16, predict_pv, predict_pv_rows)
        from spmm_tpu_torch.parallel.replicas import Replicas
        from spmm_tpu_torch.utils.device import check_on, resolve_device

        dev = resolve_device(device)
        check_on(model, dev)
        if bf16:
            model = cast_params_bf16(model)
        self._replicas = None
        if devices is not None:
            self._replicas = _checked(Replicas(model, devices), batch_size)

        def batch_fn(smiles: list[str], n: int) -> list[np.ndarray]:
            texts = [s if s.startswith("[CLS]") else "[CLS]" + s
                     for s in smiles]
            ids, mask = tok.encode_batch(texts, max_len=max_len,
                                         buckets=(max_len,))
            if self._replicas is not None:
                preds = predict_pv_rows(self._replicas, ids, mask,
                                        bf16=bf16)[:n]
            else:
                preds = predict_pv(model, ids, mask, bf16=bf16,
                                   device=dev).cpu().numpy()[:n]
            if stats is not None:
                preds = stats.denormalize(preds)
            return list(preds)

        super().__init__(batch_fn, batch_size, max_wait_ms)

    def close(self) -> None:
        super().close()
        if self._replicas is not None:
            self._replicas.close()
