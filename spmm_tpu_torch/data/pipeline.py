"""Batching + prefetch (counterpart of ``spmm_tpu.data.pipeline``): the host
pipeline that tokenizes and pads into a small set of static buckets, with a
background-thread prefetcher so host batching overlaps device compute
(SURVEY §7.1).  Batches are numpy; the train loops move them to the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from spmm_tpu_torch.tokenizer import SmilesTokenizer, default_buckets


def batch_supervised(
    tok: SmilesTokenizer,
    texts: Sequence[str],
    targets: np.ndarray,
    batch_size: int,
    max_len: int = 100,
    buckets: Optional[Sequence[int]] = None,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    pad_batch: bool = False,
    truncation: bool = True,
) -> Iterator[dict]:
    """Yield {'ids','mask','target'} batches; optionally pad the final batch
    up to batch_size (repeating row 0) with 'n_real' recording true rows."""
    buckets = buckets if buckets is not None else default_buckets(max_len)
    order = np.arange(len(texts))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for start in range(0, len(order), batch_size):
        idx = order[start: start + batch_size]
        if len(idx) < batch_size and drop_last:
            return
        n_real = len(idx)
        if len(idx) < batch_size and pad_batch:
            idx = np.concatenate([idx, np.repeat(idx[:1],
                                                 batch_size - len(idx))])
        ids, mask = tok.encode_batch([texts[i] for i in idx],
                                     max_len=max_len, buckets=buckets,
                                     truncation=truncation)
        yield {"ids": ids, "mask": mask,
               "target": np.asarray(targets)[idx], "n_real": n_real}


def batch_pairs(
    tok: SmilesTokenizer,
    dataset,
    batch_size: int,
    max_src_len: int = 150,
    max_tgt_len: int = 100,
    src_buckets: Optional[Sequence[int]] = None,
    tgt_buckets: Optional[Sequence[int]] = None,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = True,
) -> Iterator[dict]:
    """(src, tgt) text-pair batches for reaction prediction.  NOTE: like the
    reference rxn driver, sources are NOT truncated (max_length without
    truncation, d_rxn_prediction.py:39)."""
    src_buckets = src_buckets or (32, 64, 96, 128, 192, 256)
    tgt_buckets = tgt_buckets or (32, 64, 96, 128)
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for start in range(0, len(order), batch_size):
        idx = order[start: start + batch_size]
        if len(idx) < batch_size and drop_last:
            return
        pairs = [dataset[int(i)] for i in idx]
        src_ids, src_mask = tok.encode_batch(
            [p[0] for p in pairs], max_len=max_src_len, truncation=False,
            buckets=src_buckets)
        tgt_ids, tgt_mask = tok.encode_batch(
            [p[1] for p in pairs], max_len=max_tgt_len, truncation=False,
            buckets=tgt_buckets)
        yield {"src_ids": src_ids, "src_mask": src_mask,
               "tgt_ids": tgt_ids, "tgt_mask": tgt_mask,
               "n_real": len(pairs)}


def batch_pretrain(
    tok: SmilesTokenizer,
    dataset,
    batch_size: int,
    max_len: int = 100,
    buckets: Optional[Sequence[int]] = None,
    shuffle: bool = True,
    seed: int = 0,
    skip_batches: int = 0,
    rows: Optional[Sequence[int]] = None,
) -> Iterator[dict]:
    """{'prop','ids','mask'} batches for the pretrain step (drop_last), in
    the JAX package's order for the same seed (``np.random.default_rng(
    seed).shuffle``).

    ``rows`` keeps those rows of each global batch of ``batch_size``: a
    data-parallel rank's share (``parallel.multihost.local_rows``).  Every
    rank builds the same global batch from the same seed and pads it to
    the same bucket, so its rows are the ones one process would train on.

    ``skip_batches`` fast-forwards past already-consumed batches of this
    epoch's shuffle order without touching the dataset or tokenizer: the
    resume path uses it so a restored run continues the epoch where it
    stopped instead of replaying it (reference: PL ``ckpt_path`` restores
    the loader position, SPMM_pretrain.py:24-26,37)."""
    buckets = buckets if buckets is not None else default_buckets(max_len)
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for start in range(skip_batches * batch_size,
                       len(order) - batch_size + 1, batch_size):
        idx = order[start: start + batch_size]
        items = [dataset[int(i)] for i in idx]
        ids, mask = tok.encode_batch([t for _, t in items],
                                     max_len=max_len, buckets=buckets)
        batch = {"prop": np.stack([p for p, _ in items]).astype(np.float32),
                 "ids": ids, "mask": mask}
        yield batch if rows is None else {k: v[np.asarray(rows)]
                                          for k, v in batch.items()}


def prefetch(it: Iterable, depth: int = 2) -> Iterator:
    """Background-thread prefetch so host batching overlaps device compute.

    Exceptions raised by the wrapped iterator propagate to the consumer
    (a swallowed error would silently truncate every epoch at the bad item).
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(done)
        except BaseException as e:  # noqa: BLE001 - re-raised in consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
