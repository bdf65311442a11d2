"""Reaction-prediction decoding (counterpart of ``spmm_tpu.inference.rxn``;
reference d_rxn_prediction.py:55-123).

Forward and retro synthesis share one model.  Decoding is batch greedy
(n_beam=1: ``greedy_decode``, a k=1 beam) or k-beam per source (n_beam>1:
``beam_search_batched`` with stop_count=k**2).  The reactant encoder stays
fp32 and runs every attention through ``fused_mha`` (kernel 2); the decoder
runs every self-attention through ``beam_decode_attention`` (kernel 1).
With ``bf16`` the decoder is a bf16 copy, and the encoder output and the KV
cache are bf16.

Sources are padded to the smallest of the buckets (32, 64, 96, 128,
max_src_len) that holds them and never truncated, so a source longer than
``max_src_len`` grows its bucket in steps of 32; kernel 2 takes any number
of keys (past 256 its long kernel, which keeps the scores in shared
memory, runs).

With ``devices`` (e.g. ``parallel.mesh.auto_mesh()``) each batch is padded
to ``batch_size`` rows (``parallel.replicas.pad_rows``, as JAX's
``_pad_rows``) and split into one contiguous block per entry, each
decoded by that entry's replica in a worker process of its own; the pad
rows' outputs are dropped.  ``batch_size`` must divide over the entries.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from spmm_tpu_torch.inference.decoding import (
    BeamSpec, beam_search_batched, greedy_decode)
from spmm_tpu_torch.inference.pv2smiles import (
    decoder_for, to_host, with_decoder)
from spmm_tpu_torch.models.bert import BertForMaskedLM
from spmm_tpu_torch.models.rxn import Rxn, encode_reactants
from spmm_tpu_torch.parallel.replicas import Replicas, concat_rows, pad_rows
from spmm_tpu_torch.tokenizer import SmilesTokenizer
from spmm_tpu_torch.utils.device import DeviceLike, check_on, resolve_device

Tensor = torch.Tensor


def _encode(model: Rxn, decoder: BertForMaskedLM, src_ids: Tensor,
            src_mask: Tensor, attention: str) -> Tensor:
    """fp32 reactant hiddens, cast to the decoder's dtype."""
    enc = encode_reactants(model, src_ids, src_mask, attention_impl=attention)
    return enc.to(next(decoder.parameters()).dtype)


@torch.no_grad()
def _greedy_batch(model: Rxn, decoder: BertForMaskedLM, src_ids: Tensor,
                  src_mask: Tensor, max_steps: int = 100,
                  attention: str = "kernel") -> dict:
    """Greedy decode of one batch of sources (``_greedy_batch`` of the JAX
    package).  ``attention`` ("kernel" or "plain") selects both kernels or
    both plain versions."""
    enc = _encode(model, decoder, src_ids, src_mask, attention)
    return greedy_decode(decoder, model.decoder_cfg, enc, src_mask,
                         max_steps=max_steps, cache_dtype=enc.dtype,
                         attention=attention)


@torch.no_grad()
def _beam_batch(model: Rxn, decoder: BertForMaskedLM, src_ids: Tensor,
                src_mask: Tensor, spec: BeamSpec) -> dict:
    """k-beam decode of one batch of sources (``_beam_batch`` of the JAX
    package); ``spec.attention`` also selects the encoder's attention."""
    enc = _encode(model, decoder, src_ids, src_mask, spec.attention)
    return beam_search_batched(decoder, model.decoder_cfg, enc, src_mask,
                               spec, cache_dtype=enc.dtype)


def _truncate_at_sep(ids: np.ndarray, sep_id: int = 3) -> np.ndarray:
    hits = np.nonzero(ids == sep_id)[0]
    return ids[: hits[0]] if len(hits) else ids


def _encode_sources(tok: SmilesTokenizer, batch: list[str], max_src_len: int,
                    dev: torch.device) -> tuple[Tensor, Tensor]:
    ids, mask = tok.encode_batch(
        ["[CLS]" + s for s in batch], max_len=max_src_len, truncation=False,
        buckets=(32, 64, 96, 128, max_src_len))
    return torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev)


def _decode_shard(pair, dev, rows: slice, ids: Tensor, mask: Tensor,
                  run) -> dict:
    """One worker's block of ``_decode_batches``: the host result of
    ``run(model, decoder, ids, mask)``."""
    return to_host(run(*pair, ids, mask))


def _decode_batches(model: Rxn, tok: SmilesTokenizer, sources: list[str],
                    batch_size: int, max_src_len: int, bf16: bool, dev,
                    devices, run):
    """Yield (batch of sources, host result of ``run(model, decoder, ids,
    mask)``) for each batch: on ``model``'s card, or padded to
    ``batch_size`` and split over ``devices`` (``run`` then a module-level
    function, or a ``functools.partial`` of one)."""
    if devices is None:
        decoder = decoder_for(model, bf16)
        for start in range(0, len(sources), batch_size):
            batch = sources[start: start + batch_size]
            ids, mask = _encode_sources(tok, batch, max_src_len, dev)
            yield batch, to_host(run(model, decoder, ids, mask))
        return
    with Replicas(model, devices,
                  functools.partial(with_decoder, bf16=bf16)) as replicas:
        replicas.check_batch(batch_size)
        for start in range(0, len(sources), batch_size):
            batch = sources[start: start + batch_size]
            ids, mask = _encode_sources(tok, batch, max_src_len, "cpu")
            ids, mask = pad_rows(ids.numpy(), mask.numpy(), batch_size,
                                 tok.cls_token_id)
            yield batch, concat_rows(replicas.map(_decode_shard, ids,
                                                  mask, run=run))


def predict_greedy(model: Rxn, tok: SmilesTokenizer, sources: list[str],
                   batch_size: int = 32, max_src_len: int = 150,
                   bf16: bool = True, device: DeviceLike = None,
                   devices=None) -> list[str]:
    """Batch greedy decode of raw reactant strings (no [CLS]) into product
    strings, each cut at its first [SEP].  Sources are padded, never
    truncated (module docstring)."""
    dev = resolve_device(device)
    check_on(model, dev)
    out: list[str] = []
    for batch, res in _decode_batches(model, tok, sources, batch_size,
                                      max_src_len, bf16, dev, devices,
                                      _greedy_batch):
        out += [tok.decode(_truncate_at_sep(res["seqs"][i]))
                for i in range(len(batch))]
    return out


def predict_beam(model: Rxn, tok: SmilesTokenizer, sources: list[str],
                 k: int = 3, batch_size: int = 32, max_src_len: int = 150,
                 bf16: bool = True, device: DeviceLike = None,
                 devices=None) -> list[list[str]]:
    """Per-source deterministic k-beam decode (stop_count k**2); the top-k
    candidate strings of each source, the finished ones, or all k live
    beams if none finished.  Sources are padded, never truncated (module
    docstring)."""
    dev = resolve_device(device)
    check_on(model, dev)
    spec = BeamSpec(k=k, stop_count=k * k)
    out: list[list[str]] = []
    for batch, res in _decode_batches(
            model, tok, sources, batch_size, max_src_len, bf16, dev, devices,
            functools.partial(_beam_batch, spec=spec)):
        seqs, lengths, n_fin = res["seqs"], res["lengths"], res["n_finished"]
        for i in range(len(batch)):
            n_avail = k if n_fin[i] == 0 else min(k, int(n_fin[i]))
            out.append([tok.decode(seqs[i, j, :max(int(lengths[i, j]) - 1, 1)])
                        for j in range(n_avail)])
    return out
