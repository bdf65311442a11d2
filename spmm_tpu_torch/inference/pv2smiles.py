"""PV -> SMILES k-beam generation (counterpart of ``spmm_tpu.inference.pv2smiles``).

Two workloads over the same beam search:
  - single-query (``generate_with_property``): one (possibly partially
    masked) property vector, ``n_generate`` independent beam searches
    (reference d_pv2smiles_single.py:55-111);
  - batched/file mode (``generate_batched``): one PV per molecule, no
    property masking, deterministic k-beam with stop_count=k (reference
    d_pv2smiles_batched.py:17-59).

With ``devices`` (a list of cards, e.g. ``parallel.mesh.auto_mesh()``,
or a started ``parallel.replicas.WorkerPool``) each batch's rows are split
into one contiguous block per entry, each decoded by that entry's replica
of the model in a worker process of its own (``parallel.replicas``), and
joined in row order: the counterpart of the JAX functions' ``mesh=``.  The
batch must divide over the entries.  A stochastic search draws its noise
for the whole batch in every worker and keeps its own rows', so a sharded
batch draws what the unsharded one draws.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import random
from typing import Optional

import numpy as np
import torch

from spmm_tpu_torch.inference.decoding import (
    BeamSpec, beam_search_batched, torch_uniforms)
from spmm_tpu_torch.models.bert import BertForMaskedLM
from spmm_tpu_torch.models.spmm import N_PROPERTIES, SPMM
from spmm_tpu_torch.parallel.replicas import Replicas, concat_rows
from spmm_tpu_torch.tokenizer import SmilesTokenizer
from spmm_tpu_torch.utils.device import check_on, resolve_device
from spmm_tpu_torch.utils.spans import span

Tensor = torch.Tensor


def encode_pv(model: SPMM, pv_normalized: Tensor,
              prop_mask: Optional[Tensor]) -> Tensor:
    """PV [B, 53] (+ mask, 1 = masked) -> property-encoder hiddens [B, 54, H]
    (reference d_pv2smiles_single.py:69-76)."""
    return model.encode_properties(model.embed_properties(pv_normalized,
                                                          prop_mask))


def decoder_for(model, bf16: bool) -> BertForMaskedLM:
    """The decoder a search runs, ``model.text_encoder`` of an SPMM or a
    reaction model: the model's own in fp32, a bf16 copy with ``bf16``
    (fp32 LayerNorm, scores and softmax are kept).  Make it once per
    service or call, not per batch."""
    if not bf16:
        return model.text_encoder
    return copy.deepcopy(model.text_encoder).to(torch.bfloat16)


@torch.no_grad()
def _beam_batch(model: SPMM, decoder: BertForMaskedLM, pv: Tensor,
                prop_mask: Optional[Tensor], spec: BeamSpec,
                generator: Optional[torch.Generator] = None,
                kv_fp8: bool = False, uniforms=None) -> dict:
    """Batched beam search from normalized PVs [B, 53].

    ``decoder`` (see ``decoder_for``) sets the decoder's dtype: with a bf16
    decoder the encoder output enters in bf16 and the KV cache is bf16 —
    the property encoder itself stays fp32.  ``kv_fp8`` stores the KV cache
    in float8_e4m3fn (compute stays bf16/fp32).  ``uniforms`` (step ->
    noise) replaces the generator's draws in the stochastic mode."""
    with span("spmm.pv2smiles.batch"):
        with span("spmm.pv2smiles.encode"):
            prop_embeds = encode_pv(model, pv, prop_mask)        # [B, 54, H]
        cross_mask = torch.ones(prop_embeds.shape[:2], dtype=torch.int32,
                                device=pv.device)
        dtype = next(decoder.parameters()).dtype
        prop_embeds = prop_embeds.to(dtype)
        cache_dtype = torch.float8_e4m3fn if kv_fp8 else dtype
        return beam_search_batched(decoder, model.text_cfg, prop_embeds,
                                   cross_mask, spec, uniforms=uniforms,
                                   generator=generator,
                                   cache_dtype=cache_dtype)


def with_decoder(model, bf16: bool) -> tuple:
    """(model, ``decoder_for(model, bf16)``): what a worker of
    ``replicas_for`` holds."""
    return model, decoder_for(model, bf16)


def replicas_for(model: SPMM, devices, bf16: bool = True) -> Replicas:
    """(model, its decoder) in a worker for every entry of ``devices``."""
    return Replicas(model, devices, functools.partial(with_decoder,
                                                      bf16=bf16))


def _beam_shard(pair, dev, rows: slice, pv: Tensor,
                prop_mask: Optional[Tensor], *, spec: BeamSpec, b: int,
                kv_fp8: bool, state: Optional[np.ndarray]) -> tuple:
    """One worker's block of ``beam_rows``: (host result, the generator's
    state after it, or None).  ``state`` (the caller's generator's state
    as bytes) seeds a generator that draws all ``b`` rows' noise at each
    step, of which this block keeps ``rows``."""
    model, decoder = pair
    gen = uniforms = None
    if spec.stochastic:
        gen = torch.Generator(device=dev)
        gen.set_state(torch.from_numpy(state))
        draw = torch_uniforms(gen, b, spec.k, model.text_cfg.vocab_size, dev)

        def uniforms(step):
            return draw(step)[rows]
    res = to_host(_beam_batch(model, decoder, pv, prop_mask, spec,
                              kv_fp8=kv_fp8, uniforms=uniforms))
    return res, None if gen is None else gen.get_state()


def beam_rows(replicas: Replicas, pv: np.ndarray,
              prop_mask: Optional[np.ndarray], spec: BeamSpec,
              generator: Optional[torch.Generator],
              kv_fp8: bool = False) -> dict:
    """``_beam_batch`` of normalized PVs [B, 53] (host arrays) split over
    ``replicas``' workers; the host result in row order.

    In the stochastic mode every worker starts from ``generator``'s state,
    draws the noise of all B rows at each step and keeps its own rows';
    ``generator`` is then left where the worker that ran the most steps
    left it, which is where the unsharded batch leaves it."""
    state = generator.get_state().numpy() if spec.stochastic else None
    parts = replicas.map(_beam_shard, pv, prop_mask, spec=spec,
                         b=pv.shape[0], kv_fp8=kv_fp8, state=state)
    if spec.stochastic:
        last = max(parts, key=lambda p: p[0]["steps"])[1]
        generator.set_state(torch.from_numpy(last))
    return concat_rows([p[0] for p in parts])


def _decode_beams(tok: SmilesTokenizer, result: dict, i: int, k: int,
                  stochastic: bool, py_rng: random.Random) -> str:
    """Pick query i's output from its top-k beams (reference
    d_pv2smiles_single.py:102-110: deterministic takes the best, stochastic
    picks uniformly among the finished; sequences decode as sentence[:-1]
    with '[CLS]' removed).  ``result`` holds host numpy arrays."""
    n_fin = int(result["n_finished"][i])
    seqs = result["seqs"][i]
    lens = result["lengths"][i]
    n_avail = k if n_fin == 0 else min(k, n_fin)
    choice = 0 if not stochastic else py_rng.randrange(n_avail)
    ids = seqs[choice][: max(int(lens[choice]) - 1, 1)]   # strip trailing SEP
    return tok.decode(ids)


def to_host(result: dict) -> dict:
    with span("spmm.to_host"):
        return {key: (v.cpu().numpy() if isinstance(v, Tensor) else v)
                for key, v in result.items()}


def generate_with_property(
    model: SPMM,
    tok: SmilesTokenizer,
    pv_normalized: np.ndarray,        # [53] already z-normalized
    prop_mask: np.ndarray,            # [53] 1 = masked
    n_generate: int = 1000,
    k: int = 2,
    stochastic: bool = True,
    seed: int = 0,
    device_batch: int = 128,
    kv_fp8: bool = False,
    device=None,
    devices=None,
) -> list[str]:
    """Single-query workload: n_generate beam searches over one condition.
    With ``devices`` each batch of ``device_batch`` is split over them."""
    dev = resolve_device(device)
    check_on(model, dev)
    spec = BeamSpec(k=k, stop_count=k * k, stochastic=stochastic)
    py_rng = random.Random(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pv = np.tile(np.asarray(pv_normalized, np.float32), (device_batch, 1))
    mask = np.tile(np.asarray(prop_mask, np.float32), (device_batch, 1))
    with _searcher(model, devices, device_batch, spec, gen, kv_fp8,
                   dev) as search:
        out: list[str] = []
        for start in range(0, n_generate, device_batch):
            n = min(device_batch, n_generate - start)
            result = search(pv, mask)
            for i in range(n):
                out.append(_decode_beams(tok, result, i, k, stochastic,
                                         py_rng))
    return out


@contextlib.contextmanager
def _searcher(model: SPMM, devices, device_batch: int, spec: BeamSpec,
              gen: torch.Generator, kv_fp8: bool, dev: torch.device):
    """A function (pv, mask) host arrays -> host result of one batch (bf16
    decoder): on ``model``'s card, or split over ``devices``."""
    if devices is None:
        decoder = decoder_for(model, bf16=True)

        def search(pv, mask):
            return to_host(_beam_batch(
                model, decoder, torch.as_tensor(pv, device=dev),
                None if mask is None else torch.as_tensor(mask, device=dev),
                spec, gen, kv_fp8))
        yield search
        return
    with replicas_for(model, devices) as replicas:
        replicas.check_batch(device_batch)
        yield lambda pv, mask: beam_rows(replicas, pv, mask, spec, gen,
                                         kv_fp8)


def generate_batched(
    model: SPMM,
    tok: SmilesTokenizer,
    pvs_normalized: np.ndarray,       # [N, 53]
    k: int = 2,
    stochastic: bool = False,
    seed: int = 0,
    device_batch: int = 128,
    kv_fp8: bool = False,
    device=None,
    devices=None,
) -> list[str]:
    """File-mode workload: one k-beam per molecule, stop_count=k, no
    property masking (reference d_pv2smiles_batched.py); always the best
    beam (reference d_pv2smiles_batched.py:57).  With ``devices`` each
    batch of ``device_batch`` (the last one padded to it) is split over
    them."""
    dev = resolve_device(device)
    check_on(model, dev)
    spec = BeamSpec(k=k, stop_count=k, stochastic=stochastic)
    py_rng = random.Random(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_total = pvs_normalized.shape[0]
    out: list[str] = []
    with _searcher(model, devices, device_batch, spec, gen, kv_fp8,
                   dev) as search:
        for start in range(0, n_total, device_batch):
            n = min(device_batch, n_total - start)
            chunk = np.zeros((device_batch, N_PROPERTIES), np.float32)
            chunk[:n] = pvs_normalized[start: start + n]
            result = search(chunk, None)
            for i in range(n):
                out.append(_decode_beams(tok, result, i, k, False, py_rng))
    return out
