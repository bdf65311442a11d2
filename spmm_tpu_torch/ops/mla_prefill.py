"""Latent-attention (MLA) prefill attention in the expanded form: the fused
attention of the latent MoE model's prefill
(``csrc/mla_prefill_attention.cu``).

Each segment (row, start, count, offset into q) is ``count`` tokens of one
cache row at positions [start, start + count); each of its tokens attends,
in every head, the row's positions up to its own:

  s[t] = q_nope . k_nope[t] + q_pe . k_pe[t]      (scale folded in q)
  o    = softmax_t(s) . v[t],    [k_nope | v] = W_kvb c[t] a head

  q      [N, heads, nope + rope]        the tokens' queries, scaled
  cache  [rows, T, latent + rope]       a layer's cache [c | rope(k_pe)],
                                        the segments' positions written
  kv_b   [heads * (nope + v), latent]   W_kvb
  out    [N, heads * v]                 what W_o reads

On a card the segments go in groups (``plan``): the group's rows, sorted
by length, have their latents gathered and expanded by one product
(``W_kvb``) into [slots, keys, heads, nope + v], at most ``GROUP_BYTES``,
and one launch of the kernel attends every work item of the group (128
queries of a segment and head), skipping the key tiles wholly past its
diagonal.  ``LatentMoe.prefill`` plans once for all layers.  A CPU tensor
goes to the plain version, ``mla_prefill_attention_reference`` (a row and
1,024 queries at a time, scores in q's dtype, the softmax in fp32).
``mla_prefill_attention.launches`` counts the kernel's launches, one a
layer and group.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.nn.functional as F

from spmm_tpu_torch.ops._build import check_no_grad, count_launch

_lib = None
BLOCK_Q = 128            # queries a work item (the kernel's block)
BLOCK_K = 128            # keys a tile
GROUP_BYTES = 512 << 20  # a group's expansion at most (a longer row alone)
QUERY_BLOCK = 1024       # queries a score block of the plain version


@dataclass
class Group:
    """Segments (indices into the planned list) sharing one expansion of
    ``keys`` positions a slot, slot i the i-th segment; ``items`` its work
    items (slot, cache row, head, first query, queries, start, offset, key
    tiles), longest first; on a device, ``rows`` and ``table`` hold the
    slots' cache rows and the items."""
    keys: int
    segments: list = field(default_factory=list)
    items: list = field(default_factory=list)
    rows: Optional[torch.Tensor] = None
    table: Optional[torch.Tensor] = None


def key_tiles(start: int, q0: int, nq: int) -> int:
    """Key tiles that queries [q0, q0 + nq) of a segment at ``start``
    attend: every tile up to the one holding their last key."""
    return -(-(start + q0 + nq) // BLOCK_K)


def plan(segments: list, heads: int, key_bytes: int,
         budget: int = GROUP_BYTES, device=None) -> list:
    """The groups of ``segments`` ((row, start, count, offset) each):
    segments by their keys (start + count), longest first, into groups
    whose expansion (slots x the first's keys x ``key_bytes``) stays within
    ``budget`` (a segment beyond it alone); each group's items by segment,
    head, and query tile from the last.  With ``device``, each group's
    rows and items as tensors there."""
    order = sorted((i for i, s in enumerate(segments) if s[2] > 0),
                   key=lambda i: -(segments[i][1] + segments[i][2]))
    groups = []
    for i in order:
        g = groups[-1] if groups else None
        if g is None or (len(g.segments) + 1) * g.keys * key_bytes > budget:
            g = Group(keys=segments[i][1] + segments[i][2])
            groups.append(g)
        g.segments.append(i)
    for g in groups:
        for slot, i in enumerate(g.segments):
            row, start, count, off = segments[i]
            for h in range(heads):
                for q0 in reversed(range(0, count, BLOCK_Q)):
                    nq = min(BLOCK_Q, count - q0)
                    g.items.append((slot, row, h, q0, nq, start, off,
                                    key_tiles(start, q0, nq)))
        if device is not None:
            g.rows = torch.tensor([segments[i][0] for i in g.segments],
                                  device=device)
            g.table = torch.tensor(g.items, dtype=torch.int32, device=device)
    return groups


def _library():
    global _lib
    if _lib is None:
        from spmm_tpu_torch.ops import _build

        lib = _build.load("mla_prefill_attention")
        lib.mla_prefill_launch.restype = ctypes.c_int
        lib.mla_prefill_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
            + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
        lib.mla_prefill_prepare.restype = ctypes.c_int
        dims = (ctypes.c_int * 8)()
        lib.mla_prefill_dims(dims)
        lib.dims = tuple(dims)
        if lib.dims[5:] != (BLOCK_Q, BLOCK_K, 8):
            raise RuntimeError(f"mla_prefill_attention's blocks "
                               f"{lib.dims[5:]} are not the plan's")
        err = lib.mla_prefill_prepare()
        if err != 0:
            raise RuntimeError(f"mla_prefill_attention cannot load: CUDA "
                               f"error {err}")
        _lib = lib
    return _lib


def _check(q, cache, kv_b, nope) -> tuple:
    if q.dim() != 3 or cache.dim() != 3 or kv_b.dim() != 2:
        raise ValueError(f"q [N, heads, D], cache [rows, T, latent + rope], "
                         f"kv_b [heads * (nope + v), latent]; got "
                         f"{tuple(q.shape)}, {tuple(cache.shape)}, "
                         f"{tuple(kv_b.shape)}")
    heads, rope = q.shape[1], q.shape[2] - nope
    latent = kv_b.shape[1]
    if cache.shape[2] != latent + rope or kv_b.shape[0] % heads:
        raise ValueError(f"q {tuple(q.shape)}, cache {tuple(cache.shape)} "
                         f"and kv_b {tuple(kv_b.shape)} disagree")
    devices = {t.device for t in (q, cache, kv_b)}
    if len(devices) != 1:
        raise ValueError(f"all tensors must share one device, got {devices}")
    return heads, rope, kv_b.shape[0] // heads - nope, latent


def mla_prefill_attention(q: torch.Tensor, cache: torch.Tensor,
                          kv_b: torch.Tensor, segments: list, nope: int,
                          groups: Optional[list] = None) -> torch.Tensor:
    """The segments' attention; returns [N, heads * v] in q's dtype.  On a
    card ``groups`` is ``plan``'s for these segments on q's device (planned
    here if None)."""
    heads, rope, v, latent = _check(q, cache, kv_b, nope)
    if q.device.type == "cpu":
        return mla_prefill_attention_reference(q, cache, kv_b, segments,
                                               nope)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_no_grad("mla_prefill_attention", q, cache, kv_b)
    lib = _library()
    widths = (heads, nope, rope, v, latent)
    if widths != lib.dims[:5]:
        raise ValueError(f"kernel takes (heads, nope, rope, v, latent) "
                         f"{lib.dims[:5]}, got {widths}")
    if (q.dtype, cache.dtype, kv_b.dtype) != (torch.bfloat16,) * 3:
        raise TypeError(f"q, cache and kv_b must be bf16, got {q.dtype}, "
                        f"{cache.dtype}, {kv_b.dtype}")
    if not q.is_contiguous() or cache.stride()[1:] != (latent + rope, 1):
        raise ValueError("q must be contiguous and each cache row's "
                         "positions contiguous")
    if q.data_ptr() % 16 or cache.data_ptr() % 16 or cache.stride(0) % 8:
        raise ValueError("q and cache rows must be 16-byte aligned")
    if groups is None:
        groups = plan(segments, heads, heads * (nope + v) * q.element_size(),
                      device=q.device)
    out = torch.empty((q.shape[0], heads * v), dtype=q.dtype,
                      device=q.device)
    for g in groups:
        launch(q, expand(cache, kv_b, g), cache, g, out)
    return out


mla_prefill_attention.launches = 0


def expand(cache: torch.Tensor, kv_b: torch.Tensor,
           group: Group) -> torch.Tensor:
    """The group's expansion [slots, keys, heads * (nope + v)]: its rows'
    first ``keys`` latents gathered and multiplied by W_kvb at once."""
    return F.linear(cache[group.rows, :group.keys, :kv_b.shape[1]], kv_b)


def launch(q: torch.Tensor, kvb: torch.Tensor, cache: torch.Tensor,
           group: Group, out: torch.Tensor) -> None:
    """One launch of the kernel over the group's items, writing their rows
    of ``out``."""
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mla_prefill_launch(
            q.data_ptr(), kvb.data_ptr(), cache.data_ptr(),
            group.table.data_ptr(), out.data_ptr(), len(group.items),
            group.keys, cache.stride(0), math.log2(math.e), stream)
    if err != 0:
        raise RuntimeError(f"mla_prefill_attention launch failed: CUDA error "
                           f"{err}")
    count_launch(mla_prefill_attention)


def mla_prefill_attention_reference(q: torch.Tensor, cache: torch.Tensor,
                                    kv_b: torch.Tensor, segments: list,
                                    nope: int) -> torch.Tensor:
    """Plain PyTorch version: a row at a time, its positions expanded by
    W_kvb, scores in q's dtype over ``QUERY_BLOCK`` queries at a time (the
    shared rotated key one product for all heads), masked past each
    query's own position, the softmax computed in fp32 and rounded to q's
    dtype for the value product."""
    heads = q.shape[1]
    latent = kv_b.shape[1]
    v_dim = kv_b.shape[0] // heads - nope
    qt = q.transpose(0, 1)                                 # [nh, N, D]
    q_nope, q_pe = qt[..., :nope], qt[..., nope:]
    out = torch.empty((q.shape[0], heads * v_dim), dtype=q.dtype,
                      device=q.device)
    for row, start, count, off in segments:
        n_keys = start + count
        rows = cache[row, :n_keys]                         # [L, r + dr]
        kvb = F.linear(rows[:, :latent], kv_b).view(n_keys, heads, -1)
        k_nope = kvb[..., :nope].permute(1, 2, 0)          # [nh, dn, L]
        v = kvb[..., nope:].transpose(0, 1)                # [nh, L, dv]
        k_pe = rows[:, latent:].t()                        # [dr, L], shared
        for lo in range(0, count, QUERY_BLOCK):
            hi = min(lo + QUERY_BLOCK, count)
            a, b = off + lo, off + hi
            s = torch.matmul(q_pe[:, a:b], k_pe).baddbmm_(
                q_nope[:, a:b], k_nope)                    # [nh, b, L]
            # the causal part: the run's own keys past each query
            future = (torch.arange(count, device=q.device)[None, :]
                      > torch.arange(lo, hi, device=q.device)[:, None])
            s[..., start:].masked_fill_(future, float("-inf"))
            p = torch.softmax(s, -1)                       # fp32 inside
            ctx = torch.matmul(p, v)                       # [nh, b, dv]
            out[a:b] = ctx.transpose(0, 1).reshape(hi - lo, heads * v_dim)
    return out
