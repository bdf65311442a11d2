"""Latent-attention (MLA) decode attention in the absorbed form: kernel 3
of the port (``csrc/mla_decode_attention.cu``).

One call a decoder layer a step, over a batch of rows each at its own
length:

  s[b, h, t] = (q[b, h] . cache[b, t]) * scale,  t < lens[b]
  o[b, h]    = softmax_t(s[b, h]) . cache[b, :lens[b], :latent]

  q      [B, heads, latent + rope]  bf16: [W_uk^T q_nope | rope(q_pe)]
  cache  [B, T, latent + rope]      bf16: [c | rope(k_pe)] a token (a layer's
                                    slice of the session cache, written
                                    at the step's positions before the call)
  lens   [B]                        valid positions a row, in [1, T]
  out    [B, heads, latent]         bf16

Scores and the softmax are fp32; the probabilities enter the second product
in bf16.  A CUDA tensor goes to the kernel (16 heads, latent 512, rope 64)
and only there; a CPU tensor to the plain PyTorch version
``mla_decode_attention_reference``.  ``mla_decode_attention.launches``
counts calls (each launches the attention kernel and its combine).
"""

from __future__ import annotations

import ctypes
import math

import torch

from spmm_tpu_torch.ops._build import check_no_grad, count_launch

_lib = None
PLAIN_ROWS = 16          # rows the plain version takes at a time on a card


def _library():
    global _lib
    if _lib is None:
        from spmm_tpu_torch.ops import _build

        lib = _build.load("mla_decode_attention")
        lib.mla_launch.restype = ctypes.c_int
        lib.mla_launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_float, ctypes.c_void_p])
        for name in ("mla_split", "mla_heads", "mla_latent", "mla_rope",
                     "mla_prepare"):
            getattr(lib, name).restype = ctypes.c_int
        err = lib.mla_prepare()
        if err != 0:
            raise RuntimeError(f"mla_decode_attention cannot load: CUDA "
                               f"error {err}")
        _lib = lib
    return _lib


def prepare(cache: torch.Tensor) -> None:
    """Load the kernel and raise its shared-memory limit on ``cache``'s
    device, launching nothing: done before a CUDA graph captures a launch
    (the first load raises it on the device current then)."""
    with torch.cuda.device(cache.device):
        err = _library().mla_prepare()
    if err != 0:
        raise RuntimeError(f"mla_decode_attention cannot load: CUDA error "
                           f"{err}")


def _check(q, cache, lens, latent) -> None:
    if q.dim() != 3 or cache.dim() != 3 or lens.dim() != 1:
        raise ValueError(f"q [B, heads, D], cache [B, T, D], lens [B]; got "
                         f"{tuple(q.shape)}, {tuple(cache.shape)}, "
                         f"{tuple(lens.shape)}")
    b, _, d = q.shape
    if cache.shape[0] != b or cache.shape[2] != d or lens.shape[0] != b:
        raise ValueError(f"q {tuple(q.shape)}, cache {tuple(cache.shape)} "
                         f"and lens {tuple(lens.shape)} disagree")
    if not 0 < latent <= d:
        raise ValueError(f"latent {latent} outside (0, {d}]")
    devices = {t.device for t in (q, cache, lens)}
    if len(devices) != 1:
        raise ValueError(f"all tensors must share one device, got {devices}")


def mla_decode_attention(q: torch.Tensor, cache: torch.Tensor,
                         lens: torch.Tensor, latent: int,
                         scale: float) -> torch.Tensor:
    """Absorbed latent attention of each row over its first ``lens[b]``
    cache positions; returns [B, heads, latent] in q's dtype."""
    _check(q, cache, lens, latent)
    if cache.device.type == "cpu":
        return mla_decode_attention_reference(q, cache, lens, latent, scale)
    if cache.device.type != "cuda":
        raise ValueError(f"no kernel for device {cache.device}")
    check_no_grad("mla_decode_attention", q, cache)
    lib = _library()
    b, heads, d = q.shape
    T = cache.shape[1]
    if (heads != lib.mla_heads() or latent != lib.mla_latent()
            or d != latent + lib.mla_rope()):
        raise ValueError(f"kernel takes {lib.mla_heads()} heads, latent "
                         f"{lib.mla_latent()} and rope {lib.mla_rope()}, got "
                         f"{heads}, {latent}, {d - latent}")
    if q.dtype != torch.bfloat16 or cache.dtype != torch.bfloat16:
        raise TypeError(f"q and cache must be bf16, got {q.dtype}, "
                        f"{cache.dtype}")
    if not q.is_contiguous() or cache.stride()[1:] != (d, 1):
        raise ValueError("q must be contiguous and each cache row's "
                         "positions contiguous")
    if cache.data_ptr() % 16 or q.data_ptr() % 16 or cache.stride(0) % 8:
        raise ValueError("q and cache rows must be 16-byte aligned")
    lens32 = lens.to(torch.int32)
    splits = -(-T // lib.mla_split())
    part_o = torch.empty((b, splits, heads, latent), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((b, splits, heads, 2), dtype=torch.float32,
                          device=q.device)
    out = torch.empty((b, heads, latent), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mla_launch(q.data_ptr(), cache.data_ptr(),
                             lens32.data_ptr(), part_o.data_ptr(),
                             part_ml.data_ptr(), out.data_ptr(), b,
                             cache.stride(0), splits,
                             scale * math.log2(math.e), stream)
    if err != 0:
        raise RuntimeError(f"mla_decode_attention launch failed: CUDA error "
                           f"{err}")
    count_launch(mla_decode_attention)
    return out


mla_decode_attention.launches = 0


def mla_decode_attention_reference(q: torch.Tensor, cache: torch.Tensor,
                                   lens: torch.Tensor, latent: int,
                                   scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: fp32 scores and softmax over
    each row's first ``lens[b]`` positions, fp32 products, the result cast
    to q's dtype; rows a few at a time on a card."""
    b, T = q.shape[0], cache.shape[1]
    step = b if cache.device.type == "cpu" else PLAIN_ROWS
    t = torch.arange(T, device=cache.device)
    out = []
    for lo in range(0, b, step):
        hi = min(lo + step, b)
        kv = cache[lo:hi].float()
        s = torch.einsum("bhd,btd->bht", q[lo:hi].float(), kv) * scale
        s = s.masked_fill((t[None, :] >= lens[lo:hi, None])[:, None],
                          float("-inf"))
        p = torch.softmax(s, -1)
        out.append(torch.einsum("bht,btd->bhd", p, kv[..., :latent]))
    return torch.cat(out).to(q.dtype)
