"""Fused beam-decode attention step: kernel 1 of the port.

Counterpart of spmm_tpu/ops/decode_attention.py ``beam_decode_attention``
(the Pallas TPU kernel).  One call per decoder layer per token step:

  - append: ``k_new`` / ``v_new`` are written into the cache at ``pos``, in
    place (JAX aliases the buffer with ``input_output_aliases``; here the
    caller's tensor is updated);
  - attend: per query beam, ctx = softmax([q.K_prefix/sqrt(D) + mask ;
    q.k_new/sqrt(D)]) . [V_prefix ; v_new] — one joint fp32 softmax over
    the prefix t < pos of all k cache lanes plus the dense self term.

Shapes and types (one cache layout for the kernel and its plain version,
the XLA-path layout of spmm_tpu/inference/decoding.py:69-87):

  q, k_new, v_new  [m, h, k, D]   f32 for an f32 cache, bf16 for bf16/fp8
  cache            [2, L, m, h, k, T, D]  f32 | bf16 | float8_e4m3fn
  mask             [m, k(beam), k(lane), T] fp32 additive, t >= pos masked
  pos, layer       Python ints

A CUDA tensor goes to the hand-written kernel (csrc/beam_decode_attention.cu)
and only there (a call that would need a gradient raises: the kernel has no
backward); a CPU tensor goes to the plain PyTorch version
``beam_decode_attention_reference``.  ``beam_decode_attention.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from spmm_tpu_torch.ops._build import check_no_grad, count_launch
from spmm_tpu_torch.ops.masks import MASK_VALUE

_CACHE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_lib = None


def compute_dtype(cache_dtype: torch.dtype) -> torch.dtype:
    """dtype of q/k_new/v_new/ctx for a cache dtype: probs@V never runs in
    fp8 (fp8 values widen exactly to bf16)."""
    return torch.bfloat16 if cache_dtype.itemsize == 1 else cache_dtype


def _library():
    global _lib
    if _lib is None:
        from spmm_tpu_torch.ops import _build

        lib = _build.load("beam_decode_attention")
        lib.bda_launch.restype = ctypes.c_int
        lib.bda_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
            + [ctypes.c_void_p])
        lib.bda_max_beams.restype = ctypes.c_int
        lib.bda_max_head_dim.restype = ctypes.c_int
        lib.bda_occupancy.restype = ctypes.c_int
        lib.bda_occupancy.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
        _lib = lib
    return _lib


def build() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def prepare(cache: torch.Tensor) -> None:
    """Load the kernel for ``cache``'s device and dtype and raise its
    shared-memory limit, launching nothing (the occupancy query runs what
    a launch runs first): done before a CUDA graph captures a launch, so
    that the capture sets no attribute.  Raises if a launch at the last
    position of ``cache`` would not fit."""
    _, _, _, _, k, T, d = cache.shape
    info = (ctypes.c_int * 2)()
    with torch.cuda.device(cache.device):
        err = _library().bda_occupancy(_CACHE_CODES[cache.dtype], k, d,
                                       T - 1, info)
    if err != 0:
        raise RuntimeError(f"beam_decode_attention cannot launch at k={k}, "
                           f"D={d}, pos {T - 1}: CUDA error {err}")


def _check(q, k_new, v_new, cache, mask, pos, layer) -> None:
    if cache.dim() != 7 or cache.shape[0] != 2:
        raise ValueError(f"cache must be [2, L, m, h, k, T, D], got "
                         f"{tuple(cache.shape)}")
    _, n_layers, m, h, k, T, d = cache.shape
    if cache.dtype not in _CACHE_CODES:
        raise TypeError(f"cache dtype {cache.dtype} is not one of "
                        f"{list(_CACHE_CODES)}")
    cdt = compute_dtype(cache.dtype)
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (m, h, k, d):
            raise ValueError(f"{name} must be {(m, h, k, d)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != cdt:
            raise TypeError(f"{name} must be {cdt} for a {cache.dtype} "
                            f"cache, got {t.dtype}")
    if tuple(mask.shape) != (m, k, k, T) or mask.dtype != torch.float32:
        raise ValueError(f"mask must be float32 {(m, k, k, T)}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if not (isinstance(pos, int) and 0 <= pos < T):
        raise ValueError(f"pos must be an int in [0, {T}), got {pos!r}")
    if not (isinstance(layer, int) and 0 <= layer < n_layers):
        raise ValueError(f"layer must be an int in [0, {n_layers}), got "
                         f"{layer!r}")
    devices = {t.device for t in (q, k_new, v_new, cache, mask)}
    if len(devices) != 1:
        raise ValueError(f"all tensors must share one device, got {devices}")


def beam_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                          v_new: torch.Tensor, cache: torch.Tensor,
                          mask: torch.Tensor, pos: int,
                          layer: int) -> torch.Tensor:
    """One layer's cache append + ancestry-masked beam attention.

    Returns ctx [m, h, k, D] in q's dtype; ``cache`` is updated in place
    with k_new / v_new at ``pos`` (lane l receives beam l's row)."""
    _check(q, k_new, v_new, cache, mask, pos, layer)
    if cache.device.type == "cpu":
        return beam_decode_attention_reference(q, k_new, v_new, cache, mask,
                                               pos, layer)
    if cache.device.type != "cuda":
        raise ValueError(f"no kernel for device {cache.device}")
    check_no_grad("beam_decode_attention", q, k_new, v_new, cache, mask)
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new),
                    ("cache", cache), ("mask", mask)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cache.data_ptr() % 16:
        raise ValueError("cache must be 16-byte aligned (the kernel copies "
                         "its rows in bulk)")
    lib = _library()
    _, n_layers, m, h, k, T, d = cache.shape
    if k > lib.bda_max_beams() or d % 32 or d > lib.bda_max_head_dim():
        raise ValueError(f"kernel takes k <= {lib.bda_max_beams()} and "
                         f"head_dim a multiple of 32 up to "
                         f"{lib.bda_max_head_dim()}, got k={k}, D={d}")
    ctx = torch.empty_like(q)
    with torch.cuda.device(cache.device):
        stream = torch.cuda.current_stream(cache.device).cuda_stream
        err = lib.bda_launch(
            _CACHE_CODES[cache.dtype], q.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), cache.data_ptr(), mask.data_ptr(),
            ctx.data_ptr(), n_layers, m, h, k, T, d, pos, layer, stream)
    if err != 0:
        raise RuntimeError(f"beam_decode_attention launch failed: CUDA "
                           f"error {err}")
    count_launch(beam_decode_attention)
    return ctx


beam_decode_attention.launches = 0


def beam_attention(q, k6, v6, mask, k_self, v_self) -> torch.Tensor:
    """Attention over the cached prefix plus the current token's own K/V
    (``_beam_attention`` of spmm_tpu/inference/decoding.py:122-168).

    q/k_self/v_self [m, h, k, D]; k6/v6 [m, h, k(lane), T, D]; mask
    [m, k(beam), k(lane), T].  fp32 scores and softmax; probabilities cast
    to the cache dtype before the V product."""
    d = q.shape[-1]
    scale = d ** -0.5
    s = torch.einsum("mhqd,mhltd->mhqlt", q.float(), k6.float())
    s = s * scale + mask[:, None]
    s_self = (q.float() * k_self.float()).sum(-1) * scale        # [m, h, k]
    m_, h_, kq = s_self.shape
    n_prefix = k6.shape[2] * k6.shape[3]            # may be 0 at pos = 0
    s_all = torch.cat([s.reshape(m_, h_, kq, n_prefix), s_self[..., None]],
                      dim=-1)
    mx = s_all.amax(dim=-1, keepdim=True)
    e = torch.exp(s_all - mx)
    p = e / e.sum(dim=-1, keepdim=True)
    p_pre = p[..., :-1].reshape(s.shape).to(v6.dtype)
    p_self = p[..., -1].to(v_self.dtype)
    ctx = torch.einsum("mhqlt,mhltd->mhlqd", p_pre, v6).sum(dim=2)
    return ctx + p_self[..., None] * v_self


def beam_decode_attention_reference(q, k_new, v_new, cache, mask, pos,
                                    layer) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``beam_attention`` over the
    live prefix t < pos (masked terms beyond it are exact zeros), then the
    indexed in-place append."""
    cdt = q.dtype
    k6 = cache[0, layer, :, :, :, :pos].to(cdt)
    v6 = cache[1, layer, :, :, :, :pos].to(cdt)
    ctx = beam_attention(q, k6, v6, mask[..., :pos], k_new, v_new)
    cache[0, layer, :, :, :, pos] = k_new.to(cache.dtype)
    cache[1, layer, :, :, :, pos] = v_new.to(cache.dtype)
    return ctx


def ancestry_mask(anc: torch.Tensor, key_valid: torch.Tensor) -> torch.Tensor:
    """Additive mask [m, k(beam), k(lane), T] selecting ancestor lanes
    (``_ancestry_mask``, decoding.py:107-119, without its head axis).

    Entry (m, b, l, t) is 0 where ``anc[m, b, t] == l`` and position t is
    valid for beam b, else -10000; masked entries underflow to exactly 0.0
    in the fp32 softmax."""
    m, k, T = anc.shape
    lanes = torch.arange(k, device=anc.device, dtype=anc.dtype)
    onehot = anc[:, :, None, :] == lanes[None, None, :, None]
    sel = onehot & key_valid[:, :, None, :].bool()
    return (1.0 - sel.float()) * MASK_VALUE
