"""Decoder-step cross-attention: kernel 4 of the port.

One call per fusion layer per token step of ``inference.decoding``'s beam
and greedy decodes: the k beam queries of each molecule attend its encoder
K/V (the cross K/V that ``precompute_cross_kv`` made once per decode):

  ctx = softmax(q . K^T / sqrt(D) + (1 - mask) * -10000) . V

at the plain route's precision (fp32 scores, mask and softmax, the
probabilities in V's dtype, fp32 sums, ctx in V's dtype).  The JAX package
leaves this to XLA (spmm_tpu/inference/decoding.py:324-331); no Pallas
kernel stands behind it.

Shapes and types:

  q     [m*k, ..., h*D]  the query projection's rows (beam b of molecule i
                         is row i*k + b), f32 or bf16
  k, v  [m, h, Le, D]    one fusion layer of the cross K/V, q's dtype
  mask  [m, Le]          binary: float32, int32, int64 or bool
  ctx   q's shape        what the output dense reads

k, h, Le and D are read off the shapes.  A CUDA tensor goes to the
hand-written kernel (csrc/decode_cross_attention.cu) and only there: a shape
or dtype it does not take raises, and so does a call that would need a
gradient.  A CPU tensor goes to the plain version
``decode_cross_attention_reference``, which is the step's plain route,
``ops.attention.multi_head_attention``.  ``decode_cross_attention.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from spmm_tpu_torch.ops._build import check_no_grad, count_launch
from spmm_tpu_torch.ops.attention import multi_head_attention
from spmm_tpu_torch.ops.masks import MASK_VALUE

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK_CODES = {torch.float32: 0, torch.int32: 1, torch.int64: 2,
               torch.bool: 3}
_lib = None


def _library():
    global _lib
    if _lib is None:
        from spmm_tpu_torch.ops import _build

        lib = _build.load("decode_cross_attention")
        lib.dca_launch.restype = ctypes.c_int
        lib.dca_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int,
                                                      ctypes.c_void_p]
            + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        for name in ("dca_max_beams", "dca_max_keys", "dca_max_head_dim"):
            getattr(lib, name).restype = ctypes.c_int
        lib.dca_occupancy.restype = ctypes.c_int
        lib.dca_occupancy.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
        _lib = lib
    return _lib


def build() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def prepare(k: torch.Tensor, beams: int) -> None:
    """Load the kernel for the cross K/V ``k`` ([..., h, Le, D] on a card)
    and ``beams`` queries a molecule, and size its grid, launching nothing
    (the occupancy query runs what a launch runs first): done before a
    CUDA graph captures a launch.  Raises where a launch would."""
    le, d = k.shape[-2:]
    info = (ctypes.c_int * 2)()
    with torch.cuda.device(k.device):
        err = _library().dca_occupancy(_DTYPE_CODES[k.dtype], beams, le, d,
                                       info)
    if err != 0:
        raise RuntimeError(f"decode_cross_attention cannot launch at "
                           f"k={beams}, Le={le}, D={d}: CUDA error {err}")


def decode_cross_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor,
                                     mask: torch.Tensor) -> torch.Tensor:
    """The plain route: ``multi_head_attention(impl="plain")`` over the
    molecule's k queries, its additive mask made from the binary one."""
    m, h, _, d = k.shape
    beams = q.shape[0] // m
    qx = q.reshape(m, beams, h, d).transpose(1, 2)
    xmask = ((1.0 - mask.float()) * MASK_VALUE)[:, None, None, :]
    ctx = multi_head_attention(qx, k.to(qx.dtype), v.to(qx.dtype), xmask)
    return ctx.transpose(1, 2).reshape(q.shape)


def _check(q, k, v, mask) -> int:
    """The beams a molecule, after the shapes, dtypes and device are
    checked."""
    if k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be one [m, h, Le, D], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    m, h, le, d = k.shape
    if q.dim() < 2 or q.shape[0] % m or q.shape[-1] != h * d or \
            q.numel() != q.shape[0] * h * d:
        raise ValueError(f"q must be [m*k, ..., h*D] with m={m}, "
                         f"h*D={h * d}, got {tuple(q.shape)}")
    if tuple(mask.shape) != (m, le):
        raise ValueError(f"mask must be {(m, le)}, got {tuple(mask.shape)}")
    devices = {t.device for t in (q, k, v, mask)}
    if len(devices) != 1:
        raise ValueError(f"all tensors must share one device, got {devices}")
    return q.shape[0] // m


def decode_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """One fusion layer's cross-attention for a decoder step; returns ctx
    in q's shape and dtype."""
    beams = _check(q, k, v, mask)
    if q.device.type == "cpu":
        return decode_cross_attention_reference(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_no_grad("decode_cross_attention", q, k, v)
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"q, k and v must be one of {list(_DTYPE_CODES)}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if mask.dtype not in _MASK_CODES:
        raise TypeError(f"mask dtype {mask.dtype} is not one of "
                        f"{list(_MASK_CODES)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("mask", mask)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16 and name != "mask":
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"reads its rows in 16-byte pieces)")
    lib = _library()
    m, h, le, d = k.shape
    if beams > lib.dca_max_beams() or le > lib.dca_max_keys() or d % 32 \
            or d > lib.dca_max_head_dim():
        raise ValueError(f"kernel takes k <= {lib.dca_max_beams()}, Le <= "
                         f"{lib.dca_max_keys()} and head_dim a multiple of "
                         f"32 up to {lib.dca_max_head_dim()}, got k={beams}, "
                         f"Le={le}, D={d}")
    ctx = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dca_launch(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                             v.data_ptr(), mask.data_ptr(),
                             _MASK_CODES[mask.dtype], ctx.data_ptr(), m, h,
                             beams, le, d, stream)
    if err != 0:
        raise RuntimeError(f"decode_cross_attention launch failed: CUDA "
                           f"error {err}")
    count_launch(decode_cross_attention)
    return ctx


decode_cross_attention.launches = 0
