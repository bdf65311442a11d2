"""fp32 linear layers on the tensor cores: ``y = x W^T + b`` from three TF32
products, the hand-written kernel of ``csrc/split_tf32_gemm.cu``.

The BERT layers' fp32 linears at inference (``models/bert.Linear``) come
here on a card.  Each operand is split into two TF32 parts (10 explicit
mantissa bits, rounded to nearest, ties away from zero, as ``cvt.rna``):

  x = x_hi + x_lo,  x_hi = tf32(x),  x'_lo = tf32((x - x_hi) * 2^11)
  y = x_hi W_hi^T + 2^-11 (x_hi W'_lo^T + x'_lo W_hi^T) + b

The low parts are scaled up by 2^11 so that they stay clear of fp32's
subnormals; the x_lo W_lo term lies below fp32's rounding and is left out
(Ootomo & Yokota, IJHPCA 2022).  A weight is split once, at its first
routed call, into ``parts`` [2 N, K] (W_hi over W'_lo), kept beside it and
made again when the weight is another tensor, moves or is written in place
(``weight_parts``, keyed by the tensor, its ``data_ptr`` and ``_version``).
x is split inside the kernel.

``split_linear`` launches the kernel, on fp32 CUDA tensors only (anything
else, or a shape it does not take, raises); ``split_linear_reference`` is
its plain version, the same three products in PyTorch.
``split_linear.launches`` counts launches.  Which calls come here at all is
decided by ``models/bert.Linear``.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Optional

import torch
import torch.nn.functional as F

from spmm_tpu_torch.ops._build import check_no_grad, count_launch

LO_SCALE = 2048.0        # 2^11, the low parts' scale
N_MULTIPLE = 96          # the kernel's tile of output columns
K_MULTIPLE = 32          # its depth a stage
_F32 = torch.float32

_lib = None
_raw_stream = None
# id(weight) -> (weak reference, _version, data_ptr, parts).  Held here and
# not on the Linear module: a model deep-copied or pickled for a worker
# process (parallel/replicas.py) must not carry the card's parts along.
_parts: dict = {}


def _library():
    global _lib, _raw_stream
    if _lib is None:
        from spmm_tpu_torch.ops import _build

        lib = _build.load("split_tf32_gemm")
        lib.stg_launch.restype = ctypes.c_int
        lib.stg_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.stg_plan.restype = ctypes.c_int
        lib.stg_plan.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)]
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        if _raw_stream is None:
            _raw_stream = lambda index: torch.cuda.current_stream(  # noqa: E731
                index).cuda_stream
        _lib = lib
    return _lib


def build() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def plan(m: int, n: int, k: int) -> dict:
    """The launch's split of K on the current card: ``splits`` (a cluster
    of that many blocks shares a tile), ``blocks`` and the clusters of that
    size that fit the card at once."""
    out = (ctypes.c_int * 3)()
    err = _library().stg_plan(m, n, k, out)
    if err != 0:
        raise RuntimeError(f"split_tf32_gemm cannot plan: CUDA error {err}")
    return {"splits": out[0], "blocks": out[1], "clusters": out[2]}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 explicit mantissa bits), to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32``: the magnitude's bits
    plus half a TF32 unit, the 13 low bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x_hi, x'_lo): x_hi = tf32(x), x'_lo = tf32((x - x_hi) * 2^11)."""
    hi = tf32_round(x)
    return hi, tf32_round((x - hi) * LO_SCALE)


def split_weight(weight: torch.Tensor) -> torch.Tensor:
    """``parts`` [2 N, K]: W_hi over W'_lo."""
    return torch.cat(split_tf32(weight.detach().float()))


def weight_parts(weight: torch.Tensor) -> torch.Tensor:
    """``weight``'s parts, split at its first call and kept until the
    weight is freed; split again once it moves or is written in place.
    Inside a CUDA graph capture a missing split is made for the graph
    alone (its work is captured, not run) and not kept."""
    entry = _parts.get(id(weight))
    if (entry is not None and entry[0]() is weight
            and entry[1] == weight._version
            and entry[2] == weight.data_ptr()):
        return entry[3]
    parts = split_weight(weight)
    if not (weight.is_cuda and torch.cuda.is_current_stream_capturing()):
        key = id(weight)
        ref = weakref.ref(weight, lambda _, key=key: _parts.pop(key, None))
        _parts[key] = (ref, weight._version, weight.data_ptr(), parts)
    return parts


def split_linear_reference(x: torch.Tensor, weight: torch.Tensor,
                           bias: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of the kernel's arithmetic: the TF32 parts by
    bit operations, their products in fp32 (a product of two TF32 values is
    exact in fp32), the correction products summed apart and scaled back in
    the epilogue."""
    x_hi, x_lo = split_tf32(x.float())
    w_hi, w_lo = split_tf32(weight.float())
    y = F.linear(x_hi, w_hi) + (
        F.linear(x_hi, w_lo) + F.linear(x_lo, w_hi)) / LO_SCALE
    return y if bias is None else y + bias.float()


def takes(n: int, k: int) -> bool:
    """The widths the kernel takes: N a multiple of its 96-column tile, K
    of its 32-deep stage."""
    return n % N_MULTIPLE == 0 and k % K_MULTIPLE == 0 and n > 0 and k > 0


def split_linear(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x W^T + b`` in fp32 on the tensor cores: x [..., K], weight
    [N, K], bias [N], fp32 CUDA tensors.  The host's work a call is kept to
    what ``F.linear``'s is: checks, one ``empty``, one ctypes call."""
    n, k = weight.shape
    if not x.is_cuda or x.dtype is not _F32 or weight.dtype is not _F32 or (
            bias is not None and bias.dtype is not _F32):
        raise TypeError("split_linear takes fp32 CUDA x, weight and bias")
    if x.shape[-1] != k or n % N_MULTIPLE or k % K_MULTIPLE:
        raise ValueError(f"split_linear takes N a multiple of {N_MULTIPLE} "
                         f"and K of {K_MULTIPLE}, x [..., K]; got weight "
                         f"{tuple(weight.shape)}, x {tuple(x.shape)}")
    check_no_grad("split_linear", x, weight, bias)
    lib = _lib or _library()
    x2 = x.reshape(-1, k)
    if x2.stride(1) != 1 or x2.stride(0) % 4 or x2.data_ptr() % 16:
        x2 = x2.contiguous()
    parts = weight_parts(weight)
    if bias is not None and not bias.is_contiguous():
        bias = bias.contiguous()
    y = x.new_empty((*x.shape[:-1], n))
    if x2.shape[0] == 0:
        return y
    index = x.get_device()
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(lib, x2, parts, bias, y, n, k, index)
    return _launch(lib, x2, parts, bias, y, n, k, index)


def _launch(lib, x2, parts, bias, y, n, k, index) -> torch.Tensor:
    err = lib.stg_launch(x2.data_ptr(), x2.stride(0), parts.data_ptr(),
                         None if bias is None else bias.data_ptr(),
                         y.data_ptr(), x2.shape[0], n, k, _raw_stream(index))
    if err != 0:
        raise RuntimeError(f"split_tf32_gemm launch failed: error {err}")
    count_launch(split_linear)
    return y


split_linear.launches = 0
