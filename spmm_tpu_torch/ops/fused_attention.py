"""Fused multi-head attention: kernel 2 of the port.

Counterpart of spmm_tpu/ops/pallas_attention.py ``pallas_mha`` (the Pallas
TPU kernel, body ``_mha_kernel``):

  out = softmax(q . k^T / sqrt(D) + mask) . v

with fp32 scores and softmax, probabilities cast to v's dtype before the V
product (fp32 accumulation), and the output in q's dtype.  The mask is
head-uniform: like ``pallas_mha`` this takes ``additive_mask[:, 0]``,
broadcast to [B, Lq, Lk]; no mask adds zeros.

Shapes and types: q [B, h, Lq, D], k / v [B, h, Lk, D], all float32 or all
bfloat16, any Lk >= 1; additive_mask None or 4-D, broadcastable to
[B, *, Lq, Lk].  The source has three kernels, its routes: to
``fmha_max_keys()`` = 256 keys the short one; past that the long one, which
keeps an item's scores in shared memory, up to 1,152 keys in fp32 (1,408 in
bf16) at D=64; past that the streaming one, which splits each item's keys
over a thread-block cluster (bf16 on tensor cores).  ``launch_info`` says
which route and cluster a shape gets; ``fused_mha_stream`` forces the
streaming route at any Lk, for the card's tests and timings only.  No
dropout and no gradient: a CUDA call that would need one (grad enabled and
an input requiring it) raises, as the kernel has no backward; training runs
the plain attention, as JAX's training runs XLA's.

A CUDA tensor goes to the hand-written kernel (csrc/fused_attention.cu) and
only there; a CPU tensor goes to the plain PyTorch version
``fused_mha_reference``.  ``fused_mha.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from spmm_tpu_torch.ops._build import check_no_grad, count_launch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
ROUTES = ("short", "long", "stream")
STREAM = 2                      # the streaming kernel's route (fused_mha_stream)
_AUTO = -1                      # the route fmha_launch takes
_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a loaded kernel-2 library."""
    lib.fmha_launch.restype = ctypes.c_int
    lib.fmha_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    lib.fmha_max_keys.restype = ctypes.c_int
    if hasattr(lib, "fmha_launch_route"):     # not in an older source
        lib.fmha_launch_route.restype = ctypes.c_int
        lib.fmha_launch_route.argtypes = [ctypes.c_int] + lib.fmha_launch.argtypes
        lib.fmha_occupancy.restype = ctypes.c_int
        lib.fmha_occupancy.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return lib


def _library():
    global _lib
    if _lib is None:
        from spmm_tpu_torch.ops import _build

        _lib = bind(_build.load("fused_attention"))
    return _lib


def build() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def _head_mask(additive_mask: Optional[torch.Tensor], b: int, lq: int,
               lk: int) -> Optional[torch.Tensor]:
    """``additive_mask[:, 0]`` as an fp32 [B, Lq, Lk] view (broadcast axes
    keep stride 0), as pallas_mha collapses the head axis."""
    if additive_mask is None:
        return None
    if additive_mask.dim() != 4:
        raise ValueError(f"additive_mask must be 4-D [B, *, Lq, Lk], got "
                         f"{tuple(additive_mask.shape)}")
    return additive_mask[:, 0].float().expand(b, lq, lk)


def _check(q, k, v, additive_mask) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D [B, h, L, D]")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[-1] != d or v.shape != k.shape:
        raise ValueError(f"k and v must be [{b}, {h}, Lk, {d}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or all bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    tensors = (q, k, v) if additive_mask is None else (q, k, v, additive_mask)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all tensors must share one device, got {devices}")


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              additive_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused attention; returns [B, h, Lq, D] in q's dtype.

    On a CUDA tensor the result is a [B, Lq, h, D] buffer seen through a
    transpose, so that ``merge_heads`` of it is a view."""
    return _fused_mha(q, k, v, additive_mask, _AUTO)


def fused_mha_stream(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     additive_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """``fused_mha`` with a CUDA tensor sent to the streaming kernel at any
    Lk (``fmha_launch_route``), so that the card's tests and
    ``chip_smoke.py`` can hold and time it where the wrapper takes another
    route.  No model path calls it."""
    return _fused_mha(q, k, v, additive_mask, STREAM)


def launch_info(dtype: torch.dtype, d: int, b: int, h: int, lq: int, lk: int,
                route: int = _AUTO) -> dict:
    """The launch the kernel makes for these shapes (on ``route``, by
    default the wrapper's): its route name, cluster size, blocks per SM and
    dynamic shared memory, from ``fmha_occupancy``.  Needs the card."""
    info = (ctypes.c_int * 4)()
    err = _library().fmha_occupancy(route, _DTYPE_CODES[dtype], d, b, h, lq,
                                    lk, info)
    if err != 0:
        raise RuntimeError(f"fmha_occupancy failed: CUDA error {err}")
    return {"route": ROUTES[info[2]], "cluster": info[3],
            "blocks_per_sm": info[0], "dynamic_smem_bytes": info[1]}


def _fused_mha(q, k, v, additive_mask, route: int) -> torch.Tensor:
    _check(q, k, v, additive_mask)
    if q.device.type == "cpu":
        return fused_mha_reference(q, k, v, additive_mask)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_no_grad("fused_mha", q, k, v, additive_mask)
    b, h, lq, d = q.shape
    lk = k.shape[2]
    lib = _library()
    if d not in _HEAD_DIMS or lk < 1:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS} and Lk >= 1, "
                         f"got D={d}, Lk={lk}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along head_dim")
        if t.data_ptr() % 16 or any(s * t.element_size() % 16
                                    for s in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned, its rows too "
                             f"(the kernel copies 16-byte pieces)")
    out = torch.empty((b, lq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if b * h * lq == 0:
        return out
    mask = _head_mask(additive_mask, b, lq, lk)
    strides = [q.stride(0), q.stride(1), q.stride(2),
               k.stride(0), k.stride(1), k.stride(2),
               v.stride(0), v.stride(1), v.stride(2),
               out.stride(0), out.stride(1), out.stride(2)]
    strides += [0, 0, 0] if mask is None else list(mask.stride())
    c_strides = (ctypes.c_longlong * 15)(*strides)
    args = (_DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), b, h, lq, lk, c_strides, 1.0 / d ** 0.5)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = (lib.fmha_launch(*args, stream) if route == _AUTO
               else lib.fmha_launch_route(route, *args, stream))
    if err != 0:
        raise RuntimeError(f"fused_mha launch failed: CUDA error {err}")
    count_launch(fused_mha)
    return out


fused_mha.launches = 0


def fused_mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        additive_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (``_mha_kernel``'s arithmetic):
    fp32 scores scaled by 1/sqrt(D), the head-0 mask, fp32 softmax,
    probabilities in v's dtype, fp32 product, output in q's dtype."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / d ** 0.5)
    mask = _head_mask(additive_mask, b, lq, lk)
    if mask is not None:
        s = s + mask[:, None]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)
