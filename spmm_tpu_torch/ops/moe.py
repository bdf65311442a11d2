"""Routed SwiGLU experts, dropless: the expert products of the latent MoE
model's expert layers (``models/latent_moe.py``).

``route`` picks each token's experts (sigmoid scores in fp32, the choice by
the score plus a correction bias, the weights by the unbiased score,
normalised and scaled); ``routed_experts`` sums each token's chosen
experts' outputs, weighted:

  out[n] = sum_j w[n, j] * down_e(silu(gate_e x[n]) * up_e x[n]),
           e = idx[n, j]

  x [N, H] bf16, idx [N, k] int64, w [N, k] fp32,
  gate_up [E, 2 I, H] (gate rows first), down [E, H, I] bf16;
  out [N, H] fp32.

Nothing is dropped: every (token, expert) pair is computed.  On a card
the kernels of ``csrc/moe_experts.cu`` do the work: ``moe_route_kernel``
and ``moe_topk_kernel`` the router; then, the pairs sorted by expert into
blocks of ``block_m`` slots (``_align``, static shapes, no host read, so
a CUDA graph captures it), two launches of ``moe_product_kernel`` (a
grouped product whose block reads its expert's weight tiles once for up
to ``block_m`` pairs) compute the gated up-projection and the weighted
down-projection, and ``moe_combine_kernel`` sums each token's pairs.
Bound: the weights read (at decode, 128 tokens times 6 pairs touch nearly
all 64 experts of a layer); at prefill the products.  On the CPU the
plain versions ``route_reference`` and ``routed_experts_reference`` run
(the latter loops over the experts).  ``route.launches`` and
``routed_experts.launches`` count kernel launches (two a call of the
former, three of the latter).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from spmm_tpu_torch.ops._build import count_launch

_lib = None
DECODE_PAIRS = 4096      # pairs up to which a launch takes the decode tiling


def _library():
    global _lib
    if _lib is None:
        from spmm_tpu_torch.ops import _build

        lib = _build.load("moe_experts")
        lib.moe_route.restype = ctypes.c_int
        lib.moe_route.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                                  + [ctypes.c_float, ctypes.c_void_p])
        lib.moe_experts.restype = ctypes.c_int
        lib.moe_experts.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                                    + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        for name in ("moe_block_m", "moe_block_n", "moe_max_experts",
                     "moe_route_splits", "moe_prepare"):
            getattr(lib, name).restype = ctypes.c_int
        err = lib.moe_prepare()
        if err != 0:
            raise RuntimeError(f"moe_experts cannot load: CUDA error {err}")
        _lib = lib
    return _lib


def prepare(device) -> None:
    """Load the kernels and raise the products' shared-memory limits on
    ``device``, launching nothing: done before a CUDA graph captures a
    launch (the first load raises them on the device current then)."""
    with torch.cuda.device(device):
        err = _library().moe_prepare()
    if err != 0:
        raise RuntimeError(f"moe_experts cannot load: CUDA error {err}")


def _check_bf16(**tensors) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous() or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be contiguous bf16")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def route(x: torch.Tensor, gate: torch.Tensor, bias: torch.Tensor, k: int,
          scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(experts [N, k] int64, weights [N, k] fp32) of ``x`` [N, H]: scores
    sigmoid(x W_g^T) from fp32 inputs; the top k of scores + ``bias``, in
    descending order; weights s[chosen] / (sum + 1e-20) * ``scale``.  The
    kernel on a card, the plain version on the CPU."""
    if x.device.type == "cpu":
        return route_reference(x, gate, bias, k, scale)
    lib = _library()
    n, h = x.shape
    e = gate.shape[0]
    _check_bf16(x=x, gate=gate)
    if e > lib.moe_max_experts() or not 0 < k <= min(e, 32) or h % 64:
        raise ValueError(f"the router kernel takes up to "
                         f"{lib.moe_max_experts()} experts, k up to 32 and "
                         f"a width a multiple of 64; got {e}, {k}, {h}")
    bias = bias.float().contiguous()
    part = torch.empty((lib.moe_route_splits(n, h), n,
                        lib.moe_max_experts()), dtype=torch.float32,
                       device=x.device)
    idx = torch.empty((n, k), dtype=torch.int64, device=x.device)
    w = torch.empty((n, k), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.moe_route(x.data_ptr(), gate.data_ptr(), bias.data_ptr(),
                            part.data_ptr(), idx.data_ptr(), w.data_ptr(), n,
                            h, e, k, scale, stream)
    if err != 0:
        raise RuntimeError(f"moe_route launch failed: CUDA error {err}")
    count_launch(route, 2)
    return idx, w


route.launches = 0


def route_reference(x: torch.Tensor, gate: torch.Tensor, bias: torch.Tensor,
                    k: int, scale: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the router."""
    s = torch.sigmoid(F.linear(x.float(), gate.float()))
    idx = torch.topk(s + bias.float(), k, dim=-1).indices
    w = s.gather(-1, idx)
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * scale


def _align(idx: torch.Tensor, n_experts: int, block_m: int):
    """The pairs sorted by expert into blocks of ``block_m`` slots, each
    expert's run padded to whole blocks: (slot -> pair, n_pairs where
    empty; block -> expert, -1 past the used blocks).  Static shapes."""
    flat = idx.reshape(-1)
    p = flat.numel()
    counts = torch.zeros(n_experts, dtype=torch.int64, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    padded = (counts + block_m - 1) // block_m * block_m
    ends = padded.cumsum(0)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    first = counts.cumsum(0) - counts
    rank = torch.arange(p, device=flat.device) - first[sorted_e]
    slot = (ends - padded)[sorted_e] + rank
    n_slots = -(-(p + n_experts * (block_m - 1)) // block_m) * block_m
    slot_pair = torch.full((n_slots,), p, dtype=torch.int64,
                           device=flat.device)
    slot_pair[slot] = order
    starts = torch.arange(0, n_slots, block_m, device=flat.device)
    block_expert = torch.searchsorted(ends, starts, right=True)
    block_expert = torch.where(starts < ends[-1], block_expert, -1)
    return slot_pair, block_expert


def routed_experts(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                   gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """Each token's chosen experts' SwiGLU outputs, weighted and summed:
    [N, H] fp32 (the kernels on a card, the plain version on the CPU)."""
    if x.device.type == "cpu":
        return routed_experts_reference(x, idx, w, gate_up, down)
    n, k = idx.shape
    e, two_i, h = gate_up.shape
    inter = two_i // 2
    _check_bf16(x=x, gate_up=gate_up, down=down)
    lib = _library()
    p = n * k
    tiling = 0 if p <= DECODE_PAIRS else 1
    if (h % lib.moe_block_n(tiling, 0) or inter % lib.moe_block_n(tiling, 1)
            or h % 128 or inter % 128):
        raise ValueError(f"widths must be multiples of 128 and of the "
                         f"tiling's columns, got {h} (hidden), {inter} "
                         f"(expert)")
    slot_pair, block_expert = _align(idx, e, lib.moe_block_m(tiling))
    act = torch.empty((slot_pair.numel(), inter), dtype=x.dtype,
                      device=x.device)
    pairs = torch.empty((p, h), dtype=x.dtype, device=x.device)
    out = torch.empty((n, h), dtype=torch.float32, device=x.device)
    wf = w.reshape(-1).float().contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.moe_experts(tiling, x.data_ptr(), gate_up.data_ptr(),
                              down.data_ptr(), slot_pair.data_ptr(),
                              block_expert.data_ptr(), wf.data_ptr(),
                              act.data_ptr(), pairs.data_ptr(),
                              out.data_ptr(), block_expert.numel(), n, k, h,
                              inter, stream)
    if err != 0:
        raise RuntimeError(f"moe_experts launch failed: CUDA error {err}")
    count_launch(routed_experts, 3)
    return out


routed_experts.launches = 0


def routed_experts_reference(x: torch.Tensor, idx: torch.Tensor,
                             w: torch.Tensor, gate_up: torch.Tensor,
                             down: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: each expert over the tokens that chose it,
    with fp32 products of the stored values; the gated activation and the
    weighted outputs rounded to x's dtype where the kernel stores them;
    the outputs summed in fp32."""
    n, h = x.shape
    inter = gate_up.shape[1] // 2
    out = torch.zeros((n, h), dtype=torch.float32, device=x.device)
    for e in range(gate_up.shape[0]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if not rows.numel():
            continue
        gu = F.linear(x[rows].float(), gate_up[e].float())
        act = (F.silu(gu[:, :inter]) * gu[:, inter:]).to(x.dtype)
        y = F.linear(act.float(), down[e].float()) * w[rows, slot, None]
        out.index_add_(0, rows, y.to(x.dtype).float())
    return out
