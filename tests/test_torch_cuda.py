"""Kernels 1 and 2 on the card: the CUDA kernels of
spmm_tpu_torch.ops.decode_attention and spmm_tpu_torch.ops.fused_attention
against their plain PyTorch versions.

Marked ``cuda``: each test skips without a GPU.  This file imports no JAX, so
on a machine without it run it as
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Bars: kernel 1's ctx within 1e-5 (f32) and 2e-2 (bf16, fp8), and the cache
after the call equals the plain version's bit for bit; kernel 2 within 2e-5
(f32) and 3e-2 (bf16), the Pallas kernel's bars.
"""

import pytest
import torch

from spmm_tpu_torch.ops.decode_attention import (
    ancestry_mask,
    beam_decode_attention,
    beam_decode_attention_reference,
    compute_dtype,
)
from spmm_tpu_torch.ops.fused_attention import fused_mha, fused_mha_reference
from spmm_tpu_torch.ops.masks import extend_attention_mask, extend_causal_mask

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bits(x):
    return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        x.element_size()])


def _case(dev, m, h, k, T, d, L, cache_dtype, pos, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    cdt = compute_dtype(cache_dtype)
    cache = torch.randn((2, L, m, h, k, T, d), generator=g,
                        device=dev).to(cache_dtype)
    q, kn, vn = (torch.randn((m, h, k, d), generator=g, device=dev).to(cdt)
                 for _ in range(3))
    anc = torch.randint(0, k, (m, k, T), generator=g, device=dev)
    valid = (torch.arange(T, device=dev) < pos).expand(m, k, T)
    return q, kn, vn, cache, ancestry_mask(anc, valid).contiguous()


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16,
                                         torch.float8_e4m3fn])
@pytest.mark.parametrize("k,pos", [(1, 0), (2, 1), (2, 17), (5, 23)])
def test_kernel_matches_plain(dev, cache_dtype, k, pos):
    q, kn, vn, cache, mask = _case(dev, 6, 3, k, 24, 64, 2, cache_dtype,
                                   pos, seed=k * 100 + pos)
    c_kernel, c_plain = cache.clone(), cache.clone()
    before = beam_decode_attention.launches
    got = beam_decode_attention(q, kn, vn, c_kernel, mask, pos, 1)
    want = beam_decode_attention_reference(q, kn, vn, c_plain, mask, pos, 1)
    torch.cuda.synchronize()
    assert beam_decode_attention.launches == before + 1
    tol = 1e-5 if cache_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(_bits(c_kernel), _bits(c_plain))
    assert torch.equal(_bits(c_kernel[:, 1, :, :, :, :pos]),
                       _bits(cache[:, 1, :, :, :, :pos]))


def test_cuda_tensor_never_falls_back(dev):
    q, kn, vn, cache, mask = _case(dev, 2, 2, 2, 8, 64, 1, torch.float32, 3,
                                   seed=0)
    with pytest.raises(TypeError):
        beam_decode_attention(q.half(), kn, vn, cache, mask, 3, 0)
    with pytest.raises(ValueError, match="contiguous"):
        beam_decode_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                              kn, vn, cache, mask, 3, 0)
    wide = _case(dev, 2, 2, 2, 8, 80, 1, torch.float32, 3, seed=0)
    with pytest.raises(ValueError, match="head_dim"):
        beam_decode_attention(*wide, 3, 0)


def _mha_case(dev, b, h, lq, lk, d, dtype, mask_kind, seed):
    """q/k/v as split_heads views of [B, L, h*D] projections, and a mask."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, n, h * d), generator=g, device=dev).to(dtype)
               .view(b, n, h, d).transpose(1, 2) for n in (lq, lk, lk))
    lens = torch.randint(1, lk + 1, (b,), generator=g, device=dev)
    bin_mask = (torch.arange(lk, device=dev)[None] < lens[:, None]).int()
    if mask_kind == "none":
        return q, k, v, None
    if mask_kind == "padding":
        return q, k, v, extend_attention_mask(bin_mask)
    return q, k, v, extend_causal_mask(bin_mask, q_len=lq, past_len=lk - lq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,lq,lk,d,mask_kind", [
    (3, 4, 16, 16, 64, "none"),
    (3, 4, 24, 24, 64, "causal"),
    (3, 4, 1, 32, 64, "padding"),
    (8, 12, 54, 100, 64, "padding"),    # the fusion cross-attention
    (8, 12, 54, 54, 64, "causal"),      # the fusion self-attention
    (2, 2, 37, 256, 32, "padding"),     # the longest key row it takes
])
def test_fused_mha_matches_plain(dev, dtype, b, h, lq, lk, d, mask_kind):
    q, k, v, mask = _mha_case(dev, b, h, lq, lk, d, dtype, mask_kind,
                              seed=lq * 1000 + lk)
    before = fused_mha.launches
    got = fused_mha(q, k, v, mask)
    want = fused_mha_reference(q, k, v, mask)
    torch.cuda.synchronize()
    assert fused_mha.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h, lq, d)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    # merge_heads of the result is a view
    assert got.transpose(1, 2).is_contiguous()


def test_fused_mha_fully_masked_row(dev):
    q, k, v, _ = _mha_case(dev, 2, 2, 8, 40, 64, torch.float32, "none", 0)
    bin_mask = torch.ones((2, 40), dtype=torch.int32, device=dev)
    bin_mask[1] = 0
    mask = extend_attention_mask(bin_mask)
    got = fused_mha(q, k, v, mask)
    want = fused_mha_reference(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[0], want[0], atol=2e-5, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=0)


def test_fused_mha_never_falls_back(dev):
    q, k, v, mask = _mha_case(dev, 1, 2, 4, 8, 64, torch.float32, "padding",
                              0)
    with pytest.raises(TypeError):
        fused_mha(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head_dim"):
        fused_mha(q[..., :48], k[..., :48], v[..., :48])
    long = _mha_case(dev, 1, 2, 4, 257, 64, torch.float32, "none", 0)
    with pytest.raises(ValueError, match="Lk"):
        fused_mha(*long)
    with pytest.raises(ValueError, match="contiguous along head_dim"):
        fused_mha(q.transpose(2, 3).contiguous().transpose(2, 3)[..., :4, :],
                  k, v)
    with pytest.raises(ValueError, match="one device"):
        fused_mha(q, k, v, mask.cpu())
