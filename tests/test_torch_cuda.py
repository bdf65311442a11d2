"""Kernel 1 on the card: the CUDA kernel of
spmm_tpu_torch.ops.decode_attention against its plain PyTorch version.

Marked ``cuda``: each test skips without a GPU.  This file imports no JAX, so
on a machine without it run it as
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Bars: ctx within 1e-5 (f32) and 2e-2 (bf16, fp8); the cache after the call
equals the plain version's bit for bit.
"""

import pytest
import torch

from spmm_tpu_torch.ops.decode_attention import (
    ancestry_mask,
    beam_decode_attention,
    beam_decode_attention_reference,
    compute_dtype,
)

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
