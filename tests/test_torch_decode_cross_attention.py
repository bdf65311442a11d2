"""Kernel 4's wrapper on the CPU (spmm_tpu_torch.ops.decode_cross_attention):
the decoder step's cross-attention.

On the CPU the wrapper runs its plain version, which must be the step's
plain route, ``multi_head_attention(impl="plain")`` over a molecule's k
beam queries, bit for bit; a beam and a greedy decode through it must
return what the step's former inline route returns, ids and scores bit for
bit.  The CUDA kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).  No JAX.
"""

import copy

import pytest
import torch

from spmm_tpu_torch.configs import BertArchConfig
from spmm_tpu_torch.inference import decoding
from spmm_tpu_torch.models.bert import merge_heads
from spmm_tpu_torch.models.rxn import Rxn
from spmm_tpu_torch.ops.attention import multi_head_attention
from spmm_tpu_torch.ops.decode_cross_attention import (
    decode_cross_attention,
    decode_cross_attention_reference,
)
from spmm_tpu_torch.ops.masks import MASK_VALUE

M, D = 3, 64


def _case(beams, le, h, dtype, mask_kind, seed, mask_dtype=torch.int32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(M * beams, 1, h * D, generator=g).to(dtype)
    k, v = (torch.randn(M, h, le, D, generator=g).to(dtype) for _ in range(2))
    lens = (torch.full((M,), le) if mask_kind == "ones"
            else torch.tensor([le, le // 2, 1]))
    mask = (torch.arange(le)[None] < lens[:, None]).to(mask_dtype)
    return q, k, v, mask


def _plain_route(q, k, v, mask):
    """The step's cross-attention as written out before kernel 4."""
    m, h, _, d = k.shape
    beams = q.shape[0] // m
    qx = q.reshape(m, beams, h, d).transpose(1, 2)
    xmask = ((1.0 - mask.float()) * MASK_VALUE)[:, None, None, :]
    ctx = multi_head_attention(qx, k.to(qx.dtype), v.to(qx.dtype), xmask,
                               impl="plain")
    return merge_heads(ctx.transpose(1, 2).reshape(m * beams, h, 1, d))


@pytest.mark.parametrize("mask_kind", ["ones", "padded"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [12, 6])
@pytest.mark.parametrize("le", [54, 96, 37])
@pytest.mark.parametrize("beams", [1, 2, 5])
def test_plain_version_is_the_plain_route(beams, le, h, dtype, mask_kind):
    q, k, v, mask = _case(beams, le, h, dtype, mask_kind,
                          seed=beams * 1000 + le * 10 + h)
    got = decode_cross_attention(q, k, v, mask)
    want = _plain_route(q, k, v, mask)
    assert got.shape == q.shape and got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(decode_cross_attention_reference(q, k, v, mask), want)


@pytest.mark.parametrize("mask_dtype", [torch.int64, torch.bool,
                                        torch.float32])
def test_plain_version_takes_every_binary_mask_dtype(mask_dtype):
    q, k, v, mask = _case(2, 54, 12, torch.bfloat16, "padded", seed=7)
    want = _plain_route(q, k, v, mask)
    assert torch.equal(decode_cross_attention(q, k, v, mask.to(mask_dtype)),
                       want)


def test_cpu_wrapper_counts_no_launch_and_checks_shapes():
    q, k, v, mask = _case(2, 54, 6, torch.float32, "ones", seed=3)
    before = decode_cross_attention.launches
    decode_cross_attention(q, k, v, mask)
    assert decode_cross_attention.launches == before
    with pytest.raises(ValueError, match="q must be"):
        decode_cross_attention(q[1:], k, v, mask)
    with pytest.raises(ValueError, match="mask must be"):
        decode_cross_attention(q, k, v, mask[:, 1:])
    with pytest.raises(ValueError, match="k and v"):
        decode_cross_attention(q, k, v[:, :, 1:], mask)


# ---- whole decodes on the CPU: the same ids and scores as the former
# inline route of ``decoding.decode_step`` ----

DC = BertArchConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=64, fusion_layer=1, encoder_width=32)
EC = BertArchConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                    intermediate_size=64, fusion_layer=1,
                    add_cross_attention=False)


@pytest.fixture(scope="module")
def decoder():
    dec = Rxn.random_init(0, DC, EC, device="cpu").text_encoder.eval()
    with torch.no_grad():
        for p in dec.parameters():
            if p.dim() == 2:
                p.mul_(10.0)
        dec.cls.predictions.bias[3] += 3.0
    return dec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["beam", "greedy"])
def test_cpu_decodes_equal_the_former_route(decoder, monkeypatch, kind,
                                            dtype):
    dec = copy.deepcopy(decoder).to(dtype)
    g = torch.Generator().manual_seed(5)
    enc = torch.randn(4, 6, DC.encoder_width, generator=g).to(dtype)
    mask = torch.ones(4, 6, dtype=torch.int32)
    mask[1:, 4:] = 0

    def decode():
        if kind == "greedy":
            return decoding.greedy_decode(dec, DC, enc, mask, max_steps=12,
                                          cache_dtype=dtype)
        spec = decoding.BeamSpec(k=2, stop_count=2, max_steps=12)
        return decoding.beam_search_batched(dec, DC, enc, mask, spec,
                                            cache_dtype=dtype)

    got = decode()
    monkeypatch.setattr(decoding, "decode_cross_attention", _plain_route)
    want = decode()
    assert got.keys() == want.keys()
    for key, value in want.items():
        if key == "steps":
            assert got[key] == value
        else:
            assert got[key].dtype == value.dtype, key
            assert torch.equal(got[key], value), key
