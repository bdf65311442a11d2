"""Port parity: spmm_tpu_torch.ops.masks / ops.attention vs spmm_tpu.ops.

Masks must match bit for bit; attention within 2e-5 on the cases of
tests/test_pallas_attention.py:14-20 (fp32), within 3e-2 in bf16, for the
plain impl against JAX's "xla" and the kernel impl against its "pallas".
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spmm_tpu.ops import masks as jmasks
from spmm_tpu.ops.attention import multi_head_attention as jmha

from spmm_tpu_torch.ops import masks
from spmm_tpu_torch.ops.attention import multi_head_attention


def _binary(rng, b, l):
    m = (rng.random((b, l)) < 0.7).astype(np.int32)
    m[:, 0] = 1
    return m


@pytest.mark.parametrize("kind", ["padding", "causal", "causal_past",
                                  "encoder"])
def test_masks_bit_exact(kind):
    rng = np.random.default_rng(0)
    bin_mask = _binary(rng, 3, 12)
    if kind == "padding":
        want = jmasks.extend_attention_mask(jnp.asarray(bin_mask))
        got = masks.extend_attention_mask(torch.from_numpy(bin_mask))
    elif kind == "encoder":
        want = jmasks.invert_encoder_mask(jnp.asarray(bin_mask))
        got = masks.invert_encoder_mask(torch.from_numpy(bin_mask))
    else:
        past = 0 if kind == "causal" else 5
        want = jmasks.extend_causal_mask(jnp.asarray(bin_mask),
                                         q_len=12 - past, past_len=past)
        got = masks.extend_causal_mask(torch.from_numpy(bin_mask),
                                       q_len=12 - past, past_len=past)
    assert masks.MASK_VALUE == jmasks.MASK_VALUE
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lq,lk,mask_kind", [
    (16, 16, "none"),
    (24, 24, "padding"),
    (24, 24, "causal"),
    (1, 32, "padding"),     # decode-shaped query
    (8, 16, "padding"),     # cross-attention shaped
])
def test_attention_matches_jax(lq, lk, mask_kind):
    rng = np.random.default_rng(1)
    b, h, d = 3, 4, 64
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32)
               for n in (lq, lk, lk))
    if mask_kind == "none":
        jm = tm = None
    elif mask_kind == "padding":
        bin_mask = np.ones((b, lk), np.int32)
        bin_mask[1, lk // 2:] = 0
        jm = jmasks.extend_attention_mask(jnp.asarray(bin_mask))
        tm = masks.extend_attention_mask(torch.from_numpy(bin_mask))
    else:
        bin_mask = np.ones((b, lk), np.int32)
        jm = jmasks.extend_causal_mask(jnp.asarray(bin_mask), q_len=lq,
                                       past_len=lk - lq)
        tm = masks.extend_causal_mask(torch.from_numpy(bin_mask), q_len=lq,
                                      past_len=lk - lq)
    want = jmha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm)
    got = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_attention_bf16_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 2, 16, 64)).astype(np.float32)
               for _ in range(3))
    want = jmha(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), None)
    got = multi_head_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize("lq,lk,mask_kind", [
    (16, 16, "none"),
    (24, 24, "padding"),
    (24, 24, "causal"),
    (1, 32, "padding"),     # decode-shaped query
    (8, 16, "padding"),     # cross-attention shaped
])
def test_kernel_impl_matches_jax_pallas(lq, lk, mask_kind):
    """impl="kernel" (fused_mha; its plain version on the CPU) against the
    JAX package's impl="pallas" (pallas_mha in interpret mode off-TPU)."""
    rng = np.random.default_rng(2)
    b, h, d = 3, 4, 64
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32)
               for n in (lq, lk, lk))
    bin_mask = np.ones((b, lk), np.int32)
    bin_mask[1, lk // 2:] = 0
    if mask_kind == "none":
        jm = tm = None
    elif mask_kind == "padding":
        jm = jmasks.extend_attention_mask(jnp.asarray(bin_mask))
        tm = masks.extend_attention_mask(torch.from_numpy(bin_mask))
    else:
        jm = jmasks.extend_causal_mask(jnp.asarray(bin_mask), q_len=lq,
                                       past_len=lk - lq)
        tm = masks.extend_causal_mask(torch.from_numpy(bin_mask), q_len=lq,
                                      past_len=lk - lq)
    want = jmha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                impl="pallas")
    got = multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), tm, impl="kernel")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_unknown_impl_raises():
    x = torch.zeros(1, 1, 2, 64)
    with pytest.raises(ValueError, match="unknown attention impl"):
        multi_head_attention(x, x, x, impl="pallas")
