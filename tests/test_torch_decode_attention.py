"""Port parity: kernel 1's plain version (spmm_tpu_torch.ops.decode_attention)
vs the JAX package's Pallas kernel in interpret mode and vs its XLA
formulation ``_beam_attention``.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA kernel
itself is held to that plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Bars (tests/test_decode_attention.py:56,109-117): ctx within
1e-5 in f32 and 2e-2 in bf16/fp8; the cache row at ``pos`` equals the new
K/V (quantized as JAX quantizes it for fp8) and every other row is unchanged.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spmm_tpu.inference.decoding import _ancestry_mask, _beam_attention
from spmm_tpu.ops.decode_attention import beam_decode_attention as jkernel
from spmm_tpu.ops.decode_attention import fold_dim

from spmm_tpu_torch.ops.decode_attention import (
    ancestry_mask,
    beam_decode_attention,
)

from torch_parity import t

M, H, L, T, D, LAYER = 4, 3, 2, 24, 64, 1
TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
         jnp.float8_e4m3fn: torch.float8_e4m3fn}


def fold_cache(unfolded, fd):
    """[2, L, m, h, k, T, d] -> lane-folded [2, L, m, h, T, FD]
    (the JAX suite's helper, tests/test_decode_attention.py:19-23)."""
    two, nl, m, h, k, nt, d = unfolded.shape
    folded = jnp.moveaxis(unfolded, 4, 5).reshape(two, nl, m, h, nt, k * d)
    return jnp.pad(folded, [(0, 0)] * 5 + [(0, fd - k * d)])


def to_port(x, torch_dtype):
    """JAX array -> CPU tensor of the same values (exact: via float32)."""
    return t(np.asarray(x.astype(jnp.float32))).to(torch_dtype)


def ancestry(rng, k, t_len, pos, kind):
    """[M, k, T] ancestor lanes.  "random": a random parent at every
    position; "shared", the decoder's pattern: all beams on one lane up to a
    divergence step, then each on its own lane; "unattended": lane k-1 is
    no beam's ancestor."""
    if kind == "random":
        return rng.integers(0, k, size=(M, k, t_len)).astype(np.int32)
    if kind == "unattended":
        return rng.integers(0, k - 1, size=(M, k, t_len)).astype(np.int32)
    lane = rng.integers(0, k, size=(M, 1, 1))
    div = rng.integers(0, pos + 1, size=(M, 1, 1))
    t = np.arange(t_len)[None, None, :]
    own = np.arange(k)[None, :, None]
    return np.where(t < div, lane, own).astype(np.int32)


def make_case(k, cache_dtype, q_dtype, pos, seed, t_len=T, kind="random"):
    rng = np.random.default_rng(seed)
    unfolded = jnp.asarray(rng.normal(size=(2, L, M, H, k, t_len, D)),
                           jnp.bfloat16 if cache_dtype != jnp.float32
                           else jnp.float32).astype(cache_dtype)
    q, kn, vn = (jnp.asarray(rng.normal(size=(M, H, k, D)), q_dtype)
                 for _ in range(3))
    anc = ancestry(rng, k, t_len, pos, kind)
    key_valid = (np.arange(t_len)[None, None, :]
                 < rng.integers(max(pos - 2, 0), pos + 1, size=(M, k, 1)))
    prefix_valid = (key_valid & (np.arange(t_len)[None, None, :] < pos)
                    ).astype(np.int32)
    return unfolded, q, kn, vn, anc, prefix_valid


def run_both(k, cache_dtype, pos, seed=0, t_len=T, kind="random"):
    q_dtype = jnp.float32 if cache_dtype == jnp.float32 else jnp.bfloat16
    unfolded, q, kn, vn, anc, prefix_valid = make_case(
        k, cache_dtype, q_dtype, pos, seed, t_len, kind)
    mask5 = _ancestry_mask(jnp.asarray(anc), jnp.asarray(prefix_valid))
    xla_ctx = _beam_attention(q, unfolded[0, LAYER].astype(q_dtype),
                              unfolded[1, LAYER].astype(q_dtype), mask5,
                              kn, vn)
    pallas_ctx, pallas_cache = jkernel(
        q, kn, vn, fold_cache(unfolded, fold_dim(k, D)),
        mask5[:, 0].astype(jnp.float32), jnp.int32(pos), layer=LAYER,
        block_m=2, interpret=True)

    tq = TORCH[q_dtype]
    cache = to_port(unfolded, TORCH[cache_dtype])
    before = cache.clone()
    mask = ancestry_mask(t(anc), t(prefix_valid))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask5[:, 0]))
    launches = beam_decode_attention.launches
    ctx = beam_decode_attention(to_port(q, tq), to_port(kn, tq),
                                to_port(vn, tq), cache, mask, pos, LAYER)
    assert beam_decode_attention.launches == launches   # CPU: no kernel
    assert ctx.dtype == tq
    return (ctx.float().numpy(), np.asarray(xla_ctx, np.float32),
            np.asarray(pallas_ctx, np.float32), cache, before, kn, vn,
            np.asarray(pallas_cache.astype(jnp.float32)))


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_matches_jax_kernel_and_xla(k, dtype):
    pos = 11
    got, xla, pallas, cache, before, kn, vn, _ = run_both(k, dtype, pos)
    tol = 1e-5 if dtype == jnp.float32 else 2e-2
    np.testing.assert_allclose(got, xla, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
    # append: row pos of every lane holds the new K/V, nothing else moved
    tq = TORCH[dtype]
    expect = before.clone()
    expect[0, LAYER, :, :, :, pos] = to_port(kn, tq)
    expect[1, LAYER, :, :, :, pos] = to_port(vn, tq)
    assert torch.equal(cache, expect)


@pytest.mark.parametrize("kind", ["shared", "unattended"])
@pytest.mark.parametrize("pos", [31, 32, 33, 63, 64, 65])
def test_plain_matches_jax_across_tile_edges(kind, pos):
    """T = 72: positions on both sides of the CUDA kernel's 32-row tile
    edges, on the decoder's shared-prefix ancestry and with a lane that no
    beam attends (its rows are exact zeros of the softmax)."""
    got, xla, pallas, cache, before, kn, vn, _ = run_both(
        2, jnp.float32, pos, seed=pos, t_len=72, kind=kind)
    np.testing.assert_allclose(got, xla, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-5)
    expect = before.clone()
    expect[0, LAYER, :, :, :, pos] = to_port(kn, torch.float32)
    expect[1, LAYER, :, :, :, pos] = to_port(vn, torch.float32)
    assert torch.equal(cache, expect)


def test_plain_unattended_lane_bf16_three_beams():
    """k = 3 in bf16 with lane 2 attended by no beam."""
    got, xla, pallas, *_ = run_both(3, jnp.bfloat16, 40, seed=3, t_len=72,
                                    kind="unattended")
    np.testing.assert_allclose(got, xla, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got, pallas, atol=2e-2, rtol=2e-2)


def test_plain_empty_prefix_is_self_value():
    """pos = 0 (the [CLS] step): no prefix, so ctx is the beam's own V."""
    got, xla, _, _, _, _, vn, _ = run_both(2, jnp.float32, 0)
    np.testing.assert_allclose(got, xla, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(vn), atol=1e-6, rtol=0)


def test_plain_fp8_cache():
    """fp8 cache: ctx within 2e-2 of both JAX paths over the same quantized
    values, and the appended rows quantize exactly as the JAX kernel's."""
    k, pos, fp8 = 2, 11, jnp.float8_e4m3fn
    got, xla, pallas, cache, before, kn, vn, pallas_cache = run_both(
        k, fp8, pos, seed=3)
    np.testing.assert_allclose(got, xla, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got, pallas, atol=2e-2, rtol=2e-2)
    for kv, new in ((0, kn), (1, vn)):
        row = cache[kv, LAYER, :, :, :, pos].float().numpy()       # [m,h,k,D]
        want = np.asarray(new.astype(fp8).astype(jnp.float32))
        np.testing.assert_array_equal(row, want)
        jax_row = pallas_cache[kv, LAYER, :, :, pos, : k * D]
        np.testing.assert_array_equal(row.reshape(M, H, k * D), jax_row)
    other = torch.ones(cache.shape[5], dtype=torch.bool)
    other[pos] = False
    assert torch.equal(cache[..., other, :].float(),
                       before[..., other, :].float())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    k = 2
    cache = torch.zeros(2, L, M, H, k, T, D)
    q = torch.zeros(M, H, k, D)
    mask = torch.zeros(M, k, k, T)
    with pytest.raises(TypeError, match="bfloat16"):
        beam_decode_attention(q, q, q, cache.to(torch.float8_e4m3fn), mask,
                              3, 0)
    with pytest.raises(ValueError, match="pos"):
        beam_decode_attention(q, q, q, cache, mask, T, 0)
    with pytest.raises(ValueError, match="layer"):
        beam_decode_attention(q, q, q, cache, mask, 3, L)
    with pytest.raises(ValueError, match="mask"):
        beam_decode_attention(q, q, q, cache, mask[..., :-1], 3, 0)
    with pytest.raises(ValueError, match="k_new"):
        beam_decode_attention(q, q[:, :1], q, cache, mask, 3, 0)
    with pytest.raises(TypeError, match="cache dtype"):
        beam_decode_attention(q.half(), q.half(), q.half(), cache.half(),
                              mask, 3, 0)
