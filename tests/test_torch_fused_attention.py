"""Port parity: spmm_tpu_torch.ops.fused_attention (kernel 2's wrapper and
plain version) vs spmm_tpu.ops.pallas_attention.pallas_mha in interpret mode.

On the CPU ``fused_mha`` runs its plain version, so both names are held to
the Pallas kernel: within 2e-5 in fp32 and 3e-2 in bf16, the bars of
tests/test_pallas_attention.py.  Cases: its five shapes, a query-row mask
[B,1,Lq,Lk] and a padding mask [B,1,1,Lk] with random lengths, q/k/v as
split_heads views, a batch row whose keys are all masked, and the wrapper's
refusals.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spmm_tpu.ops import masks as jmasks
from spmm_tpu.ops.pallas_attention import pallas_mha

from spmm_tpu_torch.ops import masks
from spmm_tpu_torch.ops.fused_attention import fused_mha, fused_mha_reference

B, H, D = 3, 4, 64


def _qkv(rng, lq, lk, b=B, h=H, d=D):
    return tuple(rng.normal(size=(b, h, n, d)).astype(np.float32)
                 for n in (lq, lk, lk))


def _masks(kind, lq, lk, rng=None):
    """(JAX mask, port mask) of one kind, both from one numpy mask."""
    if kind == "none":
        return None, None
    if kind == "padding":                     # the JAX suite's case
        bin_mask = np.ones((B, lk), np.int32)
        bin_mask[1, lk // 2:] = 0
    elif kind == "random_padding":            # ragged rows
        bin_mask = (rng.random((B, lk)) < 0.6).astype(np.int32)
        bin_mask[:, 0] = 1
    else:
        bin_mask = np.ones((B, lk), np.int32)
        bin_mask[0, lk - 2:] = 0
    if kind == "causal":
        return (jmasks.extend_causal_mask(jnp.asarray(bin_mask), q_len=lq,
                                          past_len=lk - lq),
                masks.extend_causal_mask(torch.from_numpy(bin_mask), q_len=lq,
                                         past_len=lk - lq))
    return (jmasks.extend_attention_mask(jnp.asarray(bin_mask)),
            masks.extend_attention_mask(torch.from_numpy(bin_mask)))


FN = {"fused_mha": fused_mha, "reference": fused_mha_reference}


@pytest.mark.parametrize("fn", sorted(FN))
@pytest.mark.parametrize("lq,lk,mask_kind", [
    (16, 16, "none"),
    (24, 24, "padding"),
    (24, 24, "causal"),
    (1, 32, "padding"),     # decode-shaped query
    (8, 16, "padding"),     # cross-attention shaped
    (24, 24, "random_padding"),
    (10, 33, "causal"),     # [B,1,Lq,Lk] with Lk > 32
])
def test_matches_pallas(fn, lq, lk, mask_kind):
    rng = np.random.default_rng(lq * 100 + lk)
    q, k, v = _qkv(rng, lq, lk)
    jm, tm = _masks(mask_kind, lq, lk, rng)
    want = pallas_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                      interpret=True)
    got = FN[fn](*(torch.from_numpy(x) for x in (q, k, v)), tm)
    assert got.dtype == torch.float32 and got.shape == (B, H, lq, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("fn", sorted(FN))
@pytest.mark.parametrize("mask_kind", ["none", "causal"])
def test_bf16_matches_pallas(fn, mask_kind):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 16, 16)
    jm, tm = _masks(mask_kind, 16, 16, rng)
    want = pallas_mha(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jm,
                      interpret=True)
    got = FN[fn](*(torch.from_numpy(x).to(torch.bfloat16)
                   for x in (q, k, v)), tm)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize("fn", sorted(FN))
@pytest.mark.parametrize("mask_kind", ["random_padding", "causal"])
def test_long_keys_match_pallas(fn, mask_kind):
    """Lk = 300, past the 256 keys of the card's short kernel: the plain
    version the long kernel is held to on the card matches JAX's kernel."""
    rng = np.random.default_rng(300)
    q, k, v = _qkv(rng, 20, 300)
    jm, tm = _masks(mask_kind, 20, 300, rng)
    want = pallas_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                      interpret=True)
    got = FN[fn](*(torch.from_numpy(x) for x in (q, k, v)), tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_cpu_call_keeps_its_gradient():
    """On the CPU the plain version runs under autograd as before; only a
    CUDA call that needs a gradient is refused (tests/test_torch_cuda.py)."""
    q, k, v = (torch.randn(1, 2, 5, 32, requires_grad=True) for _ in range(3))
    fused_mha(q, k, v).sum().backward()
    assert all(x.grad is not None and x.grad.abs().sum() > 0
               for x in (q, v))


def test_split_heads_views_and_fully_masked_row():
    """q/k/v as the transposed views BertAttention passes.  A batch row whose
    keys are all masked (-10000, not -inf) comes out as in JAX, but that
    row is ill-conditioned: its fp32 scores near -10000 are rounded to
    2**-10, so a one-ulp difference in a dot product moves a probability by
    about 0.1%.  It is held to 1e-3, the other rows to 2e-5."""
    from spmm_tpu_torch.models.bert import split_heads

    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, B, 20, H * D)).astype(np.float32)
    q, k, v = (split_heads(torch.from_numpy(a), H) for a in x)
    assert not q.is_contiguous()
    bin_mask = np.ones((B, 20), np.int32)
    bin_mask[1] = 0
    tm = masks.extend_attention_mask(torch.from_numpy(bin_mask))
    want = pallas_mha(*(jnp.asarray(a.numpy()) for a in (q, k, v)),
                      jmasks.extend_attention_mask(jnp.asarray(bin_mask)),
                      interpret=True)
    got = fused_mha(q, k, v, tm)
    want = np.asarray(want)
    keep = [0, 2]
    np.testing.assert_allclose(got[keep].numpy(), want[keep], atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-3, rtol=0)


def test_wrapper_refusals():
    x = torch.zeros(1, 2, 4, 32)
    with pytest.raises(TypeError, match="float32"):
        fused_mha(x.half(), x.half(), x.half())
    with pytest.raises(TypeError):
        fused_mha(x, x.bfloat16(), x)
    with pytest.raises(ValueError, match="k and v"):
        fused_mha(x, x[..., :16], x[..., :16])
    with pytest.raises(ValueError, match="4-D"):
        fused_mha(x, x, x, torch.zeros(1, 4))
    with pytest.raises(ValueError, match="no kernel"):
        fused_mha(*(torch.zeros(1, 2, 4, 32, device="meta"),) * 3)
    assert fused_mha.launches == 0          # the CPU never launches


@pytest.mark.parametrize("fn", sorted(FN))
@pytest.mark.parametrize("lq,lk,mask_kind,dtype,tol", [
    (8, 1300, "causal", np.float32, 2e-5),
    (33, 2000, "random_padding", np.float32, 2e-5),
    (8, 1500, "causal", jnp.bfloat16, 3e-2),
])
def test_streaming_lengths_match_pallas(fn, lq, lk, mask_kind, dtype, tol):
    """Key lengths past the card's long kernel (1,152 keys in fp32, 1,408 in
    bf16), which its streaming kernel takes: the wrapper and the plain
    version it is held to on the card match JAX's kernel."""
    rng = np.random.default_rng(lk + lq)
    q, k, v = _qkv(rng, lq, lk)
    jm, tm = _masks(mask_kind, lq, lk, rng)
    want = pallas_mha(*(jnp.asarray(x, dtype) for x in (q, k, v)), jm,
                      interpret=True)
    torch_dtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = FN[fn](*(torch.from_numpy(x).to(torch_dtype) for x in (q, k, v)),
                 tm)
    assert got.dtype == torch_dtype and got.shape == (B, H, lq, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


TILE = 64          # keys per tile of the streaming kernel
SKIP_GAP = 1000.0  # masks this far below a row's largest add 0 (the source note)


def _cluster_mha(q, k, v, mask, clusters):
    """The streaming kernel's order of operations (csrc/fused_attention.cu,
    ``fused_mha_stream_kernel``) written out in torch: the keys cut into
    ``clusters`` contiguous ranges of 64-key tiles, some uneven and some
    empty; under a padding mask only the tiles up to the row's last live
    key are computed, so a range wholly past it contributes max -inf and
    sum 0.  The ranges' maxima are merged in rank order, each range's sum
    of exp(s - M) is taken against the global max and the sums are added in
    rank order, P = exp(s - M) / S is rounded to v's dtype after that
    normalisation, and the ranges' partial P.V are added in rank order."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / d ** 0.5)
    live = torch.full((b,), lk)
    if mask is not None:
        s = s + mask[:, 0].float()[:, None]
        if mask.shape[2] == 1:               # one row: the padding-tile skip
            row = mask[:, 0, 0].float()
            keep = row >= row.max(dim=-1, keepdim=True).values - SKIP_GAP
            last = torch.where(keep, torch.arange(lk), -1).max(dim=-1).values
            live = torch.clamp((last // TILE + 1) * TILE, max=lk)
    tiles = -(-lk // TILE)
    cuts = [min(r * tiles // clusters * TILE, lk) for r in range(clusters + 1)]
    key = torch.arange(lk)
    ranges = [(key >= lo) & (key < hi) & (key[None] < live[:, None])
              for lo, hi in zip(cuts, cuts[1:])]       # [B, Lk] each
    masked = [torch.where(r[:, None, None], s, -torch.inf) for r in ranges]
    m = torch.full((b, h, lq, 1), -torch.inf)
    for x in masked:
        m = torch.maximum(m, x.max(dim=-1, keepdim=True).values)
    total = torch.zeros((b, h, lq, 1))
    for x in masked:
        total = total + torch.exp(x - m).sum(dim=-1, keepdim=True)
    out = torch.zeros((b, h, lq, d))
    for r, x in zip(ranges, masked):
        p = (torch.exp(x - m) / total).to(v.dtype).float()
        out = out + torch.matmul(p, torch.where(r[:, None, :, None],
                                                v.float(), 0.0))
    return out.to(q.dtype)


@pytest.mark.parametrize("mask_kind", ["short_rows", "causal"])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (jnp.bfloat16, 2e-2)])
@pytest.mark.parametrize("clusters", [1, 3, 8, 16])
def test_cluster_merge_matches_pallas(clusters, dtype, tol, mask_kind):
    """The cluster's merge (``_cluster_mha``) over 300 keys, five tiles cut
    into 1, 3 (uneven), 8 and 16 ranges (some empty), against JAX's kernel:
    it catches a wrong rounding point or a NaN in the merge before the card.
    Under "short_rows" batch row 0 has 5 keys, so every range past the
    first tile is wholly past its last key, and row 2 is fully masked (a
    uniform softmax over all 300).  A fully masked row is ill-conditioned
    against JAX (test_split_heads_views_and_fully_masked_row): it is held
    to 1e-3 there and to the bar against the plain version."""
    lq, lk = 8, 300
    rng = np.random.default_rng(clusters)
    q, k, v = _qkv(rng, lq, lk)
    if mask_kind == "causal":
        jm, tm = _masks("causal", lq, lk)
    else:
        bin_mask = np.ones((B, lk), np.int32)
        bin_mask[0, 5:] = 0
        bin_mask[2] = 0
        jm = jmasks.extend_attention_mask(jnp.asarray(bin_mask))
        tm = masks.extend_attention_mask(torch.from_numpy(bin_mask))
    torch_dtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    tq, tk, tv = (torch.from_numpy(x).to(torch_dtype) for x in (q, k, v))
    got = _cluster_mha(tq, tk, tv, tm, clusters)
    assert got.dtype == torch_dtype and torch.isfinite(got.float()).all()
    want = np.asarray(pallas_mha(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                                 jm, interpret=True), np.float32)
    plain = fused_mha_reference(tq, tk, tv, tm).float().numpy()
    got = got.float().numpy()
    rows = [0, 1] if mask_kind == "short_rows" else [0, 1, 2]
    np.testing.assert_allclose(got[rows], want[rows], atol=tol, rtol=0)
    np.testing.assert_allclose(got, plain, atol=tol, rtol=0)
    if mask_kind == "short_rows":
        np.testing.assert_allclose(got[2], want[2], atol=max(tol, 1e-3),
                                   rtol=0)
