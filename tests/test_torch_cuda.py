"""Kernels 1 to 5 on the card: the CUDA kernels of
spmm_tpu_torch.ops.decode_attention, spmm_tpu_torch.ops.fused_attention,
spmm_tpu_torch.ops.mla_decode, spmm_tpu_torch.ops.decode_cross_attention and
spmm_tpu_torch.ops.split_gemm, and the expert layer's kernels of
spmm_tpu_torch.ops.moe (router, grouped products, pairs' sum), against
their plain PyTorch versions.

Marked ``cuda``: each test skips without a GPU.  This file imports no JAX, so
on a machine without it run it as
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Bars: kernel 1's ctx within 1e-5 (f32) and 2e-2 (bf16, fp8), and the cache
after the call equals the plain version's bit for bit; kernel 2 within 2e-5
(f32) and 3e-2 (bf16), the Pallas kernel's bars, and past 256 keys (its
long and streaming kernels, whose tiles and softmax sums change the order
of summation) within kernel 1's bars; kernel 4 (the decoder step's
cross-attention) within kernel 1's bars too.
Kernel 3 and the expert products within 2e-2 and 1e-2 of the largest
magnitude (bf16 probabilities and outputs against fp32), the latent
attention prefill (ops/mla_prefill.py) within 2e-2 of its plain route in
bf16 and 1e-2 of it in fp32; the router's
choice the plain one's wherever the 6th and 7th scores are apart by more
than the fp32 sum's rounding, its weights within 1e-5.
Also: both wrappers refuse a call that would need a gradient, SMILES->PV
on the card equals the plain route on the CPU, one fine-tune step on the
card equals the same step on the CPU, the decode loops' CUDA graphs equal
the eager loop (the latent MoE turn's too), and the decode path's spans
read as the benchmark reads them.
Kernel 5 (the split-TF32 linear) within 2x cuBLAS SGEMM's relative RMS and
largest error against fp64, at cell C's shapes and on C's own activations;
``predict_pv`` through it within 1e-4 of ``nn.Linear``'s; TF32 allowed,
a pretrain step (fp32 and bf16) and FSDP's gathered weights keep
``F.linear`` bit for bit.
"""

import pytest
import torch

from spmm_tpu_torch.ops.decode_attention import (
    ancestry_mask,
    beam_decode_attention,
    beam_decode_attention_reference,
    compute_dtype,
)
from spmm_tpu_torch.ops.fused_attention import (
    STREAM,
    fused_mha,
    fused_mha_reference,
    fused_mha_stream,
    launch_info,
)
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


def _ancestry(dev, m, k, T, pos, kind, g):
    """[m, k, T] ancestor lanes: "random" parents at every position;
    "shared", the decoder's pattern: all beams on one lane up to a divergence
    step, then each on its own lane; "unattended": lane k-1 is nobody's."""
    if kind == "random":
        return torch.randint(0, k, (m, k, T), generator=g, device=dev)
    if kind == "unattended":
        return torch.randint(0, k - 1, (m, k, T), generator=g, device=dev)
    lane = torch.randint(0, k, (m, 1, 1), generator=g, device=dev)
    div = torch.randint(0, pos + 1, (m, 1, 1), generator=g, device=dev)
    own = torch.arange(k, device=dev)[None, :, None]
    t = torch.arange(T, device=dev)[None, None, :]
    return torch.where(t < div, lane, own).expand(m, k, T).contiguous()


def _case(dev, m, h, k, T, d, L, cache_dtype, pos, seed, kind="random"):
    g = torch.Generator(device=dev).manual_seed(seed)
    cdt = compute_dtype(cache_dtype)
    cache = torch.randn((2, L, m, h, k, T, d), generator=g,
                        device=dev).to(cache_dtype)
    q, kn, vn = (torch.randn((m, h, k, d), generator=g, device=dev).to(cdt)
                 for _ in range(3))
    anc = _ancestry(dev, m, k, T, pos, kind, g)
    valid = (torch.arange(T, device=dev) < pos).expand(m, k, T)
    return q, kn, vn, cache, ancestry_mask(anc, valid).contiguous()


def _check_kernel(q, kn, vn, cache, mask, pos, layer):
    c_kernel, c_plain = cache.clone(), cache.clone()
    before = beam_decode_attention.launches
    got = beam_decode_attention(q, kn, vn, c_kernel, mask, pos, layer)
    want = beam_decode_attention_reference(q, kn, vn, c_plain, mask, pos,
                                           layer)
    torch.cuda.synchronize()
    assert beam_decode_attention.launches == before + 1
    tol = 1e-5 if cache.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(_bits(c_kernel), _bits(c_plain))
    assert torch.equal(_bits(c_kernel[:, layer, :, :, :, :pos]),
                       _bits(cache[:, layer, :, :, :, :pos]))


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16,
                                         torch.float8_e4m3fn])
@pytest.mark.parametrize("k,pos", [(1, 0), (2, 1), (2, 17), (5, 23)])
def test_kernel_matches_plain(dev, cache_dtype, k, pos):
    _check_kernel(*_case(dev, 6, 3, k, 24, 64, 2, cache_dtype, pos,
                         seed=k * 100 + pos), pos, 1)


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16,
                                         torch.float8_e4m3fn])
@pytest.mark.parametrize("kind", ["shared", "unattended"])
@pytest.mark.parametrize("pos", [31, 32, 33, 63, 64, 65])
def test_kernel_matches_plain_across_tile_edges(dev, cache_dtype, kind, pos):
    """The kernel copies 32-row tiles of live rows: positions on both sides
    of its tile edges, on the decoder's shared-prefix ancestry and with a
    lane that no beam attends."""
    _check_kernel(*_case(dev, 6, 3, 2, 72, 64, 2, cache_dtype, pos,
                         seed=pos, kind=kind), pos, 1)


def _greedy_case(dev, m, T, pos, seed):
    """Kernel 1 as greedy decoding calls it: k=1, a single lane, and
    key_valid holes where a row emitted token 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, kn, vn, cache, _ = _case(dev, m, 12, 1, T, 64, 2, torch.bfloat16, pos,
                                seed)
    valid = ((torch.arange(T, device=dev) < pos)
             & (torch.rand((m, 1, T), generator=g, device=dev) > 0.1))
    anc = torch.zeros((m, 1, T), dtype=torch.int64, device=dev)
    return q, kn, vn, cache, ancestry_mask(anc, valid).contiguous()


@pytest.mark.parametrize("pos", [1, 33, 100, 103])
def test_kernel_greedy_k1_bf16(dev, pos):
    """k=1 runs the KB=2 instantiation with half its beam registers idle."""
    _check_kernel(*_greedy_case(dev, 128, 104, pos, seed=pos), pos, 1)


@pytest.mark.parametrize("m,k", [(32, 5), (16, 3)], ids=["k5_m32", "k3_m16"])
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("kind", ["random", "shared"])
def test_kernel_rxn_beams(dev, cache_dtype, kind, m, k):
    """k=5 (the reaction beam search, m=32) and k=3 (the eval CLI at
    --n_beam 3, a batch of 16) run KB=8 with idle beam slots."""
    for pos in (1, 33, 100):
        _check_kernel(*_case(dev, m, 12, k, 104, 64, 2, cache_dtype, pos,
                             seed=pos, kind=kind), pos, 1)


@pytest.mark.parametrize("d", [32, 96, 128])
def test_kernel_head_dims(dev, d):
    _check_kernel(*_case(dev, 4, 2, 3, 40, d, 1, torch.bfloat16, 37, seed=d,
                         kind="shared"), 37, 0)


def test_kernel_long_cache_eight_beams(dev):
    """T = 300, k = 8, fp32: the largest shared-memory case."""
    for pos in (0, 150, 299):
        _check_kernel(*_case(dev, 16, 2, 8, 300, 64, 1, torch.float32, pos,
                             seed=pos, kind="shared"), pos, 0)


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
    shifted = torch.empty(cache.numel() + 1, device=dev)[1:].view(cache.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        beam_decode_attention(q, kn, vn, shifted.copy_(cache), mask, 3, 0)


def _mha_case(dev, b, h, lq, lk, d, dtype, mask_kind, seed):
    """q/k/v as split_heads views of [B, L, h*D] projections, and a mask:
    "padding" from random lengths, "mixed" a padding mask with one row of
    lk - 7 keys among short ones (an eval batch with one long molecule),
    "causal" or "none"."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, n, h * d), generator=g, device=dev).to(dtype)
               .view(b, n, h, d).transpose(1, 2) for n in (lq, lk, lk))
    lens = torch.randint(1, lk + 1, (b,), generator=g, device=dev)
    if mask_kind == "mixed":
        lens = torch.randint(8, 40, (b,), generator=g, device=dev)
        lens[b // 2] = lk - 7
        mask_kind = "padding"
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
    (2, 3, 5, 1, 64, "padding"),        # a single key
    (2, 3, 70, 256, 64, "causal"),
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


def _launch_classes():
    """Launch classes of SMILES->PV: text 100x100; at step i, over its
    n = i + 1 slots, the property n x n, the causal fusion n x n and the
    cross n x 100; here n at the ends and around 16 and 32 (every n from 1
    to 53 runs in ``test_predict_pv_on_card_matches_cpu``)."""
    classes = [("text", 100, 100, "padding")]
    for s in (1, 2, 16, 17, 32, 33, 53):
        classes += [("property", s, s, "padding"),
                    ("fusion-self", s, s, "causal"),
                    ("fusion-cross", s, 100, "padding")]
    return classes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,lq,lk,mask_kind", _launch_classes())
def test_fused_mha_launch_classes(dev, dtype, label, lq, lk, mask_kind):
    q, k, v, mask = _mha_case(dev, 6, 12, lq, lk, 64, dtype, mask_kind,
                              seed=lq + lk)
    got = fused_mha(q, k, v, mask)
    want = fused_mha_reference(q, k, v, mask)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


def test_predict_pv_on_card_matches_cpu(dev):
    """fp32 ``predict_pv`` of a padded, ragged batch at 53 properties on the
    card, every attention through kernel 2 (step i over its i + 1 slots, so
    every width from 1 to 53), against the plain route on the CPU from the
    same weights: within 1e-4 (sums run in other orders; TF32 is off)."""
    import copy

    from spmm_tpu_torch.configs import BertArchConfig
    from spmm_tpu_torch.inference.smiles2pv import predict_pv
    from spmm_tpu_torch.models.spmm import SPMM

    arch = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256)
    tc = BertArchConfig(vocab_size=300, num_hidden_layers=3, fusion_layer=1,
                        encoder_width=128, add_cross_attention=True, **arch)
    pc = BertArchConfig(vocab_size=1, num_hidden_layers=2, fusion_layer=2,
                        add_cross_attention=False, **arch)
    cpu_model = SPMM.random_init(0, tc, pc, device="cpu").eval()
    card_model = copy.deepcopy(cpu_model).to(dev)
    g = torch.Generator().manual_seed(3)
    lengths = torch.tensor([40, 31, 20, 9, 3, 25])
    mask = (torch.arange(40)[None] < lengths[:, None]).int()
    ids = torch.randint(4, 300, (6, 40), generator=g) * mask
    before = fused_mha.launches
    got = predict_pv(card_model, ids.to(dev), mask.to(dev), device=dev)
    torch.cuda.synchronize()
    assert fused_mha.launches - before == 1 + 6 * 53
    want = predict_pv(cpu_model, ids, mask, attention_impl="plain",
                      device="cpu")
    assert got.dtype == torch.float32 and got.shape == (6, 53)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("length", [96, 160])
def test_fused_mha_rxn_encoder_class(dev, length):
    """The reactant encoder's self-attention over padded sources: the 96
    bucket, and a source past the 150 bucket (truncation is off)."""
    q, k, v, mask = _mha_case(dev, 16, 12, length, length, 64,
                              torch.float32, "padding", seed=length)
    got = fused_mha(q, k, v, mask)
    want = fused_mha_reference(q, k, v, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_greedy_decode_kernel_matches_plain(dev):
    """A tiny reaction model decoded greedily in fp32 through kernel 1 and
    through its plain version: identical seqs, 1 launch per layer per step,
    and the encoder's attentions through kernel 2."""
    from spmm_tpu_torch.configs import BertArchConfig
    from spmm_tpu_torch.inference.rxn import _greedy_batch
    from spmm_tpu_torch.models.rxn import Rxn

    dc = BertArchConfig(hidden_size=128, num_hidden_layers=3,
                        num_attention_heads=2, intermediate_size=256,
                        fusion_layer=1, encoder_width=128)
    ec = BertArchConfig(hidden_size=128, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=256,
                        fusion_layer=2, add_cross_attention=False)
    model = Rxn.random_init(0, dc, ec, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(4, 300, (6, 40), generator=g, device=dev)
    ids[:, 0] = 2
    mask = (torch.arange(40, device=dev)[None]
            < torch.tensor([40, 31, 20, 9, 40, 25], device=dev)[:, None]).int()
    before = (beam_decode_attention.launches, fused_mha.launches)
    got = _greedy_batch(model, model.text_encoder, ids, mask, max_steps=30)
    launches = (beam_decode_attention.launches - before[0],
                fused_mha.launches - before[1])
    want = _greedy_batch(model, model.text_encoder, ids, mask, max_steps=30,
                         attention="plain")
    assert torch.equal(got["seqs"], want["seqs"])
    assert got["steps"] == want["steps"]
    assert launches == (3 * got["steps"], 2)


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
    with pytest.raises(ValueError, match="contiguous along head_dim"):
        fused_mha(q.transpose(2, 3).contiguous().transpose(2, 3)[..., :4, :],
                  k, v)
    with pytest.raises(ValueError, match="one device"):
        fused_mha(q, k, v, mask.cpu())
    shifted = torch.empty(q.numel() + 1, device=dev)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_mha(shifted.copy_(q), k, v, mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,mask_kind", [
    (37, 257, "padding"),               # one key past the short kernel
    (288, 288, "padding"),              # a 257-token source, bucket of 32s
    (288, 288, "causal"),
    (64, 512, "padding"),               # the long kernel's 32-row items
    (512, 512, "causal"),
    (512, 512, "mixed"),                # one long row among short ones
    (16, 1000, "padding"),              # its 16-row items
    (70, 1000, "none"),
    (40, 1300, "causal"),               # long kernel in bf16, streaming in f32
    (33, 2000, "padding"),              # past the long kernel: streaming
])
def test_fused_mha_long_keys(dev, dtype, lq, lk, mask_kind):
    """Past 256 keys: the long kernel (an item's scores resident in shared
    memory, K/V tiles pipelined) up to its limit, the streaming kernel
    past it; both the exact two-pass softmax."""
    b = 6 if mask_kind == "mixed" else 2
    q, k, v, mask = _mha_case(dev, b, 3, lq, lk, 64, dtype, mask_kind,
                              seed=lq + lk)
    before = fused_mha.launches
    got = fused_mha(q, k, v, mask)
    want = fused_mha_reference(q, k, v, mask)
    torch.cuda.synchronize()
    assert fused_mha.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, 3, lq, 64)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mha_long_keys_skip_hidden_tiles(dev, dtype):
    """A padding mask's hidden tiles are skipped: rows of 1, 63, 64, 65,
    127, 128, 129 and 300 keys (both kernels' tile edges), and a fully
    masked row (uniform softmax over all 300)."""
    from spmm_tpu_torch.ops.masks import extend_attention_mask

    q, k, v, _ = _mha_case(dev, 9, 2, 40, 300, 64, dtype, "none", seed=11)
    lens = torch.tensor([1, 63, 64, 65, 127, 128, 129, 300, 0], device=dev)
    mask = extend_attention_mask(
        (torch.arange(300, device=dev)[None] < lens[:, None]).int())
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(fused_mha(q, k, v, mask).float(),
                               fused_mha_reference(q, k, v, mask).float(),
                               atol=tol, rtol=tol)


def test_fused_mha_long_keys_head_dim_32(dev):
    q, k, v, mask = _mha_case(dev, 2, 2, 40, 300, 32, torch.float32,
                              "padding", seed=3)
    torch.testing.assert_close(fused_mha(q, k, v, mask),
                               fused_mha_reference(q, k, v, mask),
                               atol=1e-5, rtol=1e-5)


# Lk just past the long kernel's reach at D=64: 1,152 keys in f32, 1,408 in
# bf16 (chip_smoke.py prints both switch points)
STREAM_FROM = {torch.float32: 1153, torch.bfloat16: 1409}


def _stream_case(dev, b, h, lq, lk, d, dtype, case, forced=False):
    """fused_mha (or, ``forced``, fused_mha_stream) against the plain
    version on one input, ``case`` a mask kind of ``_mha_case`` or the
    inputs (q, k, v, mask): the launch must take the streaming kernel,
    once; within 1e-5 (f32) or 2e-2 (bf16)."""
    q, k, v, m = case if isinstance(case, tuple) else _mha_case(
        dev, b, h, lq, lk, d, dtype, case, seed=lq * 7 + lk)
    info = launch_info(dtype, d, b, h, lq, lk,
                       **({"route": STREAM} if forced else {}))
    assert info["route"] == "stream" and 1 <= info["cluster"] <= 8
    before = fused_mha.launches
    got = (fused_mha_stream if forced else fused_mha)(q, k, v, m)
    want = fused_mha_reference(q, k, v, m)
    torch.cuda.synchronize()
    assert fused_mha.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h, lq, d)
    assert torch.isfinite(got.float()).all()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    return info


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq", [1, 16, 17, 33, 64, 65])
@pytest.mark.parametrize("mask_kind", ["causal", "padding"])
def test_fused_mha_stream_just_past_reach(dev, dtype, lq, mask_kind):
    """The streaming kernel from the first Lk the long kernel leaves it,
    at query rows on both sides of its 16- and 32-row items."""
    _stream_case(dev, 2, 3, lq, STREAM_FROM[dtype], 64, dtype, mask_kind)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,lq,lk,d,mask_kind", [
    (2, 3, 40, 1473, 64, "causal"),     # 23 tiles: uneven over the cluster
    (2, 3, 33, 2000, 64, "padding"),
    (3, 2, 70, 1800, 32, "causal"),     # D=32 (its long kernel reaches further)
    (2, 2, 24, 2333, 32, "none"),
    (1, 2, 16, 20000, 64, "none"),      # past what the cluster holds resident
    (1, 2, 40, 20000, 64, "padding"),
    (8, 12, 1, 4000, 64, "padding"),    # a decode-shaped query
])
def test_fused_mha_stream_kernel(dev, dtype, b, h, lq, lk, d, mask_kind):
    _stream_case(dev, b, h, lq, lk, d, dtype, mask_kind)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mha_stream_padding_rows(dev, dtype):
    """Rows of 1, 63, 64, 65, 700, 1217 and 1500 keys (tile edges; ranges
    of a cluster wholly past a row's last key) and a fully masked row
    (uniform over all 1500 keys), as split_heads views."""
    lk = 1500
    q, k, v, _ = _mha_case(dev, 8, 2, 40, lk, 64, dtype, "none", seed=13)
    lens = torch.tensor([1, 63, 64, 65, 700, 1217, 1500, 0], device=dev)
    mask = extend_attention_mask(
        (torch.arange(lk, device=dev)[None] < lens[:, None]).int())
    _stream_case(dev, 8, 2, 40, lk, 64, dtype, (q, k, v, mask))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lk,mask_kind", [
    (4, 512, 512, "padding"),           # the long kernel's shapes, forced
    (4, 288, 288, "causal"),
    (2, 37, 257, "padding"),
    (2, 8, 40, "padding"),              # the short kernel's
    (2, 5, 1, "none"),                  # a single key
])
def test_fused_mha_stream_forced(dev, dtype, b, lq, lk, mask_kind):
    """fmha_launch_route sends any Lk to the streaming kernel."""
    _stream_case(dev, b, 3, lq, lk, 64, dtype, mask_kind, forced=True)


def test_kernel_wrappers_refuse_grad(dev):
    """A CUDA call that would need a gradient raises, instead of returning
    a result without one; under no_grad, or without requires_grad, the
    kernels run."""
    q, k, v, mask = _mha_case(dev, 2, 2, 8, 40, 64, torch.float32,
                              "padding", 0)
    qg = q.detach().clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fused_mha(qg, k, v, mask)
    with torch.no_grad():
        fused_mha(qg, k, v, mask)
    inputs = list(_case(dev, 2, 2, 2, 8, 64, 1, torch.float32, 3, seed=0))
    inputs[0] = inputs[0].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        beam_decode_attention(*inputs, 3, 0)
    with torch.no_grad():
        beam_decode_attention(*inputs, 3, 0)


@pytest.mark.parametrize("task", ["classification", "multilabel",
                                  "regression"])
def test_downstream_step_on_card_matches_cpu(dev, task):
    """One AdamW step of make_downstream_step, dropout off, from the same
    weights and batch on the card and on the CPU: loss, gradients and
    parameters agree (sums run in other orders; TF32 is off)."""
    import copy

    from spmm_tpu_torch.configs import BertArchConfig, FinetuneConfig
    from spmm_tpu_torch.models.downstream import Downstream
    from spmm_tpu_torch.training.finetune import make_downstream_step

    cfg = BertArchConfig(hidden_size=128, num_hidden_layers=4,
                         num_attention_heads=2, intermediate_size=256,
                         fusion_layer=2, encoder_width=128)
    n_out = 5 if task == "multilabel" else 2
    cpu_model = Downstream.random_init(0, task, cfg, n_out, device="cpu")
    card_model = copy.deepcopy(cpu_model).to(dev)
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(4, 300, (8, 24), generator=g)
    mask = (torch.arange(24)[None] < torch.randint(5, 25, (8, 1),
                                                   generator=g)).int()
    target = {"classification": torch.randint(0, 2, (8,), generator=g),
              "multilabel": torch.randint(0, 2, (8, n_out),
                                          generator=g).float(),
              "regression": torch.randn(8, generator=g)}[task]
    fcfg = FinetuneConfig()          # step 0 runs at warmup_lr, 5e-6
    out = {}
    for name, model, d in (("cpu", cpu_model, "cpu"), ("card", card_model,
                                                       dev)):
        _, step = make_downstream_step(model, fcfg, steps_per_epoch=10)
        batch = {"ids": ids.to(d), "mask": mask.to(d),
                 "target": target.to(d)}
        out[name] = step(0, batch)["loss"].item()
    assert abs(out["card"] - out["cpu"]) <= 1e-5 * abs(out["cpu"])
    # a gradient that is zero in exact arithmetic (the key biases: softmax
    # ignores a shift) is rounding noise on both sides, so the relative bar
    # has a floor of 1e-6 of the largest gradient
    floor = 1e-6 * max(p.grad.norm() for p in cpu_model.parameters())
    for (name, p_cpu), p_card in zip(cpu_model.named_parameters(),
                                     card_model.parameters()):
        gc, gd = p_cpu.grad, p_card.grad.cpu()
        assert (gd - gc).norm() <= 1e-4 * gc.norm() + floor, name
        torch.testing.assert_close(p_card.detach().cpu(), p_cpu.detach(),
                                   atol=1e-6, rtol=0, msg=name)


# ---- the decode loops as captured CUDA graphs against the eager loop ----

def _graph_decoder(dev):
    """A small reaction decoder (D=32) whose weights are 5x the init's and
    whose [SEP] logit is raised by 1: decodes stop early, at other steps
    for other inputs, with rows that finish k or more beams and rows that
    finish fewer."""
    from spmm_tpu_torch.configs import BertArchConfig
    from spmm_tpu_torch.models.rxn import Rxn

    dc = BertArchConfig(hidden_size=64, num_hidden_layers=3,
                        num_attention_heads=2, intermediate_size=128,
                        fusion_layer=1, encoder_width=64)
    ec = BertArchConfig(hidden_size=64, num_hidden_layers=1,
                        num_attention_heads=2, intermediate_size=128,
                        fusion_layer=1, add_cross_attention=False)
    dec = Rxn.random_init(0, dc, ec, device=dev).text_encoder.eval()
    with torch.no_grad():
        for p in dec.parameters():
            if p.dim() == 2:
                p.mul_(5.0)
        dec.cls.predictions.bias[3] += 1.0
    return dec, dc


def _graph_inputs(dev, seed, m=8, le=10, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    enc = torch.randn(m, le, 64, generator=g).to(dev, dtype)
    mask = torch.ones(m, le, dtype=torch.int32, device=dev)
    mask[m // 2:, le - 3:] = 0
    return enc, mask


def _graph_vs_eager(dev, graphed, eager, seeds=(0, 1)):
    """Each input through the eager loop, then twice through the graphs
    (the capturing call, then a replaying one): every output equal bit for
    bit, ``steps`` equal, the same kernel-1 launches; a generator passed as
    ``gen`` ends in the same state.  Returns the eager results."""
    out = []
    for seed in seeds:
        runs = []
        for fn in (eager, graphed, graphed):
            gen = torch.Generator(device=dev).manual_seed(seed + 11)
            before = beam_decode_attention.launches
            res = fn(seed, gen)
            torch.cuda.synchronize()
            runs.append((res, beam_decode_attention.launches - before,
                         gen.get_state()))
        (want, n, state), *graph_runs = runs
        for got, n_got, state_got in graph_runs:
            assert got.keys() == want.keys()
            for key, value in want.items():
                if key == "steps":
                    assert got[key] == value
                else:
                    assert got[key].dtype == value.dtype, key
                    assert torch.equal(_bits(got[key]) if got[key]
                                       .is_floating_point() else got[key],
                                       _bits(value) if value
                                       .is_floating_point() else value), key
            assert n_got == n
            assert torch.equal(state_got, state)
        out.append(want)
    return out


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16,
                                         torch.float8_e4m3fn])
def test_beam_search_graphs_match_eager(dev, cache_dtype, stochastic):
    """beam_search_batched through its graphs against
    beam_search_batched_eager: fp32 decoder for the fp32 cache, a bf16 copy
    for the bf16 and fp8 caches; deterministic and from a generator."""
    from spmm_tpu_torch.inference import decoding

    dec, dc = _graph_decoder(dev)
    dtype = torch.float32 if cache_dtype == torch.float32 else torch.bfloat16
    dec = dec.to(dtype)
    spec = decoding.BeamSpec(k=2, stop_count=2, max_steps=30,
                             stochastic=stochastic)

    def run(fn):
        return lambda seed, gen: fn(dec, dc, *_graph_inputs(dev, seed,
                                                            dtype=dtype),
                                    spec, generator=gen,
                                    cache_dtype=cache_dtype)

    want = _graph_vs_eager(dev, run(decoding.beam_search_batched),
                           run(decoding.beam_search_batched_eager))
    assert all(w["steps"] <= spec.max_steps + 1 for w in want)
    if not stochastic:               # the deterministic search stops early
        assert any(w["steps"] < spec.max_steps + 1 for w in want)
    assert beam_decode_attention.launches > 0


@pytest.mark.parametrize("stochastic", [False, True])
def test_greedy_decode_graphs_match_eager(dev, stochastic):
    from spmm_tpu_torch.inference import decoding

    dec, dc = _graph_decoder(dev)

    def run(fn):
        def call(seed, gen):
            draw = decoding.torch_uniforms(gen, 8, 1, dc.vocab_size, dev)
            return fn(dec, dc, *_graph_inputs(dev, seed), max_steps=30,
                      stochastic=stochastic,
                      uniforms=(lambda step: draw(0)) if stochastic else None)
        return call

    want = _graph_vs_eager(dev, run(decoding.greedy_decode),
                           run(decoding.greedy_decode_eager))
    if not stochastic:
        assert any(w["steps"] < 30 for w in want)


def test_decode_graphs_two_shapes_in_turn_and_an_eviction(dev, monkeypatch):
    """Two shapes in turn, each call equal to the eager loop's; past
    MAX_SHAPES (4) shapes the least recently used is dropped, and captured
    anew when it comes back."""
    from spmm_tpu_torch.inference import decoding

    graphs = decoding.DecodeGraphs()
    monkeypatch.setattr(decoding, "graph_cache", graphs)
    dec, dc = _graph_decoder(dev)
    spec = decoding.BeamSpec(k=2, stop_count=2, max_steps=30)

    def beam(m):
        return lambda seed, gen: decoding.beam_search_batched(
            dec, dc, *_graph_inputs(dev, seed, m=m), spec)

    def beam_eager(m):
        return lambda seed, gen: decoding.beam_search_batched_eager(
            dec, dc, *_graph_inputs(dev, seed, m=m), spec)

    def kept():
        return [row["m"] for row in graphs.stats()["shapes"]]

    for m in (8, 4, 8, 4, 2, 3):
        _graph_vs_eager(dev, beam(m), beam_eager(m), seeds=(m,))
    assert kept() == [8, 4, 2, 3]
    _graph_vs_eager(dev, beam(6), beam_eager(6), seeds=(6,))
    assert kept() == [4, 2, 3, 6]
    captured = graphs.stats()["captured"]
    _graph_vs_eager(dev, beam(8), beam_eager(8), seeds=(8,))
    assert kept() == [2, 3, 6, 8]
    assert graphs.stats()["captured"] > captured
    for row in graphs.stats()["shapes"]:
        assert row["graphs"] > 0 and row["state_bytes"] > 0


def test_decode_spans_on_the_card(dev, monkeypatch):
    """Under ``torch.profiler``, two k=2 reaction batches: the first
    captures a graph a position, the second replays them.  One
    ``spmm.decode.step`` a step, and the same ``spmm.*`` spans in the same
    order in both batches, so none opens inside a captured step body (its
    Python runs while a graph is captured, never on a replay); readings of
    the benchmark's ``loop_gap_us`` and ``prologue_idle_ms``."""
    from portbench import trace as trace_mod
    from portbench.metrics import loop_gap_us, prologue_idle_ms
    from spmm_tpu_torch.configs import BertArchConfig
    from spmm_tpu_torch.inference import decoding, rxn
    from spmm_tpu_torch.models.rxn import Rxn

    monkeypatch.setattr(decoding, "graph_cache", decoding.DecodeGraphs())
    dc = BertArchConfig(hidden_size=64, num_hidden_layers=3,
                        num_attention_heads=2, intermediate_size=128,
                        fusion_layer=1, encoder_width=64)
    ec = BertArchConfig(hidden_size=64, num_hidden_layers=1,
                        num_attention_heads=2, intermediate_size=128,
                        fusion_layer=1, add_cross_attention=False)
    model = Rxn.random_init(0, dc, ec, device=dev).eval()
    spec = decoding.BeamSpec(k=2, stop_count=2 * 2 * 11, max_steps=10)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(4, 300, (8, 16), generator=g)
    ids[:, 0] = 2
    ids, mask = ids.to(dev), torch.ones(8, 16, dtype=torch.int32, device=dev)
    results, trace = trace_mod.capture(
        lambda j: rxn._beam_batch(model, model.text_encoder, ids, mask, spec),
        2, dev)
    captured = decoding.graph_cache.stats()["captured"]
    spans = [ev for ev in trace.host if ev[0].startswith("spmm.")]
    by_batch = [[name for name, a, _ in spans if lo <= a <= hi]
                for lo, hi in trace.batches]
    assert [r["steps"] for r in results] == [spec.max_steps + 1] * 2
    assert captured == spec.max_steps + 1
    assert by_batch[0] == by_batch[1]
    assert by_batch[0].count("spmm.decode.step") == spec.max_steps + 1
    assert trace.device
    assert loop_gap_us.read(trace, [], {}) is not None
    assert prologue_idle_ms.read(trace, [], {}) is not None


# ---- kernel 3 (latent attention decode) and the latent MoE turn ----

def _mla_case(dev, lens, T=8192, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    b = len(lens)
    q = torch.randn(b, 16, 576, generator=g, device=dev).bfloat16()
    cache = torch.randn(b, T, 576, generator=g, device=dev).bfloat16()
    return q, cache, torch.tensor(lens, device=dev)


def _check_mla(q, cache, lens):
    from spmm_tpu_torch.ops.mla_decode import (
        mla_decode_attention, mla_decode_attention_reference)

    scale = 192 ** -0.5
    calls = mla_decode_attention.launches
    got = mla_decode_attention(q, cache, lens, 512, scale)
    torch.cuda.synchronize()
    want = mla_decode_attention_reference(q, cache, lens, 512, scale)
    assert mla_decode_attention.launches == calls + 1
    # bf16 probabilities and output against fp32: kernel 1's bf16 bar
    err = (got.float() - want.float()).abs().max() / want.abs().max()
    assert err < 2e-2, float(err)


def test_mla_kernel_matches_plain_published_widths(dev):
    """128 rows of 2,048-8,064 live positions in an 8,192-position cache,
    16 heads sharing one latent of 512 + 64."""
    g = torch.Generator().manual_seed(1)
    lens = torch.randint(2048, 8065, (128,), generator=g).tolist()
    _check_mla(*_mla_case(dev, lens))


def test_mla_kernel_tile_and_split_edges(dev):
    _check_mla(*_mla_case(dev, [1, 2, 31, 32, 33, 511, 512, 513, 1025,
                                8191, 8192], seed=2))


def test_moe_kernel_matches_plain(dev):
    """The grouped expert products at the published widths, at a decode
    step's 128 tokens and at a prefill's 4,096, against the plain loop over
    the experts on the card."""
    from spmm_tpu_torch.ops import moe

    g = torch.Generator(device=dev).manual_seed(3)
    gate_up = (torch.randn(64, 2816, 2048, generator=g, device=dev)
               * 0.02).bfloat16()
    down = (torch.randn(64, 2048, 1408, generator=g, device=dev)
            * 0.02).bfloat16()
    router = (torch.randn(64, 2048, generator=g, device=dev)
              * 0.02).bfloat16()
    bias = torch.randn(64, generator=g, device=dev) * 0.02
    for n in (128, 4096):
        x = torch.randn(n, 2048, generator=g, device=dev).bfloat16()
        idx, w = moe.route(x, router, bias, 6, 2.446)
        calls = moe.routed_experts.launches
        got = moe.routed_experts(x, idx, w, gate_up, down)
        torch.cuda.synchronize()
        assert moe.routed_experts.launches == calls + 3
        want = moe.routed_experts_reference(x, idx, w, gate_up, down)
        # the same bf16 roundings; fp32 sums in another order
        err = (got - want).abs().max() / want.abs().max()
        assert err < 1e-2, (n, float(err))


def test_moe_products_with_every_token_on_one_expert(dev):
    """Every token's first choice one expert (the prefill tiling's many
    blocks of one expert, the decode tiling's blocks full), against the
    plain loop."""
    from spmm_tpu_torch.ops import moe

    g = torch.Generator(device=dev).manual_seed(4)
    gate_up = (torch.randn(64, 2816, 2048, generator=g, device=dev)
               * 0.02).bfloat16()
    down = (torch.randn(64, 2048, 1408, generator=g, device=dev)
            * 0.02).bfloat16()
    for n in (128, 2048):
        x = torch.randn(n, 2048, generator=g, device=dev).bfloat16()
        idx = torch.stack([torch.randperm(63, device=dev)[:6] + 1
                           for _ in range(n)])
        idx[:, 0] = 0
        w = torch.rand(n, 6, generator=g, device=dev)
        got = moe.routed_experts(x, idx, w, gate_up, down)
        want = moe.routed_experts_reference(x, idx, w, gate_up, down)
        err = (got - want).abs().max() / want.abs().max()
        assert err < 1e-2, (n, float(err))


def test_moe_router_kernel_matches_plain(dev):
    """The router kernel at the published widths (64 experts, 6 a token,
    hidden 2,048), at a decode step's 128 tokens and a prefill's 4,096:
    the same experts as the plain router wherever the plain biased scores'
    6th and 7th are apart by more than 1e-5 (two fp32 sums of 2,048 terms
    in another order differ by about 1e-6), and the same weights."""
    import torch.nn.functional as F

    from spmm_tpu_torch.ops import moe

    g = torch.Generator(device=dev).manual_seed(5)
    gate = (torch.randn(64, 2048, generator=g, device=dev) * 0.02).bfloat16()
    bias = torch.randn(64, generator=g, device=dev) * 0.02
    for n in (128, 4096):
        x = torch.randn(n, 2048, generator=g, device=dev).bfloat16()
        calls = moe.route.launches
        idx, w = moe.route(x, gate, bias, 6, 2.446)
        torch.cuda.synchronize()
        assert moe.route.launches == calls + 2
        ridx, rw = moe.route_reference(x, gate, bias, 6, 2.446)
        s = torch.sigmoid(F.linear(x.float(), gate.float())) + bias
        top = s.topk(7, dim=-1).values
        clear = top[:, 5] - top[:, 6] > 1e-5
        assert clear.float().mean() > 0.99
        # within the 6 the order may differ where two scores nearly tie
        idx, order = idx[clear].sort(-1)
        ridx, rorder = ridx[clear].sort(-1)
        assert torch.equal(idx, ridx)
        assert (w[clear].gather(-1, order)
                - rw[clear].gather(-1, rorder)).abs().max() < 1e-5


def _latent_model(dev, layers=3):
    """Published widths at 3 layers (one dense, two expert layers)."""
    from portbench.reference.latent_moe import make_tensor, tensor_kinds
    from spmm_tpu_torch.configs import LatentMoeConfig
    from spmm_tpu_torch.models.latent_moe import LatentMoe

    cfg = LatentMoeConfig(num_hidden_layers=layers)
    d = {"initializer_range": 0.02, **{f: getattr(cfg, f) for f in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "kv_lora_rank", "qk_nope_head_dim",
        "qk_rope_head_dim", "v_head_dim", "intermediate_size",
        "moe_intermediate_size", "n_routed_experts", "n_shared_experts",
        "first_k_dense_replace")}}
    kinds = tensor_kinds(d)
    with torch.device(dev):
        model = LatentMoe(cfg)
    model.load_checkpoint(lambda name, shape: make_tensor(
        d, 5, name, shape, kinds[name], dev))
    return model.eval()


def _latent_session(dev, model, rows=8, seed=0):
    from spmm_tpu_torch.inference import lm

    g = torch.Generator().manual_seed(seed)
    s = lm.SessionCache(model, rows, 4096, dev)
    lengths = torch.randint(100, 3000, (rows,), generator=g).tolist()
    lm.prefill_history(model, s, [
        torch.randint(0, 163840, (n,), generator=g).to(dev) for n in lengths])
    turn = torch.randint(0, 163840, (rows, 64), generator=g).to(dev)
    return s, turn


def test_latent_turn_graphs_equal_eager(dev, monkeypatch):
    """A turn through the decode graphs (one graph, captured on the first
    call, replayed on the second) equals the eager decode bit for bit."""
    from spmm_tpu_torch.inference import decoding, lm

    monkeypatch.setattr(decoding, "graph_cache", decoding.DecodeGraphs())
    model = _latent_model(dev)
    s, turn = _latent_session(dev, model)
    first = lm.answer_turn(model, s, turn, 16)
    again = lm.answer_turn(model, s, turn, 16)
    eager = lm.answer_turn(model, s, turn, 16, eager=True)
    assert (first["answers"] == eager["answers"]).all()
    assert (again["answers"] == eager["answers"]).all()
    stats = decoding.graph_cache.stats()
    assert stats["captured"] == 1
    assert stats["shapes"][0]["kind"] == "latent"


def test_latent_turn_spans_on_the_card(dev, monkeypatch):
    """Under ``torch.profiler``, two turns: the same ``spmm.*`` spans in
    the same order in both (none opens inside the captured step body), one
    ``spmm.decode.step`` a step, kernel 3 and the expert products in the
    device trace, and the new readers reading them."""
    from portbench import trace as trace_mod
    from portbench.metrics import k3_roofline, moe_ms, turn_ms
    from spmm_tpu_torch.inference import decoding, lm

    monkeypatch.setattr(decoding, "graph_cache", decoding.DecodeGraphs())
    model = _latent_model(dev)
    s, turn = _latent_session(dev, model, seed=1)
    results, trace = trace_mod.capture(
        lambda j: lm.answer_turn(model, s, turn, 12), 2, dev)
    spans = [ev for ev in trace.host if ev[0].startswith("spmm.")]
    by_batch = [[name for name, a, _ in spans if lo <= a <= hi]
                for lo, hi in trace.batches]
    assert by_batch[0] == by_batch[1]
    assert by_batch[0].count("spmm.decode.step") == 11
    assert by_batch[0].count("spmm.lm.prefill") == 1
    assert len(trace.named(k3_roofline.NAMES)) == 2 * 2 * 3 * 11
    assert moe_ms.read(trace, [], {}) > 0
    assert turn_ms.read(trace, [], {}) > 0


# ---- the latent attention prefill (ops/mla_prefill.py) ----

def _prefill_case(dev, segments, T=8192, seed=0):
    """Queries of ``segments`` at M's widths (16 heads, nope 128, rope 64,
    v 128, latent 512; scale folded in, as the model passes them), a cache
    of random latent rows and a random W_kvb."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = sum(count for _, _, count, _ in segments)
    rows = 1 + max(row for row, _, _, _ in segments)
    q = (torch.randn(n, 16, 192, generator=g, device=dev)
         * 2 * 192 ** -0.5).bfloat16()
    cache = torch.randn(rows, T, 576, generator=g, device=dev).bfloat16()
    kv_b = (torch.randn(4096, 512, generator=g, device=dev)
            * 0.05).bfloat16()
    return q, cache, kv_b


def _segments(starts, counts):
    out, off = [], 0
    for row, (start, count) in enumerate(zip(starts, counts)):
        out.append((row, start, count, off))
        off += count
    return out


def _check_prefill(dev, segments, budget=None, T=8192, seed=0):
    """The kernel against the plain route in bf16 and against it in fp32,
    within 2e-2 and 1e-2 of the largest magnitude (kernel 3's bar: bf16
    probabilities and outputs); one launch a group."""
    from spmm_tpu_torch.ops import mla_prefill

    q, cache, kv_b = _prefill_case(dev, segments, T, seed)
    groups = mla_prefill.plan(segments, 16, 8192, device=dev,
                              **({} if budget is None else {"budget": budget}))
    calls = mla_prefill.mla_prefill_attention.launches
    got = mla_prefill.mla_prefill_attention(q, cache, kv_b, segments, 128,
                                            groups)
    torch.cuda.synchronize()
    assert mla_prefill.mla_prefill_attention.launches == calls + len(groups)
    plain = mla_prefill.mla_prefill_attention_reference(q, cache, kv_b,
                                                        segments, 128)
    exact = mla_prefill.mla_prefill_attention_reference(
        q.float(), cache.float(), kv_b.float(), segments, 128)
    top = exact.abs().max()
    err = float((got.float() - plain.float()).abs().max() / top)
    err32 = float((got.float() - exact).abs().max() / top)
    assert err < 2e-2 and err32 < 1e-2, (err, err32)
    return groups


def test_mla_prefill_turn_rows_match_plain(dev):
    """A group of turn rows (256 new tokens each) over histories of mixed
    lengths, 2,048 to 7,680 cached positions."""
    segments = _segments([2048, 7680, 3001, 5120, 6333, 4097],
                         [256] * 6)
    assert len(_check_prefill(dev, segments)) == 1


def test_mla_prefill_history_group_causal(dev):
    """A history group from position 0 (set-up's prefill): every query
    over the causal diagonal, tiles past it skipped."""
    segments = _segments([0, 0, 0], [2100, 1536, 701])
    assert len(_check_prefill(dev, segments, seed=1)) == 1


@pytest.mark.parametrize("starts,counts", [
    ([0], [1]),                                  # one query, one key
    ([129], [1]),                                # one query past a tile
    ([255, 0, 17], [3, 127, 129]),               # key counts off the tile
    ([4000], [256]),                             # a group of one row
])
def test_mla_prefill_edges(dev, starts, counts):
    _check_prefill(dev, _segments(starts, counts), T=4400, seed=2)


def test_mla_prefill_budget_splits_the_group(dev):
    """A budget of two rows' expansion: three launches, one a group."""
    segments = _segments([1000, 3000, 2000, 1500, 2500], [200] * 5)
    groups = _check_prefill(dev, segments, budget=2 * 3200 * 8192,
                            T=4096, seed=3)
    assert [len(g.segments) for g in groups] == [2, 2, 1]


def test_latent_prefill_kernel_equals_plain_route(dev, monkeypatch):
    """Histories prefilled, then a turn, at 3 layers of published widths:
    the logits and the cache through the kernel against the plain route
    (``mla_prefill_attention_reference`` put in the kernel's place); one
    kernel launch a layer and group.  Layer 0's cache rows precede any
    attention and agree bit for bit; later layers' rows agree within bf16
    rounding for the median token (a token whose sixth and seventh expert
    nearly tie may flip its choice under either route, and differ more)."""
    from spmm_tpu_torch.inference import lm
    from spmm_tpu_torch.models import latent_moe
    from spmm_tpu_torch.ops import mla_prefill

    model = _latent_model(dev)
    g = torch.Generator().manual_seed(6)
    lengths = [300, 2900, 1200, 2049]
    hist = [torch.randint(0, 163840, (n,), generator=g).to(dev)
            for n in lengths]
    turn = torch.randint(0, 163840, (4, 64), generator=g).to(dev)

    def run():
        s = lm.SessionCache(model, 4, 4096, dev)
        lm.prefill_history(model, s, hist)
        logits = lm._prefill(model, s, [(r, lengths[r], turn[r])
                                        for r in range(4)])
        return logits.float(), s.cache

    calls = mla_prefill.mla_prefill_attention.launches
    got, cache = run()
    torch.cuda.synchronize()
    # histories: one prefill call of 6,449 tokens, one group; the turn one
    assert mla_prefill.mla_prefill_attention.launches == calls + 2 * 3
    monkeypatch.setattr(
        latent_moe, "mla_prefill_attention",
        lambda q, cache, kv_b, segments, nope, groups:
        mla_prefill.mla_prefill_attention_reference(q, cache, kv_b,
                                                    segments, nope))
    want, want_cache = run()
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 3e-2, err
    assert torch.equal(cache[0], want_cache[0])
    live = torch.cat([cache[1:, r, :lengths[r] + 64] for r in range(4)], 1)
    ref = torch.cat([want_cache[1:, r, :lengths[r] + 64] for r in range(4)],
                    1).float()
    token_err = (live.float() - ref).norm(dim=-1) / ref.norm(dim=-1)
    assert float(token_err.median()) < 1e-2, float(token_err.median())


# ---- kernel 4: the decoder step's cross-attention ----

def _cross_case(dev, m, beams, h, le, d, dtype, mask_kind, seed,
                mask_dtype=torch.int32):
    """q as the query projection's rows [m*k, 1, h*D], one fusion layer's
    K/V [m, h, Le, D] and a binary mask: all ones, or random lengths of at
    least one key (a source holds its [CLS] at least), one row of one."""
    from spmm_tpu_torch.ops.decode_cross_attention import (
        decode_cross_attention, decode_cross_attention_reference)

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((m * beams, 1, h * d), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((m, h, le, d), generator=g, device=dev).to(dtype)
            for _ in range(2))
    lens = torch.full((m,), le, device=dev)
    if mask_kind == "padded":
        lens = torch.randint(1, le + 1, (m,), generator=g, device=dev)
        lens[0] = 1
    mask = (torch.arange(le, device=dev)[None] < lens[:, None]).to(mask_dtype)
    return decode_cross_attention, decode_cross_attention_reference, \
        (q, k, v, mask)


def _check_cross(kernel, plain, args) -> None:
    before = kernel.launches
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 1e-5 if got.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("mask_kind", ["ones", "padded"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,beams,h,le,d", [
    (512, 2, 12, 54, 64), (32, 5, 12, 96, 64), (128, 1, 12, 96, 64),
    (64, 2, 6, 54, 64), (16, 3, 3, 512, 64), (8, 8, 12, 37, 64),
    (8, 2, 2, 10, 32), (4, 3, 2, 33, 96), (4, 4, 2, 65, 128)],
    ids=["cell_a", "cell_b", "greedy", "tp_h6", "le512", "k8_odd", "d32",
         "d96", "d128"])
def test_cross_kernel_matches_plain(dev, m, beams, h, le, d, dtype,
                                    mask_kind):
    _check_cross(*_cross_case(dev, m, beams, h, le, d, dtype, mask_kind,
                              seed=m + beams + le))


@pytest.mark.parametrize("mask_dtype", [torch.int64, torch.bool,
                                        torch.float32])
def test_cross_kernel_mask_dtypes(dev, mask_dtype):
    _check_cross(*_cross_case(dev, 32, 5, 12, 96, 64, torch.bfloat16,
                              "padded", seed=3, mask_dtype=mask_dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_kernel_fully_masked_row(dev, dtype):
    """A molecule with no key: every score sits near -10,000, where fp32's
    spacing is 2**-10, so the order of a dot product's sum moves a score by
    up to that and its probability by about 1e-3 (kernel 2's test of the
    same case); the other molecules keep kernel 1's bars."""
    kernel, plain, (q, k, v, mask) = _cross_case(dev, 4, 2, 12, 54, 64,
                                                 dtype, "padded", 5)
    mask[2] = 0
    got, want = kernel(q, k, v, mask), plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    live = torch.arange(8, device=dev) // 2 != 2
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(got[~live].float(), want[~live].float(),
                               atol=1e-3 if dtype == torch.float32 else 2e-2,
                               rtol=0 if dtype == torch.float32 else 2e-2)


def test_cross_kernel_refuses_what_it_does_not_take(dev):
    kernel, _, (q, k, v, mask) = _cross_case(dev, 4, 2, 2, 54, 64,
                                             torch.bfloat16, "padded", 0)
    with pytest.raises(TypeError):
        kernel(q.half(), k.half(), v.half(), mask)
    with pytest.raises(TypeError):
        kernel(q, k.float(), v.float(), mask)
    with pytest.raises(TypeError):
        kernel(q, k, v, mask.to(torch.int16))
    with pytest.raises(ValueError, match="one device"):
        kernel(q, k.cpu(), v.cpu(), mask)
    long = _cross_case(dev, 2, 2, 2, 513, 64, torch.bfloat16, "ones", 0)[2]
    with pytest.raises(ValueError, match="Le <= 512"):
        kernel(*long)
    many = _cross_case(dev, 2, 9, 2, 54, 64, torch.bfloat16, "ones", 0)[2]
    with pytest.raises(ValueError, match="k <= 8"):
        kernel(*many)
    with pytest.raises(ValueError, match="contiguous"):
        kernel(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, mask)
    with pytest.raises(RuntimeError, match="no backward"):
        kernel(q.float().requires_grad_(), k.float(), v.float(), mask)


def test_cross_kernel_six_launches_a_step_in_a_captured_a_decode(
        dev, monkeypatch):
    """Cell A's decode (bf16 SPMM decoder, k=2, 512 PVs, 6 fusion layers)
    through freshly captured graphs: each graph recorded 6 launches of
    kernel 4 (and 12 of kernel 1), and the replays counted 6 a step."""
    from spmm_tpu_torch.inference import decoding
    from spmm_tpu_torch.inference.pv2smiles import _beam_batch, decoder_for
    from spmm_tpu_torch.models.spmm import SPMM
    from spmm_tpu_torch.ops.decode_cross_attention import (
        decode_cross_attention)

    graphs = decoding.DecodeGraphs()
    monkeypatch.setattr(decoding, "graph_cache", graphs)
    model = SPMM.random_init(0, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    pv = torch.randn((512, 53), generator=g, device=dev)
    spec = decoding.BeamSpec(k=2, stop_count=2 * 2 * 100, max_steps=10)
    before = (decode_cross_attention.launches, beam_decode_attention.launches)
    res = _beam_batch(model, decoder_for(model, bf16=True), pv, None, spec)
    torch.cuda.synchronize()
    assert res["steps"] == spec.max_steps + 1
    assert decode_cross_attention.launches - before[0] == 6 * res["steps"]
    assert beam_decode_attention.launches - before[1] == 12 * res["steps"]
    (entry,) = graphs._entries.values()
    assert len(entry.launches) == res["steps"]
    for launches in entry.launches.values():
        assert launches[decode_cross_attention] == 6
        assert launches[beam_decode_attention] == 12


# ---- the split-TF32 linear (ops/split_gemm.py, csrc/split_tf32_gemm.cu) ----

# cell C's products: M = 128 (i + 1) rows at property step i (128 to 6,912),
# 128 x 100 for the text encoder and the cross K/V; K, N of 768 and 3,072
SPLIT_ROWS = [128, 1280, 3456, 6912, 128 * 100]


def _rel_errors(y, ref):
    d = y.double() - ref
    return ((d.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item(),
            (d.abs().max() / ref.abs().max()).item())


def _against_sgemm(x, w, b):
    """(kernel, cuBLAS SGEMM) relative RMS and largest errors against the
    fp64 product of the same operands, TF32 off."""
    import torch.nn.functional as F

    from spmm_tpu_torch.ops.split_gemm import split_linear

    with torch.no_grad():
        ref = F.linear(x.double(), w.double(),
                       None if b is None else b.double())
        got = split_linear(x, w, b)
        sgemm = F.linear(x, w, b)
    torch.cuda.synchronize()
    return _rel_errors(got, ref), _rel_errors(sgemm, ref)


@pytest.mark.parametrize("n", [768, 3072])
@pytest.mark.parametrize("k", [768, 3072])
@pytest.mark.parametrize("m", SPLIT_ROWS)
def test_split_gemm_holds_sgemm_accuracy(dev, m, k, n):
    """N(0, 1) operands and bias at every shape of cell C: the kernel's
    relative RMS and largest error against fp64 at most 2x cuBLAS SGEMM's
    on the same operands (fp32's accuracy, not TF32's)."""
    g = torch.Generator(device=dev).manual_seed(m + 7 * k + n)
    x = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((n, k), generator=g, device=dev)
    b = torch.randn((n,), generator=g, device=dev)
    (rms, big), (rms32, big32) = _against_sgemm(x, w, b)
    assert rms <= 2 * rms32 and big <= 2 * big32, (rms, rms32, big, big32)


def test_split_gemm_on_cell_c_s_own_activations(dev, monkeypatch):
    """One SMILES->PV batch of 128 at published widths: every routed
    linear goes through the kernel (36 text, 12 cross K/V and 85 a
    property step), the predictions are those of the same batch through
    ``nn.Linear`` (cuBLAS SGEMM) within 1e-4, and at C's row counts the
    kernel holds its inputs' products within 2x SGEMM's errors against
    fp64."""
    from torch import nn

    from spmm_tpu_torch.inference.smiles2pv import predict_pv
    from spmm_tpu_torch.models import bert
    from spmm_tpu_torch.models.bert import Linear
    from spmm_tpu_torch.models.spmm import SPMM

    model = SPMM.random_init(0, device=dev)
    g = torch.Generator().manual_seed(11)
    lengths = torch.randint(8, 100, (128,), generator=g)
    lengths[0] = 100
    mask = (torch.arange(100)[None] < lengths[:, None]).int()
    ids = torch.randint(4, 300, (128, 100), generator=g) * mask
    kept, inner = {}, bert.split_linear

    def record(x, w, b=None):
        rows = x.numel() // x.shape[-1]
        key = (rows, w.shape[0], w.shape[1])
        if rows in SPLIT_ROWS and key not in kept:
            kept[key] = (x.reshape(rows, -1).clone(), w, b)
        return inner(x, w, b)

    monkeypatch.setattr(bert, "split_linear", record)
    before = inner.launches
    got = predict_pv(model, ids.to(dev), mask.to(dev), device=dev)
    torch.cuda.synchronize()
    launches = inner.launches - before
    assert launches == 6 * 6 + 6 * 2 + 53 * (6 * 6 + 6 * 8 + 1)
    with monkeypatch.context() as m:
        m.setattr(Linear, "forward", nn.Linear.forward)
        want = predict_pv(model, ids.to(dev), mask.to(dev), device=dev)
    torch.cuda.synchronize()
    assert inner.launches - before == launches
    err = (got - want).abs().max().item()
    assert err <= 1e-4, err
    assert len(kept) >= 8
    for (m, n, k), (x, w, b) in sorted(kept.items()):
        (rms, big), (rms32, big32) = _against_sgemm(x, w, b)
        assert rms <= 2 * rms32 and big <= 2 * big32, (m, n, k, rms, rms32,
                                                       big, big32)


def test_split_gemm_with_tf32_allowed_keeps_f_linear(dev):
    """Under ``allow_tf32`` a Linear in eval mode launches nothing and
    gives ``F.linear``'s TF32 product bit for bit: the control of cell C
    (the program with TF32 products) runs as it did."""
    import torch.nn.functional as F

    from spmm_tpu_torch.models.bert import Linear
    from spmm_tpu_torch.ops.split_gemm import split_linear

    g = torch.Generator(device=dev).manual_seed(5)
    lin = Linear(768, 3072).to(dev).eval()
    x = torch.randn((3456, 768), generator=g, device=dev)
    before = split_linear.launches
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            got = lin(x)
            tf32 = F.linear(x, lin.weight, lin.bias)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert split_linear.launches == before
    assert torch.equal(got, tf32)
    with torch.no_grad():
        lin(x)
    assert split_linear.launches == before + 1


def test_split_gemm_under_graph_capture(dev):
    """A routed linear captured in a CUDA graph replays to the eager
    result bit for bit, with its weight's parts made before the capture or,
    for a weight first seen inside it, by the graph itself."""
    from spmm_tpu_torch.models.bert import Linear
    from spmm_tpu_torch.ops import split_gemm

    g = torch.Generator(device=dev).manual_seed(9)
    warm = Linear(768, 3072).to(dev).eval()
    fresh = Linear(3072, 768).to(dev).eval()
    x = torch.randn((640, 768), generator=g, device=dev)
    with torch.no_grad():
        want = fresh(warm(x))
        key = id(fresh.weight)
        split_gemm._parts.pop(key)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fresh(warm(x))
        assert key not in split_gemm._parts
        x.copy_(torch.randn((640, 768), generator=g, device=dev))
        want2 = fresh(warm(x))
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, want2) and not torch.equal(out, want)


# widths the kernel takes (N a multiple of 96, K of 32) at a small size
WIDE = dict(vocab_size=300, hidden_size=192, num_hidden_layers=3,
            num_attention_heads=3, intermediate_size=384,
            max_position_embeddings=128, type_vocab_size=2, fusion_layer=1,
            encoder_width=192)


def _wide_configs():
    from spmm_tpu_torch.configs import BertArchConfig

    text = BertArchConfig(**WIDE)
    prop = BertArchConfig(**dict(WIDE, vocab_size=1, num_hidden_layers=2,
                                 fusion_layer=2, add_cross_attention=False))
    return text, prop


def _pretrain_inputs(dev, n=8, length=24, seed=3):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(4, 300, (n, length), generator=g)
    ids[:, 0] = 2
    mask = (torch.arange(length)[None]
            < torch.randint(4, length + 1, (n, 1), generator=g)).int()
    mask[0] = 1
    rows = torch.arange(n)
    batch = {"prop": torch.randn((n, 53), generator=g), "ids": ids * mask,
             "mask": mask}
    noise = {"mpm_mask": (torch.rand((n, 53), generator=g) < 0.5).float(),
             "neg_prop_idx": (rows + 1) % n, "neg_text_idx": (rows - 1) % n}
    return ({k: v.to(dev) for k, v in batch.items()},
            {k: v.to(dev) for k, v in noise.items()})


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_pretrain_step_keeps_nn_linear(dev, bf16, monkeypatch):
    """One pretrain step (EMA, the momentum twins' no-grad forward, the
    MLM teacher, AdamW) at widths the kernel takes, fp32 and under bf16
    autocast: it launches the split kernel never, and its losses and every
    parameter, twin and queue after it are bit for bit the same step's
    with ``Linear.forward`` set to ``nn.Linear.forward``."""
    import copy

    from torch import nn

    from spmm_tpu_torch.configs import PretrainConfig
    from spmm_tpu_torch.models.bert import Linear
    from spmm_tpu_torch.ops.split_gemm import split_linear
    from spmm_tpu_torch.training.pretrain import (init_pretrain_state,
                                                  make_pretrain_step)

    text, prop = _wide_configs()
    pcfg = PretrainConfig(embed_dim=16, queue_size=64, bf16_compute=bf16)
    start = init_pretrain_state(0, pcfg, text, prop, device=dev)
    batch, noise = _pretrain_inputs(dev)
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name in ("routed", "nn_linear"):
            model = copy.deepcopy(start)
            with monkeypatch.context() as m:
                if name == "nn_linear":
                    m.setattr(Linear, "forward", nn.Linear.forward)
                before = split_linear.launches
                _, step = make_pretrain_step(model, pcfg, 10,
                                             data_parallel=False)
                res = step(12, batch, None, noise)
                torch.cuda.synchronize()
                assert split_linear.launches == before
            out[name] = (res, model.state_dict())
    finally:
        torch.use_deterministic_algorithms(False)
    (res, got), (ref, want) = out["routed"], out["nn_linear"]
    for key in ("loss", "loss_ita", "loss_itm", "loss_mlm", "loss_mpm"):
        if key in ref:
            assert torch.equal(res[key], ref[key]), key
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def test_fsdp_weights_refilled_between_no_grad_forwards(dev, monkeypatch):
    """FSDP2 on a world-1 NCCL group, the model in eval mode (the case in
    which a Linear would route): two no-grad forwards of the momentum
    property encoder with the twins' shards changed in place between them
    (``ema_update``).  Nothing launches the split kernel, and each forward
    equals the same one with ``Linear.forward`` set to
    ``nn.Linear.forward``; the second sees the changed weights."""
    import copy
    import socket

    import torch.distributed as dist
    from torch import nn

    from spmm_tpu_torch.configs import PretrainConfig
    from spmm_tpu_torch.models.bert import Linear
    from spmm_tpu_torch.ops.split_gemm import split_linear
    from spmm_tpu_torch.parallel import fsdp, mesh
    from spmm_tpu_torch.training.pretrain import (ema_update,
                                                  init_pretrain_state)

    text, prop = _wide_configs()
    start = init_pretrain_state(0, PretrainConfig(embed_dim=16,
                                                  queue_size=64),
                                text, prop, device=dev)
    with torch.no_grad():          # the twins apart from the online weights
        for p in start.property_encoder_m.parameters():
            p.mul_(0.5)
    g = torch.Generator(device=dev).manual_seed(2)
    embeds = torch.randn((4, 54, 192), generator=g, device=dev)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    out = {}
    try:
        fsdp.dp_fsdp_mesh(1, 1)
        for name in ("routed", "nn_linear"):
            model = fsdp.apply_fsdp(copy.deepcopy(start)).eval()
            with monkeypatch.context() as m:
                if name == "nn_linear":
                    m.setattr(Linear, "forward", nn.Linear.forward)
                before = split_linear.launches

                def forward():
                    # the root unit's own weights (the embeddings' LayerNorm)
                    # gathered around it, the layer units' by their hooks
                    model.unshard()
                    y = model.property_encoder_m(inputs_embeds=embeds)
                    model.reshard()
                    return y.clone()

                with torch.no_grad():
                    first = forward()
                    ema_update(model, 0.5)
                    second = forward()
                torch.cuda.synchronize()
                assert split_linear.launches == before
            out[name] = (first, second)
            del model
    finally:
        mesh.clear_mesh()
        dist.destroy_process_group()
    (f1, s1), (f2, s2) = out["routed"], out["nn_linear"]
    assert torch.equal(f1, f2) and torch.equal(s1, s2)
    assert not torch.equal(f1, s1)


def test_split_gemm_refuses_what_it_does_not_take(dev):
    from spmm_tpu_torch.ops.split_gemm import split_linear

    x = torch.randn((4, 768), device=dev)
    with pytest.raises(ValueError, match="multiple of 96"):
        split_linear(x, torch.randn((300, 768), device=dev))
    with pytest.raises(TypeError, match="fp32"):
        split_linear(x.bfloat16(), torch.randn((768, 768), device=dev))
