"""The frozen counts against ``FlopCounterMode`` at tiny widths: over the
port's forward where it does only the needed work (unpadded encoders, the
cached decode step at one beam, the prologues), and over the plain
reference's where the port pads (SMILES -> PV's property segments).

``FlopCounterMode`` counts matrix products only.  Where the port or the
reference computes a product that the counts leave out as not needed, or
the counts hold a product that the code computes elementwise, the test
names the difference."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, lm_counts, weights
from portbench.drivers._common import bert_arch, on_device
from portbench.reference import Reference
from portbench.tests.tiny import (
    LM_CELL, LM_CONFIG, REPO, lm_tiny, shrink_config)


def flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def config(name: str) -> dict:
    with open(os.path.join(REPO, "portbench", "configs", f"{name}.json")) as f:
        return shrink_config(name, json.load(f))


@pytest.fixture(scope="module")
def spmm():
    from spmm_tpu_torch.models.spmm import SPMM

    cfg = config("spmm")
    return cfg, on_device(SPMM, cfg, 5, torch.device("cpu"),
                          bert_arch(cfg["text"]), bert_arch(cfg["property"]))


@pytest.fixture(scope="module")
def rxn():
    from spmm_tpu_torch.models.rxn import Rxn

    cfg = config("rxn")
    return cfg, on_device(Rxn, cfg, 5, torch.device("cpu"),
                          bert_arch(cfg["decoder"]), bert_arch(cfg["encoder"]))


@pytest.mark.parametrize("b,n", [(1, 7), (3, 12)])
def test_text_section_unpadded(spmm, b, n):
    cfg, model = spmm
    ids = torch.randint(4, 300, (b, n))
    got = flops(lambda: model.encode_text(ids, torch.ones_like(ids)))
    assert got == counts.encoder(cfg["text"], [n] * b,
                                 range(cfg["text"]["fusion_layer"]))


def test_pv_prologue(spmm):
    from spmm_tpu_torch.inference.decoding import precompute_cross_kv
    from spmm_tpu_torch.inference.pv2smiles import encode_pv

    cfg, model = spmm
    pv = torch.randn(3, cfg["n_properties"])
    got = flops(lambda: precompute_cross_kv(
        model.text_encoder, model.text_cfg, encode_pv(model, pv, None)))
    assert got == counts.pv_prologue(cfg["text"], cfg["property"], 3,
                                     cfg["n_properties"])


def test_rxn_prologue(rxn):
    from spmm_tpu_torch.inference.decoding import precompute_cross_kv
    from spmm_tpu_torch.models.rxn import encode_reactants

    cfg, model = rxn
    ids = torch.randint(4, 300, (2, 9))
    got = flops(lambda: precompute_cross_kv(
        model.text_encoder, model.decoder_cfg,
        encode_reactants(model, ids, torch.ones_like(ids), "plain")))
    assert got == counts.rxn_prologue(cfg["encoder"], cfg["decoder"], [9, 9])


@pytest.mark.parametrize("pos", [0, 3, 5])
def test_cached_decode_step_one_beam(spmm, pos):
    """At k=1 the port's step attends exactly its prefix; the self term is
    elementwise in the plain kernel-1 version, so FlopCounterMode misses
    4·H FLOPs a row and layer of the count."""
    from spmm_tpu_torch.inference.decoding import (
        decode_step, init_beam_cache_kv, precompute_cross_kv)

    cfg, model = spmm
    text, m, le = cfg["text"], 3, 5
    cross = precompute_cross_kv(model.text_encoder, model.text_cfg,
                                torch.randn(m, le, text["hidden_size"]))
    cache = init_beam_cache_kv(model.text_cfg, m, 1, 8, torch.float32, "cpu")
    got = flops(lambda: decode_step(
        model.text_encoder, model.text_cfg, torch.full((m,), 7), pos, cache,
        torch.ones((m, 8), dtype=torch.int32), cross,
        torch.ones((m, le), dtype=torch.int32),
        torch.zeros((m, 1, 8), dtype=torch.long), attention="plain"))
    self_terms = text["num_hidden_layers"] * counts.attention(
        text["hidden_size"], m)
    assert got == counts.decode_step(text, m, pos, m * le) - self_terms


def test_beam_decode_sums_its_steps(spmm):
    text = spmm[0]["text"]
    want = counts.decode_step(text, 4, 0, 4 * 54) + sum(
        counts.decode_step(text, 8, p, 8 * 54) for p in range(1, 6))
    assert counts.beam_decode(text, 4, 2, 6, 4 * 54) == want


def test_smiles2pv_against_the_reference_at_valid_positions(spmm):
    """Row by row at its own length, the reference recomputes the cross
    K/V at every property step and computes the causal fusion
    self-attention over every (query, key) pair: the counts hold neither."""
    cfg, _ = spmm
    text, prop = cfg["text"], cfg["property"]
    n_props = 6
    cfg = dict(cfg, n_properties=n_props)
    ref = Reference(cfg, weights.make(cfg, 5, torch.device("cpu")))
    lengths = [4, 9]
    got = sum(flops(lambda n=n: ref.smiles2pv(
        torch.randint(4, 300, (1, n)), torch.ones((1, n), dtype=torch.int32)))
        for n in lengths)
    n_fusion = text["num_hidden_layers"] - text["fusion_layer"]
    h = text["hidden_size"]
    extra = 0.0
    for n in lengths:
        extra += (n_props - 1) * counts.cross_kv(text, n)
        for i in range(n_props):
            extra += n_fusion * counts.attention(
                h, (i + 1) ** 2 - (i + 1) * (i + 2) // 2)
    want = counts.smiles2pv(text, prop, lengths, n_props)
    assert got == pytest.approx(want + extra, rel=1e-12)


def test_kernel1_flops_one_beam():
    """The plain kernel-1 version's products at k=1: the prefix, with the
    self term elementwise."""
    from spmm_tpu_torch.ops.decode_attention import (
        beam_decode_attention_reference)

    m, h, d, pos, T = 3, 2, 16, 5, 8
    q, kn, vn = (torch.randn(m, h, 1, d) for _ in range(3))
    cache = torch.zeros(2, 1, m, h, 1, T, d)
    mask = torch.zeros(m, 1, 1, T)
    got = flops(lambda: beam_decode_attention_reference(
        q, kn, vn, cache, mask, pos, 0))
    _, want = counts.k1_launch(m, 1, h, d, pos, "fp32")
    assert got == want - counts.attention(h * d, m)


def test_kernel2_flops_unpadded():
    from spmm_tpu_torch.ops.fused_attention import fused_mha_reference

    b, h, lq, lk, d = 2, 3, 5, 7, 16
    q = torch.randn(b, h, lq, d)
    k, v = torch.randn(b, h, lk, d), torch.randn(b, h, lk, d)
    got = flops(lambda: fused_mha_reference(q, k, v, None))
    _, want = counts.k2_launch(h, d, b * lq, b * lk, b * lq * lk, "fp32")
    assert got == want


def test_kernel_bytes_and_bounds():
    """Kernel 1 reads one cache lane a prefix position; a launch's bound is
    its bytes or its operations, whichever takes longer."""
    nbytes, fl = counts.k1_launch(512, 2, 12, 64, 100, "bf16")
    assert nbytes == (2 * 512 * 100 * 12 * 64 * 2 + 4 * 512 * 2 * 100
                      + 6 * 512 * 12 * 2 * 64 * 2)
    assert counts.bound_s(nbytes, fl, counts.PEAK_FLOPS["fp32"]) == \
        nbytes / counts.HBM_BYTES_PER_S
    launches, total = counts.k1_batch_bound_s(512, 2, 12, 64, 101, 12, "bf16")
    assert launches == 1212 and total > 0
    nbytes, fl = counts.k2_launch(12, 64, 128 * 100, 128 * 100,
                                  128 * 100 * 100, "fp32")
    assert fl == 4 * 768 * 128 * 100 * 100
    assert nbytes == 4 * (2 * 768 * 12800 * 2)
    launches, _ = counts.k2_smiles2pv_bound_s(
        config("spmm")["text"], config("spmm")["property"], [5, 9], 53,
        "fp32")
    assert launches == 2 + 53 * (2 + 2 * 2)


def test_moonlight_work_is_unchanged():
    """Cell M's counts, which ``mfu``, ``k3_roofline`` and
    ``moe_product_roofline`` read, as they stood before the counts learnt
    of a share of the experts: every seed holds the same work."""
    from portbench.drivers import lm_turn

    with open(os.path.join(REPO, "portbench", "configs",
                           f"{LM_CONFIG}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(REPO, "portbench", "traffic",
                           f"{LM_CELL}.json")) as f:
        mix = json.load(f)
    work = lm_turn.Driver(cfg, mix, 2 ** 31 + 5, torch.device("cpu")).work(
        {}, {"steps": 127})
    assert work == {"model_flops": 425925883723776.0,
                    "peak_flops": 989000000000000.0, "steps": 127,
                    "k3": (6858, 0.7869998743307464),
                    "moe_product": (6656, 1.1887333193463439)}


@pytest.mark.parametrize("shares", [2, 4, 8])
def test_expert_shares_split_the_expert_counts(shares):
    """Over the shares of 16 experts (4 a token), the held experts' work
    and the experts they touch add up to the whole layer's; the router's
    work is every share's, at the published 16."""
    whole = lm_tiny(n_routed_experts=16, num_experts_per_tok=4)
    cut = dict(whole, n_routed_experts=16 // shares,
               published={"n_routed_experts": 16})
    h, inter = whole["hidden_size"], whole["moe_intermediate_size"]
    routed = 3 * h * inter * 4
    assert lm_counts.token_macs(cut, 1) == pytest.approx(
        lm_counts.token_macs(whole, 1) - routed * (1 - 1 / shares),
        rel=1e-12)
    assert lm_counts.token_macs(cut, 0) == lm_counts.token_macs(whole, 0)
    for tokens in (1, 7, 300):
        assert shares * lm_counts.experts_touched(cut, tokens) == \
            pytest.approx(lm_counts.experts_touched(whole, tokens),
                          rel=1e-12)
        assert shares * lm_counts.moe_launches(cut, tokens)[1] == \
            pytest.approx(lm_counts.moe_launches(whole, tokens)[1], rel=1e-12)


def test_num_experts_counts_as_n_routed_experts():
    """The counts read the experts under either key: a configuration that
    counts them as ``num_experts`` (Kimi-Linear's key), whole or cut to a
    share, needs the work that the same counts under ``n_routed_experts``
    need."""
    named = lm_tiny(n_routed_experts=16, num_experts_per_tok=4)
    whole = {k: v for k, v in named.items() if k != "n_routed_experts"}
    for held in (16, 4):
        a = dict(named, n_routed_experts=held,
                 published={"n_routed_experts": 16})
        b = dict(whole, num_experts=held, published={"num_experts": 16})
        assert lm_counts.token_macs(b, 1) == lm_counts.token_macs(a, 1)
        assert lm_counts.moe_launches(b, 300) == lm_counts.moe_launches(a, 300)
        assert lm_counts.moe_turn_bound_s(b, 3, 4, 5) == \
            lm_counts.moe_turn_bound_s(a, 3, 4, 5)
