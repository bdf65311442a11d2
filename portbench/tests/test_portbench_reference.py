"""The plain reference against the port at tiny widths on the CPU, fp32,
the port on its plain attention: the same weights (``portbench.weights``)
and inputs give the same numbers.  The tests import the port; the
reference does not."""

import json
import os

import pytest
import torch

from portbench import weights
from portbench.drivers._common import bert_arch, on_device
from portbench.reference import Reference, detokenize, load_vocab
from portbench.reference.latent_moe import LatentMoeReference, layer_spec
from portbench.tests.tiny import REPO, lm_tiny, shrink_config

CPU = torch.device("cpu")


def config(name: str) -> dict:
    with open(os.path.join(REPO, "portbench", "configs", f"{name}.json")) as f:
        return shrink_config(name, json.load(f))


@pytest.fixture(scope="module")
def spmm():
    from spmm_tpu_torch.models.spmm import SPMM

    cfg = config("spmm")
    model = on_device(SPMM, cfg, 7, CPU, bert_arch(cfg["text"]),
                      bert_arch(cfg["property"]))
    return cfg, model, Reference(cfg, weights.make(cfg, 7, CPU))


@pytest.fixture(scope="module")
def rxn():
    from spmm_tpu_torch.models.rxn import Rxn

    cfg = config("rxn")
    model = on_device(Rxn, cfg, 7, CPU, bert_arch(cfg["decoder"]),
                      bert_arch(cfg["encoder"]))
    return cfg, model, Reference(cfg, weights.make(cfg, 7, CPU))


def test_weights_fill_every_tensor_of_the_port(spmm, rxn):
    for cfg, model, _ in (spmm, rxn):
        names = {name for name, _, _ in weights.spec(cfg)}
        assert names == set(model.state_dict())


def test_weights_follow_the_seed():
    cfg = config("spmm")
    a, b, c = (weights.make(cfg, s, CPU) for s in (3, 3, 2 ** 31 + 5))
    name = "text_encoder.bert.encoder.layer.0.attention.self.query.weight"
    assert torch.equal(a[name], b[name]) and not torch.equal(a[name], c[name])
    word = a["text_encoder.bert.embeddings.word_embeddings.weight"]
    assert not word[0].any()
    assert a["text_encoder.cls.predictions.decoder.weight"] is word


def test_property_encoder(spmm):
    from spmm_tpu_torch.inference.pv2smiles import encode_pv

    cfg, model, ref = spmm
    pv = torch.randn(3, cfg["n_properties"])
    torch.testing.assert_close(ref.encode_pv(pv), encode_pv(model, pv, None),
                               rtol=1e-5, atol=1e-5)


def test_reactant_encoder(rxn):
    from spmm_tpu_torch.models.rxn import encode_reactants

    cfg, model, ref = rxn
    ids = torch.randint(4, 300, (3, 10))
    mask = torch.ones_like(ids)
    mask[1, 7:] = 0
    torch.testing.assert_close(ref.encode_source(ids, mask),
                               encode_reactants(model, ids, mask, "plain"),
                               rtol=1e-5, atol=1e-5)


def test_decoder_teacher_forced(spmm):
    """Log-probabilities of every next token against the port's decoder
    forward over the same tokens (no [PAD] among them)."""
    cfg, model, ref = spmm
    tokens = torch.randint(4, 300, (2, 9))
    tokens[:, 0] = 2
    cross = torch.randn(2, 5, cfg["text"]["hidden_size"])
    cross_mask = torch.ones(2, 5, dtype=torch.int32)
    want = torch.log_softmax(model.text_encoder(
        input_ids=tokens, attention_mask=torch.ones_like(tokens),
        encoder_hidden_states=cross, encoder_attention_mask=cross_mask,
        is_decoder=True), -1)
    torch.testing.assert_close(ref.decoder_logprobs(tokens, cross, cross_mask),
                               want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_served_beams_lie_in_the_reference_top_k(spmm, k):
    """An fp32 beam search of the port takes every token from the
    reference's top k, to rounding."""
    from spmm_tpu_torch.inference.decoding import BeamSpec
    from spmm_tpu_torch.inference.pv2smiles import _beam_batch

    cfg, model, ref = spmm
    pv = torch.randn(4, cfg["n_properties"])
    res = _beam_batch(model, model.text_encoder, pv, None,
                      BeamSpec(k=k, stop_count=k * k * 8, max_steps=8))
    seqs = res["seqs"].reshape(4 * k, -1)[:, :res["steps"] + 1]
    cross = ref.encode_pv(pv).repeat_interleave(k, 0)
    lp = ref.decoder_logprobs(seqs, cross, torch.ones(cross.shape[:2]))
    kth = lp.topk(k, -1).values[:, :-1, -1]
    got = lp[:, :-1].gather(-1, seqs[:, 1:, None])[..., 0]
    assert float((kth - got).max()) <= 1e-5
    torch.testing.assert_close(
        got.sum(1), res["logp"].reshape(-1).float(), rtol=1e-5, atol=1e-4)


def test_smiles2pv(spmm):
    from spmm_tpu_torch.inference.smiles2pv import predict_pv

    cfg, model, ref = spmm
    ids = torch.randint(4, 300, (3, 12))
    mask = torch.ones_like(ids)
    mask[0, 5:] = 0
    mask[2, 9:] = 0
    ids = ids * mask
    want = predict_pv(model, ids, mask, attention_impl="plain", device="cpu")
    torch.testing.assert_close(ref.smiles2pv(ids, mask), want,
                               rtol=1e-5, atol=1e-5)


def test_detokenize_matches_the_port():
    from spmm_tpu_torch.tokenizer import SmilesTokenizer

    tok = SmilesTokenizer()
    vocab = load_vocab(os.path.join(REPO, "portbench", "reference",
                                    "vocab.json"))
    inv = {v: t for t, v in vocab.items()}
    g = torch.Generator().manual_seed(0)
    for _ in range(50):
        ids = torch.randint(0, 300, (int(torch.randint(1, 40, (1,),
                                                       generator=g)),),
                            generator=g).tolist()
        assert detokenize(ids, inv) == tok.decode(ids)


def test_lower_precisions_differ(spmm):
    cfg, _, ref = spmm
    pv = torch.randn(3, cfg["n_properties"])
    fp8 = Reference(cfg, ref.w, "fp8").encode_pv(pv)
    assert float((fp8 - ref.encode_pv(pv)).abs().max()) > 1e-3


def _port_and_reference_search(spmm, k, stop_count, sep_id, seed=0):
    from spmm_tpu_torch.inference.decoding import BeamSpec
    from spmm_tpu_torch.inference.pv2smiles import _beam_batch

    cfg, model, ref = spmm
    pv = torch.randn(5, cfg["n_properties"],
                     generator=torch.Generator().manual_seed(seed))
    spec = BeamSpec(k=k, stop_count=stop_count, max_steps=10, sep_id=sep_id,
                    attention="plain")
    got = _beam_batch(model, model.text_encoder, pv, None, spec)
    cross = ref.encode_pv(pv)
    want = ref.beam_search(cross, torch.ones(cross.shape[:2]), k, 10,
                           stop_count, 2, sep_id)
    return got, want


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("stop", ["unreachable", "k"])
def test_beam_search_matches_the_port(spmm, k, stop):
    """The reference's k-beam search serves the port's beams, fp32: the
    same ids, lengths, harvest counts and steps, and the same scores to
    rounding.  [SEP] is set to a token the search often meets, so beams
    are harvested and molecules stop."""
    _, first = _port_and_reference_search(spmm, k, 10 ** 6, 3)
    tokens = first["seqs"][:, :, 1:].flatten()
    sep_id = int(torch.bincount(tokens[tokens > 3]).argmax())
    stop_count = 10 ** 6 if stop == "unreachable" else k
    got, want = _port_and_reference_search(spmm, k, stop_count, sep_id)
    assert got["steps"] == want["steps"]
    assert int(want["n_finished"].sum()) > 0
    width = want["seqs"].shape[-1]
    assert torch.equal(got["seqs"][..., :width], want["seqs"])
    assert torch.equal(got["lengths"], want["lengths"])
    assert torch.equal(got["n_finished"], want["n_finished"])
    torch.testing.assert_close(got["logp"].float(), want["logp"],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shares", [1, 2, 4])
def test_expert_shares_add_up_to_the_whole_layer(shares):
    """The chip's share of the experts (model-configs, section 4): at hidden
    64 with 16 experts, 4 a token and 1 shared, the outputs of one expert
    layer's ``shares`` shares, each with the shared expert, which every
    chip computes alike, counted once, add up to the uncut layer's.  One
    share of all 16 is the uncut layer bit for bit; more shares sum in
    another order, which fp32 moves by far less than 1e-5 of the largest
    output."""
    whole = lm_tiny(n_routed_experts=16, num_experts_per_tok=4)
    assert whole["n_shared_experts"] == 1
    _shares_add_up(whole, "n_routed_experts", shares)


@pytest.mark.parametrize("shares", [1, 2, 4])
def test_num_experts_shares_add_up_to_the_whole_layer(shares):
    """The same with the experts counted under ``num_experts``
    (Kimi-Linear's key): the layer is the one that ``n_routed_experts``
    gives bit for bit, a cut of it routes over its published 16, and its
    shares add up to the whole layer."""
    named = lm_tiny(n_routed_experts=16, num_experts_per_tok=4)
    whole = {k: v for k, v in named.items() if k != "n_routed_experts"}
    whole["num_experts"] = 16
    layer, seed = 1, 2 ** 31 + 41
    p = f"model.layers.{layer}."
    x = torch.randn(48, 64, generator=torch.Generator().manual_seed(3))
    outs = []
    for cfg in (named, whole):
        ref = LatentMoeReference(cfg, seed, CPU)
        outs.append(ref.moe(x, ref.tensors(layer_spec(cfg, layer)), p))
    assert torch.equal(*outs)
    _shares_add_up(whole, "num_experts", shares)


def _shares_add_up(whole: dict, key: str, shares: int) -> None:
    held = 16 // shares
    cut = dict(whole, **{key: held}, published={key: 16})
    layer, seed = 1, 2 ** 31 + 41
    p = f"model.layers.{layer}."
    x = torch.randn(48, 64, generator=torch.Generator().manual_seed(3))
    ref = LatentMoeReference(whole, seed, CPU)
    want = ref.moe(x, ref.tensors(layer_spec(whole, layer)), p)
    got, routed = None, []
    for first in range(0, 16, held):
        part = LatentMoeReference(cut, seed, CPU, first_expert=first)
        w = part.tensors(layer_spec(cut, layer, first))
        assert len([n for n in w if ".experts." in n]) == 3 * held
        assert w[f"{p}mlp.gate.weight"].shape == (16, 64)
        out = part.moe(x, w, p)
        shared = part.swiglu(x, w, f"{p}mlp.shared_experts.")
        routed.append(out - shared)
        got = out if got is None else got + out - shared
    if shares == 1:
        assert torch.equal(got, want)
    else:
        assert all(r.abs().max() > 0 for r in routed)
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
