"""Port parity: the reaction-prediction slice of spmm_tpu_torch vs spmm_tpu,
on the same weights and inputs (tiny configs, numpy inputs from a seed).

Bars:
- configs field by field, the weight bridge strict;
- ``encode_reactants`` within 1e-5 (the BERT-forward bar of
  test_torch_models.py), attention "plain" and "kernel" (its plain version
  on the CPU) against JAX's XLA forward;
- ``load_encoder_from_pretrain`` equal to JAX's ``load_encoder_from_pretrain``
  and ``_tree`` on an ``export_spmm_state_dict`` state;
- ``rxn_loss`` within 2e-5 in fp32, with padded targets;
- ``greedy_decode``: ``seqs`` exact and ``steps`` equal against JAX's
  attention "xla" and "pallas" (interpret mode), with padded cross masks, a
  [SEP] bias that stops rows at different steps, and the stochastic mode
  fed the uniforms of JAX's own Gumbel draws.  JAX's XLA buffer is max_steps + 2 long, its
  kernel buffer and the port's 8-aligned: the decoded prefix is compared;
- ``predict_greedy`` / ``predict_beam`` (k=3, stop_count 9): the same
  strings as JAX's over sources of mixed lengths, in fp32, through JAX's
  XLA and Pallas-interpret paths;
- bf16: the first step's logits within 2e-2 of JAX's, with JAX's dtype
  placement (fp32 encoder, bf16 decoder, encoder output and cache), and
  the greedy loop fed the same bf16 logits gives the same ``seqs``;
- ``metric_eval``, ``USPTODataset`` and the two PV->SMILES CLIs'
  ``metric_eval`` / ``read_condition`` equal JAX's.
"""

import dataclasses
import functools
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spmm_tpu.configs import BertArchConfig as JaxCfg
from spmm_tpu.inference import decoding as jdec
from spmm_tpu.inference import rxn as jrxn
from spmm_tpu.models import rxn as jmodel

from spmm_tpu_torch.checkpoint.convert import (
    rxn_state_dict_from_jax_tree, state_dict_from_jax_tree)
from spmm_tpu_torch.configs import BertArchConfig as TorchCfg
from spmm_tpu_torch.inference import decoding
from spmm_tpu_torch.inference import rxn
from spmm_tpu_torch.models.rxn import (
    Rxn, encode_reactants, load_encoder_from_pretrain, rxn_loss)
from spmm_tpu_torch.tokenizer import SmilesTokenizer

from torch_parity import (CPU, TINY, jax_configs, jax_tree, t, to_jax,
                          torch_configs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny analogue of smiles_config: no cross-attention, every layer text
ENC = dict(TINY, num_hidden_layers=2, fusion_layer=2)
CROSS_SCALE = 30.0          # lets the sources steer the tiny decoder
SEP_BIAS = 0.6              # rows emit [SEP] at different steps


def rxn_jax_configs():
    return (JaxCfg(**TINY, add_cross_attention=True),
            JaxCfg(**ENC, add_cross_attention=False))


def rxn_torch_configs():
    return tuple(TorchCfg(**dataclasses.asdict(c))
                 for c in rxn_jax_configs())


def rxn_tree(seed: int = 0, sep_bias: float = 0.0) -> dict:
    """A tiny reaction tree with numpy leaves.  The decoder's cross-attention
    K/V weights are scaled up so that different sources decode differently;
    ``sep_bias`` raises the [SEP] logit so that rows finish."""
    dc, ec = rxn_jax_configs()
    tree = jax.tree.map(np.asarray, jmodel.init_rxn_params(
        jax.random.PRNGKey(seed), dc, ec))
    for layer in tree["decoder"]["bert"]["layers"]:
        if "cross_attn" in layer:
            for name in ("k", "v"):
                layer["cross_attn"][name]["w"] = (
                    layer["cross_attn"][name]["w"] * CROSS_SCALE)
    b = tree["decoder"]["mlm_head"]["decoder"]["b"].copy()
    b[3] += sep_bias
    tree["decoder"]["mlm_head"]["decoder"]["b"] = b
    return tree


def port_rxn(tree: dict) -> Rxn:
    dc, ec = rxn_torch_configs()
    model = Rxn(dc, ec)
    model.load_state_dict(rxn_state_dict_from_jax_tree(tree, dc, ec),
                          strict=True)
    return model.eval()


def reactions(n: int) -> list[str]:
    """n synthetic reactant strings of mixed lengths: one, two or three
    SMILES of examples/s2p_input.txt joined by '.'."""
    with open(os.path.join(REPO, "examples", "s2p_input.txt")) as f:
        smiles = [line.strip() for line in f if line.strip()]
    return [".".join(smiles[(i + j) % len(smiles)] for j in range(1 + i % 3))
            for i in range(n)]


@pytest.fixture(scope="module")
def pair():
    torch.set_num_threads(1)
    tree = rxn_tree(0, sep_bias=SEP_BIAS)
    return tree, port_rxn(tree)


def test_smiles_config_matches_jax():
    from spmm_tpu.configs import smiles_config as jsmiles

    from spmm_tpu_torch.configs import smiles_config

    assert dataclasses.asdict(smiles_config()) == dataclasses.asdict(jsmiles())


def test_bridge_checks_layer_counts(pair):
    tree, _ = pair
    dc, ec = rxn_torch_configs()
    with pytest.raises(ValueError, match="smiles_encoder has 2 layers"):
        rxn_state_dict_from_jax_tree(tree, dc, dataclasses.replace(
            ec, num_hidden_layers=3))
    state = rxn_state_dict_from_jax_tree(tree, dc, ec)
    assert set(state) == set(Rxn(dc, ec).state_dict())


def src_batch(tok=None):
    ids, mask = (tok or SmilesTokenizer()).encode_batch(
        ["[CLS]" + s for s in reactions(5)], max_len=64, truncation=False,
        buckets=(32, 64))
    assert (mask == 0).any() and ids.shape == (5, 64)
    return ids, mask


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_encode_reactants_matches_jax(pair, impl):
    tree, model = pair
    _, ec = rxn_jax_configs()
    ids, mask = src_batch()
    want = jmodel.encode_reactants(to_jax(tree), ec, jnp.asarray(ids),
                                   jnp.asarray(mask))
    with torch.no_grad():
        got = encode_reactants(model, t(ids), t(mask), attention_impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_load_encoder_from_pretrain_matches_jax(pair):
    from spmm_tpu.checkpoint.export import export_spmm_state_dict

    tree, _ = pair
    pretrain = jax_tree(5)
    tcj, pcj = jax_configs()
    _, ec = rxn_jax_configs()
    state = {k: torch.from_numpy(np.array(v, np.float32))
             for k, v in export_spmm_state_dict(pretrain, tcj, pcj).items()}
    via_state = jmodel.load_encoder_from_pretrain(
        tree, {k: v.numpy() for k, v in state.items()}, ec)
    via_tree = jmodel.load_encoder_from_pretrain_tree(tree, pretrain, ec)
    model = port_rxn(tree)
    decoder_before = {k: v.clone()
                      for k, v in model.text_encoder.state_dict().items()}
    load_encoder_from_pretrain(model, state)
    dc, ec_t = rxn_torch_configs()
    for want_tree in (via_state, via_tree):
        want = rxn_state_dict_from_jax_tree(
            jax.tree.map(np.asarray, want_tree), dc, ec_t)
        for k, v in model.state_dict().items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    for k, v in model.text_encoder.state_dict().items():
        assert torch.equal(v, decoder_before[k])
    missing = dict(state)
    del missing["text_encoder.bert.encoder.layer.1.output.dense.bias"]
    with pytest.raises(KeyError, match="layer.1.output.dense.bias"):
        load_encoder_from_pretrain(port_rxn(tree), missing)


def test_rxn_loss_matches_jax(pair):
    tree, model = pair
    dc, ec = rxn_jax_configs()
    tok = SmilesTokenizer()
    src_ids, src_mask = src_batch(tok)
    tgt_ids, tgt_mask = tok.encode_batch(
        ["[CLS]" + s for s in reactions(8)[3:]], max_len=48, buckets=(48,),
        drop_leading_cls=False)
    assert (tgt_ids == 0).any()
    want = jmodel.rxn_loss(to_jax(tree), dc, ec, jnp.asarray(src_ids),
                           jnp.asarray(src_mask), jnp.asarray(tgt_ids),
                           jnp.asarray(tgt_mask))
    with torch.no_grad():
        got = rxn_loss(model, t(src_ids), t(src_mask), t(tgt_ids, torch.int64),
                       t(tgt_mask))
    np.testing.assert_allclose(got.item(), float(want), atol=2e-5, rtol=0)


@pytest.fixture(scope="module")
def jgreedy():
    return jax.jit(jdec.greedy_decode,
                   static_argnames=("cfg", "max_steps", "stochastic",
                                    "attention"))


def cross_inputs(b: int = 4):
    enc = np.random.default_rng(7).normal(size=(b, 9, 64)).astype(np.float32)
    lens = np.array([9, 5, 7, 3])[:b]
    return enc, (np.arange(9)[None] < lens[:, None]).astype(np.int32)


@pytest.mark.parametrize("jax_attention,sep_bias,stochastic", [
    ("xla", SEP_BIAS, False),
    ("pallas", SEP_BIAS, False),
    ("xla", 0.0, False),         # nobody stops: all max_steps steps
    ("xla", SEP_BIAS, True),     # JAX's Gumbel uniforms injected
], ids=["xla", "pallas", "no_stop", "stochastic"])
def test_greedy_decode_matches_jax(jgreedy, jax_attention, sep_bias,
                                   stochastic):
    tree = rxn_tree(1, sep_bias=sep_bias)
    dc, _ = rxn_jax_configs()
    dct, _ = rxn_torch_configs()
    enc, mask = cross_inputs()
    steps = 24
    rng = jax.random.PRNGKey(3)
    want = jax.device_get(jgreedy(
        to_jax(tree)["decoder"], dc, jnp.asarray(enc), jnp.asarray(mask),
        max_steps=steps, stochastic=stochastic, rng=rng,
        attention=jax_attention))

    def uniforms(step):
        # the uniforms jax.random.gumbel draws under categorical's key
        return t(jax.random.uniform(
            jax.random.fold_in(rng, step), (4, dct.vocab_size), jnp.float32,
            minval=jnp.finfo(jnp.float32).tiny, maxval=1.0))

    got = decoding.greedy_decode(port_rxn(tree).text_encoder, dct, t(enc),
                                 t(mask), max_steps=steps,
                                 stochastic=stochastic, uniforms=uniforms)
    seqs = got["seqs"].numpy()
    assert seqs.shape == (4, 32)
    n = want["seqs"].shape[1]
    np.testing.assert_array_equal(seqs[:, :n], want["seqs"])
    assert got["steps"] == int(want["steps"])
    first_sep = [int(np.argmax(r == 3)) for r in seqs]
    if sep_bias and not stochastic:
        # the stop rule ran, rows stopped at different steps and went on
        # appending after their [SEP]
        assert got["steps"] < steps and len(set(first_sep)) > 1
        assert (seqs[:, 1:got["steps"] + 1] != 0).all()
    if not sep_bias:
        assert got["steps"] == steps


def test_stochastic_greedy_takes_its_noise_from_uniforms():
    """Stochastic mode needs ``uniforms``; the same draws give the same
    seqs, other draws others."""
    tree = rxn_tree(1, sep_bias=SEP_BIAS)
    dct, _ = rxn_torch_configs()
    model = port_rxn(tree).text_encoder
    enc, mask = cross_inputs()

    def run(seed=None):
        draws = None if seed is None else decoding.torch_uniforms(
            torch.Generator().manual_seed(seed), 4, 1, dct.vocab_size, "cpu")
        uniforms = None if draws is None else (
            lambda step: draws(step).reshape(4, dct.vocab_size))
        return decoding.greedy_decode(model, dct, t(enc), t(mask),
                                      max_steps=12, stochastic=True,
                                      uniforms=uniforms)

    with pytest.raises(ValueError, match="uniforms"):
        run()
    a, b, c = run(5), run(5), run(6)
    assert torch.equal(a["seqs"], b["seqs"])
    assert not torch.equal(a["seqs"], c["seqs"])


def test_greedy_runs_every_layer_through_the_kernels(pair, monkeypatch):
    from spmm_tpu_torch.ops import attention

    tree, model = pair
    seen = {"bda": [], "mha": []}
    real_bda, real_mha = decoding.beam_decode_attention, attention.fused_mha

    def bda(q, k_new, v_new, cache, mask, pos, layer):
        seen["bda"].append((tuple(cache.shape), tuple(mask.shape), pos, layer))
        return real_bda(q, k_new, v_new, cache, mask, pos, layer)

    def mha(q, k, v, mask=None):
        seen["mha"].append((q.shape[2], k.shape[2]))
        return real_mha(q, k, v, mask)

    monkeypatch.setattr(decoding, "beam_decode_attention", bda)
    monkeypatch.setattr(attention, "fused_mha", mha)
    ids, mask = src_batch()
    res = rxn._greedy_batch(model, model.text_encoder, t(ids), t(mask),
                            max_steps=12)
    dc, ec = rxn_torch_configs()
    n, L = res["steps"], dc.num_hidden_layers
    assert len(seen["bda"]) == L * n and len(seen["mha"]) == \
        ec.num_hidden_layers
    assert seen["mha"][0] == (64, 64)
    cache_shape, mask_shape, _, _ = seen["bda"][0]
    assert cache_shape == (2, L, 5, dc.num_attention_heads, 1, 16,
                           dc.head_dim)
    assert mask_shape == (5, 1, 1, 16)
    assert [(p, layer) for *_, p, layer in seen["bda"]] == [
        (p, layer) for p in range(n) for layer in range(L)]
    # "plain" reaches neither kernel wrapper
    seen["bda"].clear()
    seen["mha"].clear()
    rxn._greedy_batch(model, model.text_encoder, t(ids), t(mask),
                      max_steps=12, attention="plain")
    assert not seen["bda"] and not seen["mha"]


def _fresh_jax_path(monkeypatch, jax_attention):
    """Route JAX's predict_* through fp32 (bf16=False) and the given
    attention path, with freshly jitted batch functions so that no trace of
    another path is reused; the JAX package reaches the tiny configs
    through its own text_config / smiles_config names."""
    dc, ec = rxn_jax_configs()
    monkeypatch.setattr(jrxn, "text_config", lambda: dc)
    monkeypatch.setattr(jrxn, "smiles_config", lambda: ec)
    monkeypatch.setattr(jrxn, "_greedy_batch", jax.jit(functools.partial(
        jrxn._greedy_batch.__wrapped__, bf16=False)))
    monkeypatch.setattr(jrxn, "_beam_batch", jax.jit(functools.partial(
        jrxn._beam_batch.__wrapped__, bf16=False), static_argnums=4))
    monkeypatch.setattr(jrxn, "greedy_decode", functools.partial(
        jdec.greedy_decode, attention=jax_attention))
    monkeypatch.setattr(jrxn, "BeamSpec", functools.partial(
        jdec.BeamSpec, attention=jax_attention))


@pytest.mark.parametrize("jax_attention", ["xla", "pallas"])
def test_predict_greedy_matches_jax(pair, monkeypatch, jax_attention):
    from spmm_tpu.tokenizer import SmilesTokenizer as JTok

    tree, model = pair
    _fresh_jax_path(monkeypatch, jax_attention)
    sources = reactions(7)
    want = jrxn.predict_greedy(to_jax(tree), JTok(), sources, batch_size=4)
    got = rxn.predict_greedy(model, SmilesTokenizer(), sources, batch_size=4,
                             bf16=False, device=CPU)
    assert got == want and len(set(got)) > 1


@pytest.mark.parametrize("jax_attention", ["xla", "pallas"])
def test_predict_beam_matches_jax(pair, monkeypatch, jax_attention):
    from spmm_tpu.tokenizer import SmilesTokenizer as JTok

    tree, model = pair
    _fresh_jax_path(monkeypatch, jax_attention)
    sources = reactions(5)
    want = jrxn.predict_beam(to_jax(tree), JTok(), sources, k=3,
                             batch_size=8)
    got = rxn.predict_beam(model, SmilesTokenizer(), sources, k=3,
                           batch_size=8, bf16=False, device=CPU)
    assert got == want
    assert all(1 <= len(c) <= 3 for c in got)


def test_greedy_bf16_first_step_matches_jax(pair, monkeypatch):
    """bf16 placement as in JAX's _greedy_batch (rxn.py:40-50): fp32
    encoder, bf16 decoder, bf16 encoder output and KV cache.  The [CLS]
    step's logits agree within 2e-2."""
    tree, model = pair
    dc, ec = rxn_jax_configs()
    ids, mask = src_batch()
    jt = to_jax(tree)
    enc = jmodel.encode_reactants(jt, ec, jnp.asarray(ids),
                                  jnp.asarray(mask)).astype(jnp.bfloat16)
    dec = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jt["decoder"])
    T = 16
    seqs = jnp.zeros((5, T), jnp.int32).at[:, 0].set(2)
    want, _ = jdec.decode_step(
        dec, dc, seqs[:, 0], jnp.int32(0),
        jdec.init_self_cache(dc, 5, T, jnp.bfloat16),
        (seqs != 0).astype(jnp.int32), jdec.precompute_cross_kv(dec, dc, enc),
        jnp.asarray(mask))

    seen = []
    real = decoding.decode_step

    def capture(model_, cfg, token, pos, cache, key_valid, cross_kv, *rest):
        logits = real(model_, cfg, token, pos, cache, key_valid, cross_kv,
                      *rest)
        seen.append((logits, cache.dtype, cross_kv["k"].dtype))
        return logits

    monkeypatch.setattr(decoding, "decode_step", capture)
    res = rxn._greedy_batch(model, rxn.decoder_for(model, bf16=True), t(ids),
                            t(mask), max_steps=1)
    assert res["steps"] == 1 and len(seen) == 1
    logits, cache_dtype, cross_dtype = seen[0]
    assert logits.dtype == cache_dtype == cross_dtype == torch.bfloat16
    assert next(model.parameters()).dtype == torch.float32
    np.testing.assert_allclose(logits.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=0)


def test_greedy_bookkeeping_bf16_matches_jax(monkeypatch):
    """Both greedy loops fed the same bf16 logits (decode_step replaced by
    a table lookup): seqs and steps agree exactly."""
    steps, b = 10, 4
    rng = np.random.default_rng(9)
    table = (3.0 * rng.normal(size=(steps, b, 300))).astype(np.float32)
    table[:, :, 3] += np.array([6.0, 7.5, 9.0, 12.0])      # staggered stops
    jtable = jnp.asarray(table, jnp.bfloat16)
    ttable = t(jtable.astype(jnp.float32)).to(torch.bfloat16)

    def jax_step(params, cfg, token, pos, cache, *args, **kwargs):
        return jtable[pos], cache

    def port_step(model, cfg, token, pos, cache, *args):
        assert cache.dtype == torch.bfloat16
        return ttable[pos]

    monkeypatch.setattr(jdec, "decode_step", jax_step)
    monkeypatch.setattr(decoding, "decode_step", port_step)
    tree = rxn_tree(0)
    dc, _ = rxn_jax_configs()
    dct, _ = rxn_torch_configs()
    enc, mask = cross_inputs(b)
    dec = jax.tree.map(lambda x: x.astype(jnp.bfloat16), to_jax(tree)["decoder"])
    want = jax.device_get(jdec.greedy_decode(
        dec, dc, jnp.asarray(enc, jnp.bfloat16),
        jnp.asarray(mask), max_steps=steps, cache_dtype=jnp.bfloat16,
        attention="xla"))
    model = port_rxn(tree)
    got = decoding.greedy_decode(
        rxn.decoder_for(model, bf16=True), dct, t(enc).to(torch.bfloat16),
        t(mask),
        max_steps=steps, cache_dtype=torch.bfloat16)
    n = want["seqs"].shape[1]
    np.testing.assert_array_equal(got["seqs"].numpy()[:, :n], want["seqs"])
    assert got["steps"] == int(want["steps"]) < steps


def test_metric_eval_matches_jax():
    from spmm_tpu.cli.rxn_prediction import metric_eval as jmetric

    from spmm_tpu_torch.cli.rxn_prediction import metric_eval

    refs = ["CCO", "c1ccccc1", "C(C", "CC(=O)O", "CCN"]
    cands = [["CCO", "CC"], ["c1ccccc1"], ["CCO"], ["C(C", "CC(=O)O"],
             "CCN"]
    assert metric_eval(refs, cands) == jmetric(refs, cands) == 0.8
    assert metric_eval(refs, ["CC"] * 5) == jmetric(refs, ["CC"] * 5) == 0.0


@pytest.mark.parametrize("augment", [False, True])
def test_uspto_dataset_matches_jax(tmp_path, augment):
    from spmm_tpu.data.datasets import USPTODataset as JDataset

    from spmm_tpu_torch.data.datasets import USPTODataset

    path = tmp_path / "pairs.txt"
    srcs = reactions(6)
    path.write_text("\n".join(f"{s}\t{s.split('.')[0]}" for s in srcs)
                    + "\n\nC(C\tCC\n")
    got = USPTODataset(str(path), augment=augment, seed=3)
    want = JDataset(str(path), augment=augment, seed=3)
    assert len(got) == len(want) == 7
    assert [got[i] for i in range(7)] == [want[i] for i in range(7)]
    part = USPTODataset(str(path), data_range=(1, 3))
    assert [part[i] for i in range(2)] == [
        JDataset(str(path), data_range=(1, 3))[i] for i in range(2)]


def test_pv2smiles_single_cli_pieces_match_jax(tmp_path, capsys):
    from spmm_tpu.chem.normalize import PropertyStats as JStats
    from spmm_tpu.cli import pv2smiles_single as jcli

    from spmm_tpu_torch.chem.normalize import PropertyStats
    from spmm_tpu_torch.cli import pv2smiles_single as cli

    csv_path = os.path.join(REPO, "examples", "p2s_input.csv")
    got = cli.read_condition(csv_path, PropertyStats.load())
    want = jcli.read_condition(csv_path, JStats.load())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1] == 0).sum() == 4

    cands = reactions(6) + ["C(C", "", "CCO", "CCO"]
    outputs = []
    for mod, stats in ((jcli, JStats.load()), (cli, PropertyStats.load())):
        out = tmp_path / f"{mod.__name__}.txt"
        random.seed(11)
        mod.metric_eval(got[0], list(cands), got[1], stats, str(out))
        outputs.append((out.read_text(),
                        capsys.readouterr().out.replace(str(out), "")))
    assert outputs[0] == outputs[1]
    assert "validity: 0.8" in outputs[1][1]


def test_pv2smiles_batched_cli_pieces_match_jax(tmp_path, capsys):
    from spmm_tpu.chem.normalize import PropertyStats as JStats
    from spmm_tpu.cli import pv2smiles_batched as jcli

    from spmm_tpu_torch.chem.normalize import PropertyStats
    from spmm_tpu_torch.cli import pv2smiles_batched as cli

    refs = reactions(5)
    cands = [refs[0], "C(C", refs[2].split(".")[0], "", "CCO"]
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("CCO\n" + refs[0] + "\n")
    outputs = []
    for mod, stats in ((jcli, JStats.load()), (cli, PropertyStats.load())):
        out = tmp_path / f"{mod.__name__}.txt"
        mod.metric_eval(refs, cands, stats, str(out),
                        novelty_corpus=str(corpus))
        outputs.append((out.read_text(),
                        capsys.readouterr().out.replace(str(out), "")))
    assert outputs[0] == outputs[1]
    assert "novelty: 0.3333" in outputs[1][1]


@pytest.mark.parametrize("n_beam", [1, 3])
def test_evaluate_runs_on_cpu(pair, tmp_path, n_beam):
    from spmm_tpu_torch.cli.rxn_prediction import evaluate, metric_eval
    from spmm_tpu_torch.data.datasets import USPTODataset

    _, model = pair
    srcs = reactions(5)
    path = tmp_path / "test_parsed.txt"
    path.write_text("".join(f"{s}\t{s.split('.')[0]}\n" for s in srcs))
    tok = SmilesTokenizer()
    ds = USPTODataset(str(path))
    acc = evaluate(model, tok, ds, n_beam, batch_size=4, device="cpu")
    refs = [s.split(".")[0] for s in srcs]
    if n_beam == 1:
        cands = rxn.predict_greedy(model, tok, srcs, batch_size=4,
                                   device="cpu")
    else:
        cands = rxn.predict_beam(model, tok, srcs, k=3, batch_size=4,
                                 device="cpu")
    assert acc == metric_eval(refs, cands)


def test_rxn_cli_needs_evaluate(tmp_path):
    """Without --evaluate the CLI trains, so it reads the train split first
    (training end to end: tests/test_torch_finetune.py); --evaluate reads
    only valid and test."""
    from spmm_tpu_torch.cli.rxn_prediction import main

    data = tmp_path / "USPTO-480k"
    data.mkdir()
    for split in ("valid", "test"):
        (data / f"{split}_parsed.txt").write_text("CCO.CC\tCCO\n")
    with pytest.raises(FileNotFoundError, match="train_parsed"):
        main(["--data_dir", str(tmp_path), "--output_dir",
              str(tmp_path / "out"), "--device", "cpu"])


def test_load_rxn_checkpoint_routes_both_states(pair, tmp_path):
    from spmm_tpu_torch.cli.rxn_prediction import load_rxn_checkpoint

    tree, model = pair
    tc, pc = torch_configs()
    pretrain = state_dict_from_jax_tree(jax_tree(6), tc, pc)
    ref_ckpt = tmp_path / "pretrain.ckpt"
    torch.save({"state_dict": pretrain}, ref_ckpt)
    fresh = port_rxn(tree)
    load_rxn_checkpoint(fresh, str(ref_ckpt))
    word = "bert.embeddings.word_embeddings.weight"
    assert torch.equal(fresh.text_encoder2.state_dict()[word],
                       pretrain["text_encoder." + word])
    assert torch.equal(fresh.text_encoder.state_dict()[word],
                       model.text_encoder.state_dict()[word])

    rxn_ckpt = tmp_path / "rxn.ckpt"
    torch.save({"state_dict": fresh.state_dict()}, rxn_ckpt)
    resumed = load_rxn_checkpoint(port_rxn(rxn_tree(4)), str(rxn_ckpt))
    for k, v in resumed.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k


def test_random_init_is_seeded():
    dc, ec = rxn_torch_configs()
    a = Rxn.random_init(3, dc, ec, device="cpu")
    b = Rxn.random_init(3, dc, ec, device="cpu")
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not a.text_encoder2.bert.embeddings.word_embeddings.weight[0].any()
