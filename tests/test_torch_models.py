"""Port parity: spmm_tpu_torch.models (BERT, SPMM) and the weight bridge vs
spmm_tpu.models, in fp32 on the same weights.

Bars: bert_forward / mlm_forward logits within 1e-5 in every mode,
encode_pv within 1e-5 with and without the property mask.  The bridge must
load a JAX tree with ``strict=True`` and keep the LM head tied.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spmm_tpu.inference.pv2smiles import encode_pv as jencode_pv
from spmm_tpu.models import bert as jbert

from spmm_tpu_torch.inference.pv2smiles import encode_pv

from torch_parity import jax_configs, jax_tree, port_model, t, to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    torch.set_num_threads(1)
    tree = jax_tree(seed=1)
    return to_jax(tree), port_model(tree), tree


def _ids(rng, b, l):
    ids = rng.integers(4, 300, size=(b, l)).astype(np.int32)
    mask = np.ones((b, l), np.int32)
    mask[1, l - 3:] = 0
    ids[mask == 0] = 0
    return ids, mask


@pytest.mark.parametrize("mode", ["text", "multi_modal", "decoder",
                                  "cross_kv", "fusion_list"])
def test_mlm_forward_matches_jax(pair, mode):
    jt, model, _ = pair
    tc, _ = jax_configs()
    rng = np.random.default_rng(2)
    ids, mask = _ids(rng, 3, 10)
    enc = rng.normal(size=(3, 7, tc.hidden_size)).astype(np.float32)
    enc_mask = np.ones((3, 7), np.int32)
    enc_mask[0, 5:] = 0
    jkw = dict(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    tkw = dict(input_ids=t(ids), attention_mask=t(mask))
    if mode == "text":
        jkw["mode"] = tkw["mode"] = "text"
    elif mode in ("multi_modal", "decoder"):
        jkw.update(encoder_hidden_states=jnp.asarray(enc),
                   encoder_attention_mask=jnp.asarray(enc_mask))
        tkw.update(encoder_hidden_states=t(enc),
                   encoder_attention_mask=t(enc_mask))
        jkw["is_decoder"] = tkw["is_decoder"] = mode == "decoder"
    elif mode == "cross_kv":
        from spmm_tpu.inference.decoding import precompute_cross_kv as jpre
        from spmm_tpu_torch.inference.decoding import precompute_cross_kv

        jkw.update(cross_kv=jpre(jt["text_encoder"], tc, jnp.asarray(enc)),
                   encoder_attention_mask=jnp.asarray(enc_mask))
        with torch.no_grad():
            tkw.update(cross_kv=precompute_cross_kv(model.text_encoder, tc,
                                                    t(enc)),
                       encoder_attention_mask=t(enc_mask))
    else:   # two encoder sources, round-robin over the fusion layers
        enc2 = rng.normal(size=(3, 4, tc.hidden_size)).astype(np.float32)
        jkw.update(encoder_hidden_states=[jnp.asarray(enc), jnp.asarray(enc2)])
        tkw.update(encoder_hidden_states=[t(enc), t(enc2)])
    want = jbert.mlm_forward(jt["text_encoder"], tc, **jkw)
    with torch.no_grad():
        got = model.text_encoder(**tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_bert_forward_encoder_embeds_matches_jax(pair):
    jt, model, _ = pair
    tc, _ = jax_configs()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, tc.hidden_size)).astype(np.float32)
    enc = rng.normal(size=(2, 5, tc.hidden_size)).astype(np.float32)
    want = jbert.bert_forward(jt["text_encoder"]["bert"], tc,
                              encoder_embeds=jnp.asarray(x),
                              encoder_hidden_states=jnp.asarray(enc),
                              mode="fusion")
    with torch.no_grad():
        got = model.text_encoder.bert(encoder_embeds=t(x),
                                      encoder_hidden_states=t(enc),
                                      mode="fusion")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_encode_pv_matches_jax(pair, masked):
    jt, model, _ = pair
    _, pc = jax_configs()
    rng = np.random.default_rng(5)
    pv = rng.normal(size=(4, 53)).astype(np.float32)
    mask = (rng.random((4, 53)) < 0.4).astype(np.float32) if masked else None
    want = jencode_pv(jt, jnp.asarray(pv),
                      None if mask is None else jnp.asarray(mask), pc)
    with torch.no_grad():
        got = encode_pv(model, t(pv), None if mask is None else t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("offset", [60, 96])
def test_positions_past_the_table_clamp_as_in_jax(offset):
    """max_position_embeddings=64 with positions up to offset + 7 (103):
    JAX's gather reads the last row past the table, and so does the port."""
    import dataclasses

    from spmm_tpu.configs import BertArchConfig as JaxCfg
    from spmm_tpu_torch.configs import BertArchConfig
    from spmm_tpu_torch.models.bert import BertEmbeddings

    tc, _ = jax_configs()
    jcfg = dataclasses.replace(tc, max_position_embeddings=64)
    assert isinstance(jcfg, JaxCfg)
    p = jax.tree.map(np.asarray, jbert.init_bert_params(
        jax.random.PRNGKey(3), jcfg)["embeddings"])
    emb = BertEmbeddings(BertArchConfig(**dataclasses.asdict(jcfg)))
    emb.load_state_dict({
        "word_embeddings.weight": t(p["word"]),
        "position_embeddings.weight": t(p["position"]),
        "token_type_embeddings.weight": t(p["token_type"]),
        "LayerNorm.weight": t(p["ln"]["scale"]),
        "LayerNorm.bias": t(p["ln"]["bias"])}, strict=True)
    ids = np.random.default_rng(6).integers(4, 300, size=(2, 8)).astype(
        np.int32)
    want = jbert.embeddings_forward(jax.tree.map(jnp.asarray, p), jcfg,
                                    jnp.asarray(ids), position_offset=offset)
    with torch.no_grad():
        got = emb(t(ids), position_offset=offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_bridge_ties_and_aliases(pair):
    _, model, tree = pair
    head = model.text_encoder.cls.predictions
    word = model.text_encoder.bert.embeddings.word_embeddings.weight
    assert head.decoder.weight is word
    assert head.bias is head.decoder.bias
    np.testing.assert_array_equal(
        word.detach().numpy(),
        tree["text_encoder"]["bert"]["embeddings"]["word"])
    np.testing.assert_array_equal(
        model.property_mtr_head[3].weight.detach().numpy(),
        tree["property_mtr_head"]["l2"]["w"].T)
    # the tie survives a dtype cast (the bf16 decoder copy relies on it)
    from spmm_tpu_torch.inference.pv2smiles import decoder_for

    dec = decoder_for(model, bf16=True)
    assert (dec.cls.predictions.decoder.weight
            is dec.bert.embeddings.word_embeddings.weight)
    assert dec.cls.predictions.decoder.weight.dtype == torch.bfloat16


def test_bridge_matches_jax_exporter(pair):
    """The port's own copy of the key map equals export_spmm_state_dict."""
    from spmm_tpu.checkpoint.export import export_spmm_state_dict
    from spmm_tpu_torch.checkpoint.convert import state_dict_from_jax_tree

    _, _, tree = pair
    tc, pc = jax_configs()
    want = export_spmm_state_dict(tree, tc, pc)
    got = state_dict_from_jax_tree(tree, tc, pc)
    assert set(got) == set(want)
    for key, val in want.items():
        np.testing.assert_array_equal(got[key].numpy(), val, err_msg=key)


def test_load_reference_checkpoint_renames_unk(pair, tmp_path):
    from spmm_tpu.checkpoint.export import export_spmm_state_dict
    from spmm_tpu_torch.checkpoint.convert import (
        load_reference_checkpoint, spmm_subset)
    from spmm_tpu_torch.models.spmm import SPMM
    from torch_parity import torch_configs

    _, model, tree = pair
    state = {k.replace("property_mask", "property_unk"): t(v)
             for k, v in export_spmm_state_dict(tree).items()}
    state["text_queue"] = torch.zeros(4, 8)
    state["property_proj_m.weight"] = torch.zeros(4, 4)
    path = tmp_path / "ref.ckpt"
    torch.save({"state_dict": state}, path)
    loaded = load_reference_checkpoint(str(path))
    assert "property_mask" in loaded and "property_unk" not in loaded
    other = SPMM(*torch_configs())
    other.load_state_dict(spmm_subset(loaded), strict=True)
    want = model.state_dict()
    for name, val in other.state_dict().items():
        assert torch.equal(val, want[name]), name


@pytest.mark.parametrize("name", ["vocab.json", "property_stats.json"])
def test_assets_are_copies(name):
    assert filecmp.cmp(os.path.join(REPO, "spmm_tpu", "assets", name),
                       os.path.join(REPO, "spmm_tpu_torch", "assets", name),
                       shallow=False)


def test_tokenizer_matches_jax():
    from spmm_tpu.tokenizer import SmilesTokenizer as JTok
    from spmm_tpu_torch.tokenizer import SmilesTokenizer

    texts = ["[CLS]CC(=O)O", "[CLS]c1ccccc1N", "[CLS]C1CC1Br", "CCO"]
    jt, pt = JTok(), SmilesTokenizer()
    jt._native = None          # compare against the pure-Python path
    for s in texts:
        assert pt.encode(s) == jt.encode(s)
        assert pt.decode(pt.encode(s)) == jt.decode(jt.encode(s))
    for a, b in zip(pt.encode_batch(texts, max_len=24, buckets=(16, 24)),
                    jt.encode_batch(texts, max_len=24, buckets=(16, 24))):
        np.testing.assert_array_equal(a, b)


def test_property_stats_match_jax():
    from spmm_tpu.chem.normalize import PropertyStats as JStats
    from spmm_tpu_torch.chem.normalize import PropertyStats

    a, b = PropertyStats.load(), JStats.load()
    assert a.names == b.names
    pv = np.random.default_rng(0).normal(size=53).astype(np.float32)
    np.testing.assert_array_equal(a.normalize(pv), b.normalize(pv))
    np.testing.assert_array_equal(a.denormalize(pv), b.denormalize(pv))
