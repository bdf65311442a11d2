"""Port parity: spmm_tpu_torch.inference (beam search, _beam_batch) vs
spmm_tpu.inference with ``attention="xla"`` in fp32, on the same weights.

Bars: ``seqs`` and ``n_finished`` exact; ``logp`` within 1e-5 + 5e-7*|logp|.
The relative term is a few fp32 ulps of the running beam score: after 40
steps |logp| is about 200, where one ulp is 1.5e-5, and each step's log
softmax may differ by an ulp between XLA's and PyTorch's exp and sums.

Cases: decoding that finishes (SEP-biased) under stop_count k and k**2,
max_steps 12 and 40 (40 crosses the JAX cache's 32-step segment), k=5 rows
with fewer than k harvested beams (the harvest merge is full of -inf ties,
so tie order shows in ``seqs``), no beam finishing (the live-beam
fallback), and the stochastic mode fed JAX's own uniforms.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spmm_tpu.inference import decoding as jdec
from spmm_tpu.inference import pv2smiles as jpv

from spmm_tpu_torch.inference import decoding
from spmm_tpu_torch.inference import pv2smiles

from torch_parity import (jax_configs, jax_tree, port_model, t, to_jax,
                          torch_configs)

M = 4
RNG_KEY = 2


@pytest.fixture(scope="module")
def jbeam():
    torch.set_num_threads(1)
    return jax.jit(jdec.beam_search_batched, static_argnames=("cfg", "spec"))


def encoder_inputs():
    enc = np.random.default_rng(7).normal(size=(M, 6, 64)).astype(np.float32)
    return enc, np.ones((M, 6), np.int32)


def jax_uniforms(rngs, k, vocab):
    """The uniforms JAX's _sample_topk draws (decoding.py:386-390,483,
    519-520): fold_in(rng_m, step), shape [V] at step 0, [k, V] after."""
    def draw(step):
        shape = (vocab,) if step == 0 else (k, vocab)
        u = jax.vmap(lambda r: jax.random.uniform(
            jax.random.fold_in(r, step), shape, minval=1e-20, maxval=1.0))(rngs)
        return t(u)
    return draw


def assert_beams_equal(got, want):
    np.testing.assert_array_equal(got["seqs"].numpy(), want["seqs"])
    np.testing.assert_array_equal(got["n_finished"].numpy(),
                                  want["n_finished"])
    np.testing.assert_array_equal(got["lengths"].numpy(), want["lengths"])
    np.testing.assert_allclose(got["logp"].numpy(), want["logp"], atol=1e-5,
                               rtol=5e-7)


@pytest.mark.parametrize("sep_bias,k,stop,steps,stochastic", [
    (0.4, 2, 2, 12, False),     # finishes, stop_count k
    (0.3, 2, 4, 40, False),     # stop_count k**2, crosses a segment
    (0.2, 5, 5, 12, False),     # rows with fewer than k harvested beams
    (0.0, 2, 2, 12, False),     # nothing finishes: live-beam fallback
    (0.3, 2, 4, 12, True),      # stochastic, JAX's uniforms injected
], ids=["finish_k", "k2_segment", "k5_partial", "no_finish", "stochastic"])
def test_beam_search_matches_jax(jbeam, sep_bias, k, stop, steps, stochastic):
    tree = jax_tree(0, sep_bias=sep_bias)
    tcj, _ = jax_configs()
    tct, _ = torch_configs()
    enc, enc_mask = encoder_inputs()
    rngs = jax.random.split(jax.random.PRNGKey(RNG_KEY), M)
    jspec = jdec.BeamSpec(k=k, stop_count=stop, max_steps=steps,
                          stochastic=stochastic, attention="xla")
    want = jax.device_get(jbeam(to_jax(tree)["text_encoder"], tcj,
                                jnp.asarray(enc), jnp.asarray(enc_mask),
                                jspec, rngs))
    spec = decoding.BeamSpec(k=k, stop_count=stop, max_steps=steps,
                             stochastic=stochastic)
    got = decoding.beam_search_batched(
        port_model(tree).text_encoder, tct, t(enc), t(enc_mask), spec,
        uniforms=jax_uniforms(rngs, k, tct.vocab_size) if stochastic
        else None)
    assert_beams_equal(got, want)
    if sep_bias == 0.0:
        assert not want["n_finished"].any()


def test_beam_search_single_query_matches_batched():
    tree = jax_tree(0, sep_bias=0.4)
    tct, _ = torch_configs()
    enc, enc_mask = encoder_inputs()
    model = port_model(tree).text_encoder
    spec = decoding.BeamSpec(k=2, stop_count=2, max_steps=12)
    batched = decoding.beam_search_batched(model, tct, t(enc), t(enc_mask),
                                           spec)
    one = decoding.beam_search(model, tct, t(enc[1]), t(enc_mask[1]), spec)
    assert torch.equal(one["seqs"], batched["seqs"][1])
    assert torch.equal(one["logp"], batched["logp"][1])


def test_top_k_keeps_first_of_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, float("-inf"), 3.0, float("-inf")],
                      [float("-inf")] * 6])
    vals, idx = decoding._top_k(x, 4)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sample_topk_matches_jax(stochastic, dtype):
    """The log softmax and so the beam scores keep the logits' dtype, as in
    JAX (decoding.py:385): bf16 logits give bf16 scores, equal bit for bit."""
    rng = np.random.default_rng(4)
    logits = (3.0 * rng.normal(size=(M, 2, 300))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jlogits = jnp.asarray(logits, dtype)
    want_v, want_i = jdec._sample_topk(jlogits, 2, stochastic, key)
    uniforms = t(jax.random.uniform(key, jlogits.shape, minval=1e-20,
                                    maxval=1.0)) if stochastic else None
    got_v, got_i = decoding._sample_topk(
        t(jlogits.astype(jnp.float32)).to(getattr(torch, dtype)), 2,
        stochastic, uniforms)
    assert got_v.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got_v.float().numpy(),
                                      np.asarray(want_v, np.float32))
    else:
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                                   atol=2e-6, rtol=0)


def test_beam_bookkeeping_bf16_matches_jax(monkeypatch):
    """Both packages' beam loops fed the same bf16 logits (decode_step
    replaced by a table lookup): live scores stay bf16, harvested ones are
    fp32 (decoding.py:487,498).  seqs, lengths and counts agree exactly and
    every score is a bf16 value.  Scores agree within one bf16 ulp: inside
    its compiled loop XLA may keep a fused bf16 intermediate in fp32, which
    rounds a sum differently now and then."""
    k, steps = 2, 10
    rng = np.random.default_rng(9)
    table = (3.0 * rng.normal(size=(steps + 1, M * k, 300))).astype(
        np.float32)
    table[:, :, 3] += 5.0                       # [SEP] often near the top
    jtable = jnp.asarray(table, jnp.bfloat16)
    ttable = t(jtable.astype(jnp.float32)).to(torch.bfloat16)

    def jax_step(params, cfg, token, pos, cache, *args, **kwargs):
        return jtable[pos], cache

    def port_step(model, cfg, token, pos, cache, *args):
        assert cache.dtype == torch.bfloat16
        return ttable[pos]

    monkeypatch.setattr(jdec, "decode_step", jax_step)
    monkeypatch.setattr(decoding, "decode_step", port_step)
    tree = jax_tree(0)
    tcj, _ = jax_configs()
    tct, _ = torch_configs()
    enc, enc_mask = encoder_inputs()
    want = jax.device_get(jdec.beam_search_batched(
        to_jax(tree)["text_encoder"], tcj, jnp.asarray(enc),
        jnp.asarray(enc_mask),
        jdec.BeamSpec(k=k, stop_count=4, max_steps=steps, attention="xla"),
        cache_dtype=jnp.bfloat16))
    got = decoding.beam_search_batched(
        port_model(tree).text_encoder, tct, t(enc), t(enc_mask),
        decoding.BeamSpec(k=k, stop_count=4, max_steps=steps),
        cache_dtype=torch.bfloat16)
    assert want["n_finished"].any()
    logp = got["logp"]
    assert logp.dtype == torch.float32
    assert torch.equal(logp, logp.to(torch.bfloat16).float())
    np.testing.assert_array_equal(got["seqs"].numpy(), want["seqs"])
    np.testing.assert_array_equal(got["n_finished"].numpy(),
                                  want["n_finished"])
    np.testing.assert_array_equal(got["lengths"].numpy(), want["lengths"])
    finite = np.isfinite(want["logp"])
    np.testing.assert_array_equal(np.isfinite(logp.numpy()), finite)
    w = want["logp"][finite]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(w))) - 7)
    assert (np.abs(logp.numpy()[finite] - w) <= ulp).all()


@pytest.fixture(scope="module")
def pv_case():
    tree = jax_tree(3, sep_bias=0.3)
    pv = np.random.default_rng(8).normal(size=(M, 53)).astype(np.float32)
    return tree, pv


def test_beam_batch_fp32_matches_jax(pv_case):
    tree, pv = pv_case
    tcj, pcj = jax_configs()
    spec = jdec.BeamSpec(k=2, stop_count=2, max_steps=16)
    rngs = jax.random.split(jax.random.PRNGKey(0), M)
    want = jax.device_get(jpv._beam_batch(to_jax(tree), jnp.asarray(pv), None,
                                          rngs, spec, tcj, pcj, bf16=False))
    model = port_model(tree)
    got = pv2smiles._beam_batch(
        model, pv2smiles.decoder_for(model, bf16=False), t(pv), None,
        decoding.BeamSpec(k=2, stop_count=2, max_steps=16))
    np.testing.assert_array_equal(got["seqs"].numpy(), want["seqs"])
    np.testing.assert_array_equal(got["n_finished"].numpy(),
                                  want["n_finished"])


def test_beam_batch_bf16_first_step_logits(pv_case):
    """bf16 placement as in JAX's _beam_batch (pv2smiles.py:73-86): fp32
    property encoder, bf16 decoder, bf16 KV cache.  The [CLS] step's
    logits agree within 2e-2."""
    tree, pv = pv_case
    tcj, pcj = jax_configs()
    tct, _ = torch_configs()
    k, T = 2, 24
    jt = to_jax(tree)
    enc = jpv.encode_pv(jt, jnp.asarray(pv), None, pcj).astype(jnp.bfloat16)
    te = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jt["text_encoder"])
    anc = jnp.broadcast_to(jnp.arange(k, dtype=jnp.int32)[None, :, None],
                           (M, k, T))
    seqs = jnp.zeros((M * k, T), jnp.int32).at[:, 0].set(2)
    key_valid = (seqs != 0).astype(jnp.int32)
    cross_mask = jnp.ones(enc.shape[:2], jnp.int32)
    want, _ = jdec.decode_step(
        te, tcj, seqs[:, 0], jnp.int32(0),
        jdec.init_beam_cache_kv(tcj, M, k, T, jnp.bfloat16), key_valid,
        jdec.precompute_cross_kv(te, tcj, enc), cross_mask, anc=anc)

    model = port_model(tree)
    dec = pv2smiles.decoder_for(model, bf16=True)
    with torch.no_grad():
        penc = pv2smiles.encode_pv(model, t(pv), None).to(torch.bfloat16)
        cache = decoding.init_beam_cache_kv(tct, M, k, T, torch.bfloat16,
                                            "cpu")
        got = decoding.decode_step(
            dec, tct, t(seqs[:, 0], torch.int64), 0, cache, t(key_valid),
            decoding.precompute_cross_kv(dec, tct, penc), t(cross_mask),
            t(anc, torch.int64))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=0)
    # the step appended the [CLS] row of every layer, in bf16
    assert cache.dtype == torch.bfloat16
    assert cache[:, :, :, :, :, 0].abs().sum() > 0
    assert not cache[:, :, :, :, :, 1:].any()
