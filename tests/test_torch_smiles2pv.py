"""Port parity: the SMILES->PV slice of spmm_tpu_torch vs spmm_tpu, in fp32
on the same weights.

- ``inference.smiles2pv.predict_pv`` against JAX's ``predict_pv``: the
  kernel route (its plain version on the CPU) against attention_impl=
  "pallas" in interpret mode, the plain route against "xla", for 4, 20 and
  53 properties (JAX's buffer grows in segments 16 -> 32 -> 54: 20 crosses
  the first boundary, 53 both), with padded SMILES rows.  Bar 2e-5
  (tests/test_pallas_attention.py:80).
  bf16 against JAX's bf16 within 2e-2: both round to bf16's 8 significant
  bits, at different places (XLA's fusions against PyTorch's per-op
  rounding), and each prediction feeds the next step, so the two drift by
  a few bf16 ulps of |pred| < 1 (5e-3 measured over 53 steps).
- step i re-encodes exactly its i + 1 slots;
- every attention of the path goes through ``fused_mha``: 1 + 6 per step
  here (1 text layer; 2 property layers; 2 fusion layers, self and cross);
- ``Smiles2PvService`` against offline ``predict_pv``;
- ``cli.smiles2pv.pv_generate`` and the numpy ``metric_eval`` against the
  JAX ones (sklearn's r2_score there);
- the copies of ``PretrainDataset``'s cache path, ``canonicalize`` and
  ``is_valid_syntax``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spmm_tpu.inference.smiles2pv import predict_pv as jpredict_pv

from spmm_tpu_torch.chem.normalize import PropertyStats
from spmm_tpu_torch.inference.smiles2pv import cast_params_bf16, predict_pv
from spmm_tpu_torch.tokenizer import SmilesTokenizer

from torch_parity import CPU, jax_configs, jax_tree, port_model, to_jax

SMILES = ["CCO", "c1ccccc1N", "CC(=O)Oc1ccccc1C(=O)O", "C1CC1Br",
          "CC(C)Cc1ccc(C(C)C(=O)O)cc1"]


@pytest.fixture(scope="module")
def pair():
    torch.set_num_threads(1)
    tree = jax_tree(4)
    return to_jax(tree), port_model(tree)


@pytest.fixture(scope="module")
def batch():
    """Tokenized SMILES of different lengths, padded to 24."""
    ids, mask = SmilesTokenizer().encode_batch(
        ["[CLS]" + s for s in SMILES], max_len=24, buckets=(24,))
    assert (mask == 0).any() and ids.shape == (5, 24)
    return ids, mask


def _jax_predict(jt, ids, mask, n, impl, bf16=False):
    tc, pc = jax_configs()
    return np.asarray(jpredict_pv(jt, jnp.asarray(ids), jnp.asarray(mask),
                                  text_cfg=tc, prop_cfg=pc, n_properties=n,
                                  attention_impl=impl, bf16=bf16))


@pytest.mark.parametrize("n", [4, 20, 53])
@pytest.mark.parametrize("impl,jax_impl", [("kernel", "pallas"),
                                           ("plain", "xla")])
def test_predict_pv_matches_jax(pair, batch, n, impl, jax_impl):
    jt, model = pair
    ids, mask = batch
    want = _jax_predict(jt, ids, mask, n, jax_impl)
    got = predict_pv(model, ids, mask, n_properties=n, attention_impl=impl,
                     device=CPU)
    assert got.dtype == torch.float32 and got.shape == (5, n)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_predict_pv_bf16_matches_jax(pair, batch):
    jt, model = pair
    ids, mask = batch
    want = _jax_predict(jt, ids, mask, 53, "xla", bf16=True)
    bf16_model = cast_params_bf16(model)
    assert next(bf16_model.parameters()).dtype == torch.bfloat16
    got = predict_pv(bf16_model, ids, mask, device=CPU)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("n", [4, 20, 53])
def test_each_step_runs_its_own_prefix(pair, batch, monkeypatch, n):
    _, model = pair
    ids, mask = batch
    widths = []
    real = model.encode_properties

    def recording(prop_inputs, attention_mask=None, **kwargs):
        widths.append((prop_inputs.shape[1], attention_mask.shape[1]))
        return real(prop_inputs, attention_mask, **kwargs)

    monkeypatch.setattr(model, "encode_properties", recording)
    predict_pv(model, ids, mask, n_properties=n, device=CPU)
    assert widths == [(i + 1, i + 1) for i in range(n)]


@pytest.mark.parametrize("impl,calls", [("kernel", 1 + 6 * 20),
                                        ("plain", 0)])
def test_every_attention_goes_through_the_kernel(pair, batch, monkeypatch,
                                                 impl, calls):
    from spmm_tpu_torch.ops import attention

    seen = []
    real = attention.fused_mha

    def counting(q, k, v, mask=None):
        seen.append((q.shape[2], k.shape[2]))
        return real(q, k, v, mask)

    monkeypatch.setattr(attention, "fused_mha", counting)
    _, model = pair
    ids, mask = batch
    predict_pv(model, ids, mask, n_properties=20, attention_impl=impl,
               device=CPU)
    assert len(seen) == calls
    if calls:
        assert seen[0] == (24, 24)                       # the text section
        assert set(seen[1:]) == ({(n, n) for n in range(1, 21)}
                                 | {(n, 24) for n in range(1, 21)})


def test_service_matches_offline(pair):
    from spmm_tpu_torch.serving import Smiles2PvService

    _, model = pair
    tok, stats = SmilesTokenizer(), PropertyStats.load()
    ids, mask = tok.encode_batch(["[CLS]" + s for s in SMILES], max_len=24,
                                 buckets=(24,))
    ids = np.pad(ids, [(0, 3), (0, 0)])
    mask = np.pad(mask, [(0, 3), (0, 0)])
    want = predict_pv(model, ids, mask, device=CPU).numpy()[:5]
    with Smiles2PvService(model, tok, batch_size=8, max_wait_ms=50.0,
                          max_len=24, device=CPU) as svc:
        got = np.stack(svc.map(SMILES))
        ragged = np.stack(svc.map(SMILES[:2]))
    assert svc.stats["batches"] >= 2 and svc.stats["batch_seconds"] > 0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ragged, want[:2], atol=1e-5, rtol=0)
    with Smiles2PvService(model, tok, stats=stats, batch_size=8,
                          max_wait_ms=50.0, max_len=24, device=CPU) as svc:
        denorm = np.stack(svc.map(SMILES))
    np.testing.assert_allclose(denorm, stats.denormalize(want), rtol=1e-5,
                               atol=1e-4)


def test_pv_generate_matches_jax(pair, monkeypatch):
    import spmm_tpu.cli.smiles2pv as jcli
    from spmm_tpu.tokenizer import SmilesTokenizer as JTok

    from spmm_tpu_torch.cli.smiles2pv import pv_generate

    jt, model = pair
    tc, pc = jax_configs()
    # the JAX CLI runs the full-size configs; bind the tiny ones
    monkeypatch.setattr(jcli, "predict_pv", functools.partial(
        jpredict_pv, text_cfg=tc, prop_cfg=pc))
    stats = PropertyStats.load()
    smiles = SMILES + ["CCN", "[CLS]CCCl"]
    want = jcli.pv_generate(jt, JTok(), smiles, stats, batch_size=3)
    got = pv_generate(model, SmilesTokenizer(), smiles, stats, batch_size=3,
                      device=CPU)
    assert got.shape == want.shape == (7, 53)
    np.testing.assert_allclose(stats.normalize(got), stats.normalize(want),
                               atol=2e-5, rtol=0)


def test_metric_eval_matches_jax(capsys):
    from spmm_tpu.chem.normalize import PropertyStats as JStats
    from spmm_tpu.cli.smiles2pv import metric_eval as jmetric

    from spmm_tpu_torch.cli.smiles2pv import metric_eval

    rng = np.random.default_rng(0)
    ref = rng.normal(size=(12, 53)).astype(np.float32)
    cand = (ref + 0.3 * rng.normal(size=(12, 53))).astype(np.float32)
    want = jmetric(ref, cand, JStats.load())
    got = metric_eval(ref, cand, PropertyStats.load())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    out = capsys.readouterr().out
    assert out.count("normalized RMSE") == 2 and out.count("r^2") == 2


def test_r2_score_matches_sklearn():
    from sklearn.metrics import r2_score as sk_r2

    from spmm_tpu_torch.cli.smiles2pv import r2_score

    rng = np.random.default_rng(2)
    y = rng.normal(size=20)
    const = np.full(20, 0.5)
    for y_true, y_pred in ((y, y + 0.2 * rng.normal(size=20)), (y, y),
                           (const, y), (const, const)):
        assert r2_score(y_true, y_pred) == pytest.approx(
            sk_r2(y_true, y_pred), rel=1e-12, abs=1e-12)


def test_dataset_and_chem_copies(tmp_path):
    from spmm_tpu.chem.featurizer import canonicalize as jcanon
    from spmm_tpu.chem.smiles import is_valid_syntax as jvalid
    from spmm_tpu.data.datasets import PretrainDataset as JDataset

    from spmm_tpu_torch.chem.featurizer import canonicalize
    from spmm_tpu_torch.chem.smiles import is_valid_syntax
    from spmm_tpu_torch.data.datasets import PretrainDataset

    cases = SMILES + ["C1CC", "C(C", "[Na+].[Cl-]", "c1cc%10ccc%10c1", "",
                      " CCO", "CC==O", "C)"]
    assert [is_valid_syntax(s) for s in cases] == [jvalid(s) for s in cases]
    assert [canonicalize(s) for s in cases] == [jcanon(s) for s in cases]

    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(SMILES[:3] + ["", "C1CC"]) + "\n")
    cache = tmp_path / "pv.npz"
    pv = np.random.default_rng(1).normal(size=(4, 53)).astype(np.float32)
    np.savez(cache, pv=pv)
    got = PretrainDataset(str(corpus), property_cache=str(cache))
    want = JDataset(str(corpus), property_cache=str(cache))
    assert len(got) == len(want) == 4
    for i in range(4):
        (gp, gt), (wp, wt) = got[i], want[i]
        assert gt == wt
        np.testing.assert_array_equal(gp, wp)
    with pytest.raises(RuntimeError, match="property_cache"):
        PretrainDataset(str(corpus))[0]
    np.savez(cache, pv=pv[:3])
    with pytest.raises(ValueError, match="3 rows for 4"):
        PretrainDataset(str(corpus), property_cache=str(cache))
