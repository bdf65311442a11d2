"""Port parity: the native wordpiece encoder (spmm_tpu_torch.tokenizer's
``NativeWordpiece``, built from spmm_tpu_torch/csrc/wordpiece.cpp by
``ops._host_build``) against the port's Python path and JAX's
``NativeWordpiece`` (its library compiled here from native/wordpiece.cpp
into the test's temporary directory), on JAX's seven samples of
tests/test_native_tokenizer.py and their padded batch; ``encode_batch``
through the native encoder against the Python path and JAX's.  Equal,
id for id.  The samples need a C++ compiler, which this machine has; a
machine without one skips them.

The RDKit-gated featurizer (``calculate_properties_batch``) and
``PretrainDataset.build_property_cache``: neither machine has RDKit, so
they are held to raise as JAX's do without it.
"""

import subprocess

import numpy as np
import pytest

from spmm_tpu import tokenizer as jtok
from spmm_tpu.chem import featurizer as jfeat
from spmm_tpu.data import datasets as jdata

from spmm_tpu_torch import tokenizer as ttok
from spmm_tpu_torch.chem import featurizer as tfeat
from spmm_tpu_torch.data import datasets as tdata
from spmm_tpu_torch.ops import _host_build

REPO_NATIVE = __file__.rsplit("/tests/", 1)[0] + "/native/wordpiece.cpp"

SAMPLES = [
    "[CLS]CC(=O)Oc1ccccc1C(=O)O",
    "[CLS]N#Cc1cc(C#N)c(NCCc2cnc(N)s2)nc1Cl",
    "[CLS]C",
    "[CLS]" + "C" * 300,        # > max_input_chars_per_word -> [UNK]
    "[CLS][Na+].[Cl-]",
    "[CLS]CCO.CC(=O)O>>CC(=O)OCC",
    "",
]


@pytest.fixture(scope="module")
def compiler():
    try:
        return _host_build.cxx_path()
    except RuntimeError:
        pytest.skip("no C++ compiler on this machine")


@pytest.fixture(scope="module")
def native(compiler):
    assert ttok.native_available(), ttok.native_build_error()
    return ttok.NativeWordpiece()


@pytest.fixture(scope="module")
def jax_native(compiler, tmp_path_factory):
    """JAX's binding over JAX's source, built apart from native/'s own
    library (which tests/test_native_tokenizer.py may be building)."""
    lib = tmp_path_factory.mktemp("jaxwp") / "libspmm_host.so"
    subprocess.run([compiler, *_host_build.CXX_FLAGS, "-o", str(lib),
                    REPO_NATIVE], check=True, capture_output=True)
    return jtok.NativeWordpiece(lib_path=str(lib))


@pytest.mark.parametrize("text", SAMPLES)
def test_native_encode_matches_python_and_jax(native, jax_native, text):
    py = ttok.SmilesTokenizer(native=False)
    for kw in ({}, {"max_len": 16, "truncation": True}):
        want = py.encode(text, **kw)
        assert native.encode(text, **kw) == want
        assert jax_native.encode(text, **kw) == want


def test_native_batch_matches_python_and_jax(native, jax_native):
    py = ttok.SmilesTokenizer(native=False)
    ids, lens = native.encode_batch_padded(SAMPLES, 32)
    want_ids, want_lens = jax_native.encode_batch_padded(SAMPLES, 32)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(lens, want_lens)
    for i, s in enumerate(SAMPLES):
        assert list(ids[i][:lens[i]]) == py.encode(s, max_len=32,
                                                   truncation=True)
        assert (ids[i][lens[i]:] == 0).all()


@pytest.mark.parametrize("max_len,buckets,drop", [
    (32, None, True), (100, (16, 24, 32, 48, 64, 80, 100), True),
    (24, (24,), False), (16, (8, 12), True)])
def test_encode_batch_takes_the_native_path(native, max_len, buckets, drop):
    """The default tokenizer truncates through the native encoder: the
    Python path's arrays, and JAX's ``encode_batch``'s."""
    tok = ttok.SmilesTokenizer()
    assert tok.native_encoder() is not None
    assert ttok.SmilesTokenizer(native=False).native_encoder() is None
    texts = SAMPLES[:-1]
    got = tok.encode_batch(texts, max_len=max_len, buckets=buckets,
                           drop_leading_cls=drop)
    want = ttok.SmilesTokenizer(native=False).encode_batch(
        texts, max_len=max_len, buckets=buckets, drop_leading_cls=drop)
    jax_want = jtok.SmilesTokenizer().encode_batch(
        texts, max_len=max_len, buckets=buckets, drop_leading_cls=drop)
    for a, b, c in zip(got, want, jax_want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_without_truncation_the_python_path_runs(native):
    """As JAX's: the native encoder always truncates, so an untruncated
    batch (the reaction path's) goes through Python."""
    texts = SAMPLES[:-1]
    got = ttok.SmilesTokenizer().encode_batch(texts, max_len=8,
                                              truncation=False)
    want = jtok.SmilesTokenizer().encode_batch(texts, max_len=8,
                                               truncation=False)
    assert got[0].shape[1] > 8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_featurizer_raises_without_rdkit_as_jax():
    smiles = ["CCO", "c1ccccc1"] * 40
    assert tfeat.HAS_RDKIT == jfeat.HAS_RDKIT
    if tfeat.HAS_RDKIT:
        got = tfeat.calculate_properties_batch(smiles, n_workers=1)
        want = jfeat.calculate_properties_batch(smiles, n_workers=1)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        return
    for fn in (tfeat.calculate_properties_batch,
               jfeat.calculate_properties_batch):
        with pytest.raises(RuntimeError, match="RDKit is required"):
            fn(smiles, n_workers=2)


def test_build_property_cache_raises_without_rdkit_as_jax(tmp_path):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("CCO\nc1ccccc1\n\nCC(=O)O\n")
    port = tdata.PretrainDataset(str(corpus))
    ref = jdata.PretrainDataset(str(corpus), shuffle=False)
    assert port.smiles == ref.smiles
    if tfeat.HAS_RDKIT:
        port.build_property_cache(str(tmp_path / "port.npz"), n_workers=1)
        ref.build_property_cache(str(tmp_path / "jax.npz"), n_workers=1)
        np.testing.assert_array_equal(np.load(tmp_path / "port.npz")["pv"],
                                      np.load(tmp_path / "jax.npz")["pv"])
        return
    for ds in (port, ref):
        with pytest.raises(RuntimeError, match="RDKit is required"):
            ds.build_property_cache(str(tmp_path / "pv.npz"), n_workers=1)
    assert not (tmp_path / "pv.npz").exists()
