"""Port parity: spmm_tpu_torch.models.introspect.cross_attention_maps
against spmm_tpu.models.introspect.cross_attention_maps on the same weights
(the tiny SPMM of tests/torch_parity.py: 3 text layers, fusion from layer
1, 2 heads), within 1e-5: one fp32 [B, heads, Lq, Lk] map per fusion
layer, each row a distribution."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spmm_tpu.models.introspect import cross_attention_maps as jax_maps

from spmm_tpu_torch.models.introspect import cross_attention_maps

from torch_parity import jax_configs, jax_tree, port_model, t, to_jax


@pytest.fixture(scope="module")
def case():
    tree = jax_tree(6)
    rng = np.random.default_rng(6)
    b, lq, lk, h = 3, 9, 54, 64
    queries = rng.normal(size=(b, lq, h)).astype(np.float32)
    keys = rng.normal(size=(b, lk, h)).astype(np.float32)
    qmask = np.ones((b, lq), np.int32)
    qmask[1, 6:] = 0
    kmask = np.ones((b, lk), np.int32)
    kmask[2, 40:] = 0
    return tree, port_model(tree), queries, keys, qmask, kmask


@pytest.mark.parametrize("with_key_mask", [False, True])
@pytest.mark.parametrize("owner", ["spmm", "mlm", "bert"])
def test_cross_attention_maps_match_jax(case, with_key_mask, owner):
    tree, model, queries, keys, qmask, kmask = case
    tc, _ = jax_configs()
    want = jax_maps(to_jax(tree)["text_encoder"]["bert"], tc,
                    jnp.asarray(queries), jnp.asarray(qmask),
                    jnp.asarray(keys),
                    jnp.asarray(kmask) if with_key_mask else None)
    target = {"spmm": model, "mlm": model.text_encoder,
              "bert": model.text_encoder.bert}[owner]
    got = cross_attention_maps(target, model.text_cfg, t(queries), t(qmask),
                               t(keys), t(kmask) if with_key_mask else None)
    assert len(got) == len(want) == tc.num_hidden_layers - tc.fusion_layer
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (3, 2, 9, 54)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
        torch.testing.assert_close(g.sum(-1), torch.ones(3, 2, 9),
                                   atol=1e-5, rtol=0)
        if with_key_mask:
            assert float(g[2, :, :, 40:].max()) < 1e-3
