"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Weights are made on the JAX side (``init_spmm_params``), carried to numpy,
and loaded into the port through its own weight bridge
(``state_dict_from_jax_tree`` + ``load_state_dict(strict=True)``), so both
packages run the same numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from spmm_tpu.configs import BertArchConfig as JaxCfg
from spmm_tpu.models.spmm import init_spmm_params

from spmm_tpu_torch.checkpoint.convert import state_dict_from_jax_tree
from spmm_tpu_torch.configs import BertArchConfig as TorchCfg
from spmm_tpu_torch.models.spmm import SPMM

# the JAX suite's decode config (tests/test_decode_attention.py:167-171),
# with room for the 100-step serving decode (positions up to 103)
TINY = dict(
    vocab_size=300, hidden_size=64, num_hidden_layers=3,
    num_attention_heads=2, intermediate_size=128,
    max_position_embeddings=128, type_vocab_size=2, fusion_layer=1,
    encoder_width=64,
)
PROP = dict(TINY, vocab_size=1, num_hidden_layers=2, fusion_layer=2)

CPU = torch.device("cpu")


def jax_configs() -> tuple[JaxCfg, JaxCfg]:
    return (JaxCfg(**TINY, add_cross_attention=True),
            JaxCfg(**PROP, add_cross_attention=False))


def torch_configs() -> tuple[TorchCfg, TorchCfg]:
    return tuple(TorchCfg(**dataclasses.asdict(c)) for c in jax_configs())


def jax_tree(seed: int = 0, sep_bias: float = 0.0) -> dict:
    """A tiny SPMM tree with numpy leaves.  property_cls / property_mask
    (zero at init) are randomized so the parity tests see them;
    ``sep_bias`` raises the [SEP] logit so beams finish."""
    tc, pc = jax_configs()
    tree = init_spmm_params(jax.random.PRNGKey(seed), tc, pc,
                            with_pretrain_heads=True)
    tree = jax.tree.map(np.asarray, tree)
    rng = np.random.default_rng(seed + 100)
    h = tc.hidden_size
    tree["property_cls"] = rng.normal(size=(1, 1, h)).astype(np.float32)
    tree["property_mask"] = rng.normal(size=(1, 1, h)).astype(np.float32)
    b = tree["text_encoder"]["mlm_head"]["decoder"]["b"].copy()
    b[3] += sep_bias
    tree["text_encoder"]["mlm_head"]["decoder"]["b"] = b
    return tree


def to_jax(tree: dict) -> dict:
    return jax.tree.map(jnp.asarray, tree)


def port_model(tree: dict) -> SPMM:
    tc, pc = torch_configs()
    model = SPMM(tc, pc, with_pretrain_heads=True)
    model.load_state_dict(state_dict_from_jax_tree(tree, tc, pc), strict=True)
    return model.eval()


def t(x, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)
