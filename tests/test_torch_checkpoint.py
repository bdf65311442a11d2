"""Strict loads of reference checkpoints in the port.

A reference pretrain ``.ckpt`` carries more than an inference ``SPMM``
holds: the temperature ``temp``, the feature queues and ``queue_ptr``, the
momentum twins (``*_m``), the pretraining heads, the legacy
``property_unk`` name and the ``*.embeddings.position_ids`` buffers that the
reference's xbert saves.  The state here is written by hand in that shape
(no reference code needed), and must load with ``strict=True`` through each
inference CLI's own load code, equal to JAX's ``load_spmm_params`` on the
same file; a reaction state the reference saved (``position_ids`` included)
must load strictly through ``load_rxn_checkpoint``; and a state that lacks
a real weight must still raise, naming only that weight.
"""

import importlib

import numpy as np
import pytest
import torch

import jax

from spmm_tpu.checkpoint.export import export_spmm_state_dict
from spmm_tpu.checkpoint.io import load_spmm_params

from spmm_tpu_torch.checkpoint.convert import (
    load_spmm_checkpoint, state_dict_from_jax_tree)
from spmm_tpu_torch.models.spmm import SPMM

from torch_parity import TINY, jax_configs, jax_tree, torch_configs

CLIS = {
    "serve": [],
    "smiles2pv": ["--input_file", "unused.txt"],
    "pv2smiles_single": [],
    "pv2smiles_batched": ["--input_file", "unused.txt",
                          "--property_cache", "unused.npz"],
}


def _position_ids() -> torch.Tensor:
    return torch.arange(TINY["max_position_embeddings"])[None]


def reference_style_state(tree: dict) -> dict:
    """The reference SPMM pretrain state_dict of ``tree``'s weights."""
    tc, pc = jax_configs()
    weights = {k.replace("property_mask", "property_unk"): torch.tensor(v)
               for k, v in export_spmm_state_dict(tree, tc, pc).items()}
    rng = np.random.default_rng(7)
    state = dict(weights)
    for k, v in weights.items():            # momentum twins, other values
        top, rest = k.split(".", 1) if "." in k else (k, None)
        twin = f"{top}_m" + (f".{rest}" if rest else "")
        state[twin] = torch.tensor(rng.normal(size=v.shape), dtype=v.dtype)
    for prefix in ("text_encoder.bert", "text_encoder_m.bert",
                   "property_encoder", "property_encoder_m"):
        state[f"{prefix}.embeddings.position_ids"] = _position_ids()
    state["prop_queue"] = torch.randn(16, 64)
    state["text_queue"] = torch.randn(16, 64)
    state["queue_ptr"] = torch.zeros(1, dtype=torch.long)
    state["temp"] = torch.tensor(0.07)
    return state


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    tree = jax_tree(seed=3)
    path = tmp_path_factory.mktemp("ckpt") / "checkpoint_SPMM.ckpt"
    torch.save({"state_dict": reference_style_state(tree)}, path)
    return str(path)


def jax_loaded_state(path: str) -> dict:
    """What JAX's loader makes of the file, in the port's names."""
    tc, pc = jax_configs()
    params = load_spmm_params(path, text_cfg=tc, prop_cfg=pc,
                              with_pretrain_heads=False)
    return state_dict_from_jax_tree(jax.tree.map(np.asarray, params),
                                    *torch_configs())


def assert_state_equal(model: torch.nn.Module, want: dict) -> None:
    got = model.state_dict()
    assert set(got) == set(want)
    for name, val in want.items():
        assert torch.equal(got[name], val), name


class _Loaded(Exception):
    """Raised where a CLI moves its freshly loaded model to the device."""


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_cli_loads_reference_checkpoint_strictly(cli, ckpt, monkeypatch):
    """Each inference CLI's main, up to the point where its model is
    loaded, on a tiny SPMM: the load is strict and equals JAX's."""
    from spmm_tpu_torch.models import spmm as spmm_module

    loaded = []

    class TinySPMM(SPMM):
        def __init__(self):
            super().__init__(*torch_configs())

        def to(self, *args, **kwargs):
            loaded.append(self)
            raise _Loaded

    monkeypatch.setattr(spmm_module, "SPMM", TinySPMM)
    module = importlib.import_module(f"spmm_tpu_torch.cli.{cli}")
    with pytest.raises(_Loaded):
        module.main(["--checkpoint", ckpt, "--device", "cpu", *CLIS[cli]])
    assert len(loaded) == 1
    assert_state_equal(loaded[0], jax_loaded_state(ckpt))


def test_model_key_checkpoint_loads(ckpt, tmp_path):
    """A ``{"model": ...}`` file loads as its ``{"state_dict": ...}`` twin."""
    path = tmp_path / "model_key.ckpt"
    torch.save({"model": torch.load(ckpt, weights_only=False)["state_dict"]},
               path)
    model = load_spmm_checkpoint(SPMM(*torch_configs()), str(path))
    assert_state_equal(model, jax_loaded_state(ckpt))


def _rxn():
    from test_torch_rxn import port_rxn, rxn_tree

    return port_rxn(rxn_tree(seed=4))


def test_rxn_state_with_position_ids_loads_strictly(tmp_path):
    """A reaction state as the reference's xbert saves it (position_ids
    buffers in both stacks) loads strictly, decoder and encoder."""
    from spmm_tpu_torch.cli.rxn_prediction import load_rxn_checkpoint
    from spmm_tpu_torch.models.rxn import Rxn
    from test_torch_rxn import rxn_torch_configs

    want = _rxn().state_dict()
    state = dict(want)
    for prefix in ("text_encoder", "text_encoder2"):
        state[f"{prefix}.bert.embeddings.position_ids"] = _position_ids()
    path = tmp_path / "rxn.ckpt"
    torch.save({"state_dict": state}, path)
    model = load_rxn_checkpoint(Rxn(*rxn_torch_configs()), str(path))
    assert_state_equal(model, want)


@pytest.mark.parametrize("kind", ["spmm", "rxn"])
def test_missing_weight_still_raises(kind, ckpt, tmp_path):
    """Take one real weight out of each kind of file: the strict load
    raises, and what it names is that weight alone."""
    from spmm_tpu_torch.cli.rxn_prediction import load_rxn_checkpoint
    from spmm_tpu_torch.models.rxn import Rxn
    from test_torch_rxn import rxn_torch_configs

    if kind == "spmm":
        state = torch.load(ckpt, weights_only=False)["state_dict"]
        gone = "text_encoder.bert.encoder.layer.0.output.dense.weight"
    else:
        state = dict(_rxn().state_dict())
        state["text_encoder2.bert.embeddings.position_ids"] = _position_ids()
        gone = "text_encoder2.bert.encoder.layer.1.output.dense.weight"
    del state[gone]
    path = tmp_path / f"{kind}.ckpt"
    torch.save({"state_dict": state}, path)
    with pytest.raises(RuntimeError, match="Missing key") as err:
        if kind == "spmm":
            load_spmm_checkpoint(SPMM(*torch_configs()), str(path))
        else:
            load_rxn_checkpoint(Rxn(*rxn_torch_configs()), str(path))
    assert gone in str(err.value)
    assert "Unexpected" not in str(err.value)
