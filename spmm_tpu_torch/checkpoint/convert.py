"""The weight bridge: reference-named state dicts for the port's modules.

Two sources, one naming (the reference SPMM / SPMM_rxn state dicts, which
the port's ``nn.Module`` trees reproduce, so both load with ``strict=True``):

  - ``state_dict_from_jax_tree``: a ``spmm_tpu`` params tree (numpy leaves)
    -> tensors.  The port's own copy of the mapping of
    spmm_tpu/checkpoint/export.py:47-141 — Linear weights transpose
    [in, out] -> [out, in]; the tied LM-head decoder weight is the word
    table; the decoder bias appears under both of the reference's aliased
    names (xbert.py:686-691); ``property_mtr_head`` flattens to the
    Sequential indices ``.0/.2/.3``; the pretrain heads only if present.
    ``rxn_state_dict_from_jax_tree`` does the same for a reaction tree,
    ``downstream_state_dict_from_jax_tree`` for a MoleculeNet one, and
    ``pretrain_state_dict_from_jax`` for a JAX pretrain state (the twins
    named as ``export_spmm_state_dict`` names ``params["momentum"]``, plus
    ``temp``, the queues and ``queue_ptr``), and
    ``moe_state_dict_from_jax_tree`` for a MoE block (``parallel.ep``).
  - ``load_reference_checkpoint``: a reference ``{"state_dict": ...}`` (or
    ``{"model": ...}``) ``.ckpt`` with the ``_unk`` -> ``_mask`` rename
    (reference d_regression.py:157-161); ``spmm_subset`` keeps what an
    inference ``SPMM`` holds, and ``load_spmm_checkpoint`` loads that
    strictly, as the four inference CLIs do; ``pretrain_subset`` keeps
    what ``training.pretrain.PretrainModel`` holds.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from spmm_tpu_torch.configs import (
    BertArchConfig, property_config, smiles_config, text_config)

Params = dict[str, Any]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _put_linear(out: dict, prefix: str, p: Params) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["w"]).T)
    out[f"{prefix}.bias"] = _t(p["b"])


def _put_ln(out: dict, prefix: str, p: Params) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _put_bert(out: dict, tree: Params, prefix: str) -> None:
    emb = tree["embeddings"]
    out[f"{prefix}.embeddings.word_embeddings.weight"] = _t(emb["word"])
    out[f"{prefix}.embeddings.position_embeddings.weight"] = _t(emb["position"])
    out[f"{prefix}.embeddings.token_type_embeddings.weight"] = _t(
        emb["token_type"])
    _put_ln(out, f"{prefix}.embeddings.LayerNorm", emb["ln"])
    for i, layer in enumerate(tree["layers"]):
        lp = f"{prefix}.encoder.layer.{i}"
        for name, key in (("attention", "self_attn"),
                          ("crossattention", "cross_attn")):
            if key not in layer:
                continue
            a = layer[key]
            _put_linear(out, f"{lp}.{name}.self.query", a["q"])
            _put_linear(out, f"{lp}.{name}.self.key", a["k"])
            _put_linear(out, f"{lp}.{name}.self.value", a["v"])
            _put_linear(out, f"{lp}.{name}.output.dense", a["out"])
            _put_ln(out, f"{lp}.{name}.output.LayerNorm", a["ln"])
        mlp = layer["mlp"]
        _put_linear(out, f"{lp}.intermediate.dense", mlp["up"])
        _put_linear(out, f"{lp}.output.dense", mlp["down"])
        _put_ln(out, f"{lp}.output.LayerNorm", mlp["ln"])


def _put_bert_mlm(out: dict, tree: Params, prefix: str) -> None:
    _put_bert(out, tree["bert"], f"{prefix}.bert")
    head = tree["mlm_head"]
    _put_linear(out, f"{prefix}.cls.predictions.transform.dense",
                head["transform"])
    _put_ln(out, f"{prefix}.cls.predictions.transform.LayerNorm", head["ln"])
    if "w" in head["decoder"]:
        dec_w = _t(np.asarray(head["decoder"]["w"]).T)
    else:
        # tied head: the decoder weight IS the word table, written twice
        # exactly like torch.save of a tied module
        dec_w = out[f"{prefix}.bert.embeddings.word_embeddings.weight"]
    out[f"{prefix}.cls.predictions.decoder.weight"] = dec_w
    out[f"{prefix}.cls.predictions.decoder.bias"] = _t(head["decoder"]["b"])
    out[f"{prefix}.cls.predictions.bias"] = _t(head["decoder"]["b"])


def state_dict_from_jax_tree(
    tree: Params,
    text_cfg: Optional[BertArchConfig] = None,
    prop_cfg: Optional[BertArchConfig] = None,
) -> dict[str, torch.Tensor]:
    """A ``spmm_tpu`` SPMM params tree with numpy leaves -> reference-named
    fp32 tensors for ``SPMM.load_state_dict(strict=True)``."""
    for key, cfg in (("text_encoder", text_cfg or text_config()),
                     ("property_encoder", prop_cfg or property_config())):
        sub = tree[key]["bert"] if key == "text_encoder" else tree[key]
        if len(sub["layers"]) != cfg.num_hidden_layers:
            raise ValueError(f"{key} has {len(sub['layers'])} layers, the "
                             f"config {cfg.num_hidden_layers}")
    out: dict[str, torch.Tensor] = {}
    _put_bert_mlm(out, tree["text_encoder"], "text_encoder")
    _put_bert(out, tree["property_encoder"], "property_encoder")
    _put_linear(out, "property_embed", tree["property_embed"])
    out["property_cls"] = _t(tree["property_cls"])
    out["property_mask"] = _t(tree["property_mask"])
    mtr = tree["property_mtr_head"]
    _put_linear(out, "property_mtr_head.0", mtr["l1"])
    _put_ln(out, "property_mtr_head.2", mtr["ln"])
    _put_linear(out, "property_mtr_head.3", mtr["l2"])
    for name in ("property_proj", "text_proj", "itm_head"):
        if name in tree:
            _put_linear(out, name, tree[name])
    return out


def pretrain_state_dict_from_jax(
    state: Params,
    text_cfg: Optional[BertArchConfig] = None,
    prop_cfg: Optional[BertArchConfig] = None,
) -> dict[str, torch.Tensor]:
    """A ``spmm_tpu`` pretrain state ({"params" with "temp", "ema",
    "queue"}, numpy leaves) -> the reference names of
    ``PretrainModel.load_state_dict(strict=True)``."""
    out = state_dict_from_jax_tree(state["params"], text_cfg, prop_cfg)
    ema = state["ema"]
    _put_bert_mlm(out, ema["text_encoder"], "text_encoder_m")
    _put_bert(out, ema["property_encoder"], "property_encoder_m")
    _put_linear(out, "property_proj_m", ema["property_proj"])
    _put_linear(out, "text_proj_m", ema["text_proj"])
    out["temp"] = _t(state["params"]["temp"])
    out["prop_queue"] = _t(state["queue"]["prop"])
    out["text_queue"] = _t(state["queue"]["text"])
    out["queue_ptr"] = torch.tensor([int(state["queue"]["ptr"])])
    return out


def rxn_state_dict_from_jax_tree(
    tree: Params,
    decoder_cfg: Optional[BertArchConfig] = None,
    encoder_cfg: Optional[BertArchConfig] = None,
) -> dict[str, torch.Tensor]:
    """A ``spmm_tpu`` reaction tree (``init_rxn_params``) with numpy leaves
    -> the reference ``SPMM_rxn`` names for ``Rxn.load_state_dict(
    strict=True)``: ``decoder`` is ``text_encoder``, ``smiles_encoder`` is
    ``text_encoder2`` (spmm_tpu/models/rxn.py:4-8)."""
    stacks = (("decoder", "text_encoder", decoder_cfg or text_config()),
              ("smiles_encoder", "text_encoder2",
               encoder_cfg or smiles_config()))
    for key, _, cfg in stacks:
        n = len(tree[key]["bert"]["layers"])
        if n != cfg.num_hidden_layers:
            raise ValueError(f"{key} has {n} layers, the config "
                             f"{cfg.num_hidden_layers}")
    out: dict[str, torch.Tensor] = {}
    for key, prefix, _ in stacks:
        _put_bert_mlm(out, tree[key], prefix)
    return out


def downstream_state_dict_from_jax_tree(
    tree: Params, cfg: Optional[BertArchConfig] = None,
) -> dict[str, torch.Tensor]:
    """A ``spmm_tpu`` downstream tree (``init_downstream_params``) with numpy
    leaves -> the names of ``models.downstream.Downstream``: the truncated
    encoder under ``text_encoder.bert``, the heads as ``l1`` / ``l2`` with
    ``w`` transposed.  ``cfg`` is the full text config; the encoder must
    have its ``fusion_layer`` layers."""
    n_layers = (cfg or text_config()).fusion_layer
    if len(tree["encoder"]["layers"]) != n_layers:
        raise ValueError(f"encoder has {len(tree['encoder']['layers'])} "
                         f"layers, the truncated config {n_layers}")
    out: dict[str, torch.Tensor] = {}
    _put_bert(out, tree["encoder"], "text_encoder.bert")
    _put_linear(out, "l1", tree["head"]["l1"])
    _put_linear(out, "l2", tree["head"]["l2"])
    return out


def moe_state_dict_from_jax_tree(tree: Params) -> dict[str, torch.Tensor]:
    """A ``spmm_tpu`` MoE block (``init_moe_params``, numpy leaves) -> the
    names of ``parallel.ep.MoEBlock``.  Every leaf keeps JAX's layout: the
    router [H, E] (not transposed: the block multiplies ``tokens @
    router``), the expert slabs [E, H, F] and [E, F, H] with their biases,
    the LayerNorm's scale and bias."""
    return {"router": _t(tree["router"]["w"]),
            "up_weight": _t(tree["up"]["w"]), "up_bias": _t(tree["up"]["b"]),
            "down_weight": _t(tree["down"]["w"]),
            "down_bias": _t(tree["down"]["b"]),
            "LayerNorm.weight": _t(tree["ln"]["scale"]),
            "LayerNorm.bias": _t(tree["ln"]["bias"])}


def load_reference_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Read a reference checkpoint as fp32 tensors on the CPU, with ``_unk``
    renamed to ``_mask``: its ``state_dict``, else its ``model``, else the
    dict itself (spmm_tpu/checkpoint/convert.py:38)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = (ckpt.get("state_dict", ckpt.get("model", ckpt))
             if isinstance(ckpt, dict) else ckpt)
    return {k.replace("_unk", "_mask"): v.detach().to(torch.float32)
            for k, v in state.items() if isinstance(v, torch.Tensor)}


def drop_position_ids(state: Mapping[str, torch.Tensor]
                      ) -> dict[str, torch.Tensor]:
    """Without the ``*.embeddings.position_ids`` buffers that the
    reference's xbert saves: the port's embeddings compute positions."""
    return {k: v for k, v in state.items()
            if not k.endswith("embeddings.position_ids")}


def spmm_subset(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The keys an inference ``SPMM`` holds: drops the feature queues and
    ``queue_ptr``, the temperature ``temp``, the momentum twins (``*_m.``),
    the pretraining heads and the ``position_ids`` buffers."""
    heads = ("property_proj.", "text_proj.", "itm_head.")
    out = {}
    for k, v in drop_position_ids(state).items():
        top = k.split(".", 1)[0]
        if ("queue" in top or top == "temp" or top.endswith("_m")
                or k.startswith(heads)):
            continue
        out[k] = v
    return out


TWINS = ("text_encoder_m", "property_encoder_m", "property_proj_m",
         "text_proj_m")


def pretrain_subset(state: Mapping[str, torch.Tensor]
                    ) -> dict[str, torch.Tensor]:
    """The keys a ``PretrainModel`` holds, of a reference pretrain state:
    ``_unk`` renamed to ``_mask``, the ``position_ids`` buffers dropped, and
    every ``*_m`` entry but the four twins dropped (the reference saves
    more of them; JAX reads the four by name, spmm_tpu/models/spmm.py:
    114-120).  A missing twin stays missing, so a strict load raises.  The
    tied LM-head entries take the values JAX reads (``convert_bert_mlm``):
    the decoder weight the word table's, the decoder bias
    ``cls.predictions.bias``; in a file the reference saved they are
    equal already."""
    out = {}
    for k, v in drop_position_ids(state).items():
        k = k.replace("_unk", "_mask")
        top = k.split(".", 1)[0]
        if top.endswith("_m") and top not in TWINS:
            continue
        out[k] = v
    for mlm in ("text_encoder", "text_encoder_m"):
        head, word = (f"{mlm}.cls.predictions",
                      f"{mlm}.bert.embeddings.word_embeddings.weight")
        if f"{head}.decoder.weight" in out and word in out:
            out[f"{head}.decoder.weight"] = out[word]
        if f"{head}.decoder.bias" in out and f"{head}.bias" in out:
            out[f"{head}.decoder.bias"] = out[f"{head}.bias"]
    return out


def load_spmm_checkpoint(model, path: str):
    """Load a reference pretrain ``.ckpt`` into an inference ``SPMM``, in
    place and strictly (a missing weight raises); returns the model."""
    model.load_state_dict(spmm_subset(load_reference_checkpoint(path)),
                          strict=True)
    return model
