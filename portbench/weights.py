"""Random weights of a configuration, made from the seed on the device.

The benchmark makes the weights and hands the same tensors to both sides:
``load_into`` puts them into the port's model, and the plain reference
(``portbench.reference``) reads them by name.  The names are those of the
SPMM repository's checkpoints (HF BERT names under ``text_encoder.``,
``property_encoder.`` ...), which the port's modules also carry.

Every weight matrix and embedding is drawn from N(0, 0.02) (the reference's
``initializer_range``), biases are 0, LayerNorms 1 and 0, and the padding
row of each word table is 0.  All normal draws come from one
``torch.Generator`` on the device, in one call, in fp32: the configuration
serves the encoders in fp32 and the program casts its own bf16 decoder.
"""

from __future__ import annotations

import torch


def _bert(prefix: str, arch: dict, with_head: bool) -> list:
    """(name, shape, kind) of a BERT stack: kind is "normal", "zeros",
    "ones" or "alias:<name>" (a second name of one tensor)."""
    h, inter = arch["hidden_size"], arch["intermediate_size"]
    out = []

    def linear(name, n_out, n_in):
        out.append((f"{name}.weight", (n_out, n_in), "normal"))
        out.append((f"{name}.bias", (n_out,), "zeros"))

    def norm(name):
        out.append((f"{name}.weight", (h,), "ones"))
        out.append((f"{name}.bias", (h,), "zeros"))

    bert = f"{prefix}bert." if with_head else prefix
    emb = f"{bert}embeddings."
    out.append((f"{emb}word_embeddings.weight", (arch["vocab_size"], h),
                "normal"))
    out.append((f"{emb}position_embeddings.weight",
                (arch["max_position_embeddings"], h), "normal"))
    out.append((f"{emb}token_type_embeddings.weight",
                (arch["type_vocab_size"], h), "normal"))
    norm(f"{emb}LayerNorm")
    for i in range(arch["num_hidden_layers"]):
        layer = f"{bert}encoder.layer.{i}."
        blocks = [("attention", h)]
        if arch["add_cross_attention"] and i >= arch["fusion_layer"]:
            blocks.append(("crossattention", arch["encoder_width"]))
        for block, kv_width in blocks:
            linear(f"{layer}{block}.self.query", h, h)
            linear(f"{layer}{block}.self.key", h, kv_width)
            linear(f"{layer}{block}.self.value", h, kv_width)
            linear(f"{layer}{block}.output.dense", h, h)
            norm(f"{layer}{block}.output.LayerNorm")
        linear(f"{layer}intermediate.dense", inter, h)
        linear(f"{layer}output.dense", h, inter)
        norm(f"{layer}output.LayerNorm")
    if with_head:
        head = f"{prefix}cls.predictions."
        linear(f"{head}transform.dense", h, h)
        norm(f"{head}transform.LayerNorm")
        out.append((f"{head}bias", (arch["vocab_size"],), "zeros"))
        out.append((f"{head}decoder.bias", (arch["vocab_size"],),
                    f"alias:{head}bias"))
        out.append((f"{head}decoder.weight", (arch["vocab_size"], h),
                    f"alias:{emb}word_embeddings.weight"))
    return out


def spec(config: dict) -> list:
    """(name, shape, kind) of every tensor of ``config``'s model."""
    if config["model"] == "spmm":
        h = config["text"]["hidden_size"]
        out = _bert("text_encoder.", config["text"], True)
        out += _bert("property_encoder.", config["property"], False)
        out += [("property_embed.weight", (h, 1), "normal"),
                ("property_embed.bias", (h,), "zeros"),
                ("property_cls", (1, 1, h), "normal"),
                ("property_mask", (1, 1, h), "normal"),
                ("property_mtr_head.0.weight", (h, h), "normal"),
                ("property_mtr_head.0.bias", (h,), "zeros"),
                ("property_mtr_head.2.weight", (h,), "ones"),
                ("property_mtr_head.2.bias", (h,), "zeros"),
                ("property_mtr_head.3.weight", (1, h), "normal"),
                ("property_mtr_head.3.bias", (1,), "zeros")]
        return out
    if config["model"] == "rxn":
        return (_bert("text_encoder.", config["decoder"], True)
                + _bert("text_encoder2.", config["encoder"], True))
    raise ValueError(f"unknown model {config['model']!r}")


def make(config: dict, seed: int, device) -> dict:
    """name -> fp32 tensor on ``device``: every normal weight from one draw
    of a generator on the device seeded with ``seed``."""
    entries = spec(config)
    std = config["initializer_range"]
    normal = [(name, shape) for name, shape, kind in entries
              if kind == "normal"]
    total = sum(_numel(shape) for _, shape in normal)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device).mul_(std)
    out, start = {}, 0
    for name, shape in normal:
        n = _numel(shape)
        out[name] = flat[start:start + n].view(shape)
        start += n
    for name, shape, kind in entries:
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
    for name, _, kind in entries:
        if kind.startswith("alias:"):
            out[name] = out[kind[len("alias:"):]]
    for name in out:
        if name.endswith("word_embeddings.weight"):
            out[name][config["pad_token_id"]].zero_()
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def load_into(module: torch.nn.Module, weights: dict) -> torch.nn.Module:
    """Copy ``weights`` into ``module`` (every one of its tensors, by
    name), which is then in eval mode."""
    module.load_state_dict(weights, strict=True)
    return module.eval()
