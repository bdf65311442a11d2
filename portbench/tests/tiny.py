"""A copy of the benchmark at tiny widths, for the CPU tests: the same
files with the configurations cut to hidden 32, two heads and few layers,
the traffic mixes to a few small batches, and the program beside them."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY_ARCH = {"hidden_size": 32, "num_attention_heads": 2,
             "intermediate_size": 64, "encoder_width": 32,
             "max_position_embeddings": 128}
LAYERS = {("spmm", "text"): (4, 2), ("spmm", "property"): (2, 2),
          ("rxn", "decoder"): (4, 2), ("rxn", "encoder"): (2, 2)}
TRAFFIC = {"pv2smiles-k2-b512": {"batch": 4, "max_steps": 6},
           "rxn-beam-k5-b32": {"batch": 3, "max_steps": 6,
                               "inputs": {"length": {"fixed": 12}}},
           "smiles2pv-b128": {"batch": 6,
                              "inputs": {"length": {"lognormal": {
                                  "median": 6, "sigma": 0.45, "min": 3,
                                  "max": 14}}, "buckets": [8, 16]}}}
# limits loose enough for any sound tiny run, tight enough for a fault
TINY_LIMITS = {"token_gap": 0.1, "mean_token_gap": 0.01, "score_gap": 0.05,
               "pv_error": 1e-3}
# the latent MoE configuration and its cell's traffic at tiny widths
LM_CONFIG, LM_CELL = "moonlight-16b-a3b", "moonlight-8k-turn256-b128"
LM_TINY = {"vocab_size": 97, "hidden_size": 64, "num_hidden_layers": 3,
           "num_attention_heads": 4, "num_key_value_heads": 4,
           "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
           "v_head_dim": 16, "intermediate_size": 96,
           "moe_intermediate_size": 32, "n_routed_experts": 8,
           "num_experts_per_tok": 2, "n_shared_experts": 1,
           "max_position_embeddings": 64}
LM_TINY_TRAFFIC = {"batch": 3, "history": {"min": 5, "max": 20}, "turn": 4,
                   "answer": 5, "positions": 64, "trace_batches": 1,
                   "check_rows": 2,
                   # bf16 program against the fp32 reference at hidden 64
                   "limits": {"mean_token_gap": 0.01}}


def lm_tiny(**changes) -> dict:
    """The latent MoE configuration at tiny widths, with ``changes``."""
    with open(os.path.join(REPO, "portbench", "configs",
                           f"{LM_CONFIG}.json")) as f:
        return {**json.load(f), **LM_TINY, **changes}


def shrink_config(name: str, config: dict) -> dict:
    for (model, part), (layers, fusion) in LAYERS.items():
        if model == name:
            config[part].update(TINY_ARCH, num_hidden_layers=layers,
                                fusion_layer=fusion)
    return config


def _merge(base: dict, new: dict) -> dict:
    for key, value in new.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            _merge(base[key], value)
        else:
            base[key] = value
    return base


def tiny_root(tmp_path) -> str:
    """A directory holding BENCHMARK.json, a tiny copy of portbench/ and a
    link to the program; returns its path."""
    root = str(tmp_path)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(REPO, "spmm_tpu_torch"),
               os.path.join(root, "spmm_tpu_torch"))
    for name in ("spmm", "rxn"):
        path = os.path.join(root, "portbench", "configs", f"{name}.json")
        edit(path, lambda c, name=name: shrink_config(name, c))
    for name, change in TRAFFIC.items():
        path = os.path.join(root, "portbench", "traffic", f"{name}.json")
        edit(path, lambda t, change=change: _merge(
            _merge(t, change), {"trace_batches": 1, "check_rows": 5,
                                "limits": {k: v for k, v in
                                           TINY_LIMITS.items()
                                           if k in t["limits"]}}))
    return root


def edit(path: str, change) -> None:
    with open(path) as f:
        data = json.load(f)
    data = change(data)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
