"""Cell M's entries in a benchmark, found by name: the
``moonlight-16b-a3b`` configuration at its published widths with nothing
cut, the ``moonlight-8k-turn256-b128`` cell, its per-layer metrics and its
files.  ``check_entries(root)`` asserts them of the benchmark at ``root``;
other configurations and cells may come before or after them."""

from __future__ import annotations

import json
import os

from portbench.tests.tiny import LM_CELL as CELL
from portbench.tests.tiny import LM_CONFIG as CONFIG

RATE = "mol_per_s.pv2smiles"
NEW_METRICS = ["k3_roofline.moonlight", "moe_ms.moonlight",
               "moe_product_roofline.moonlight", "turn_ms.moonlight",
               "mfu.moonlight", "idle_pct.moonlight", "gemm_ms.moonlight"]
# the cell's metrics added after it, in order, after its first ones (later
# entries for other cells may come after them)
LATER_METRICS = ["prefill_attention_ms.moonlight"]
# the catalog's published numbers, none cut
PUBLISHED = {"hidden_size": 2048, "num_hidden_layers": 27,
             "n_routed_experts": 64, "num_experts_per_tok": 6,
             "vocab_size": 163840, "kv_lora_rank": 512,
             "moe_intermediate_size": 1408, "intermediate_size": 11264,
             "max_position_embeddings": 8192, "n_shared_experts": 2}
FILES = ("drivers/lm_turn.py", "lm_counts.py", "reference/latent_moe.py",
         "programs/latent_moe.py", f"traffic/{CELL}.json",
         "metrics/k3_roofline.py", "metrics/moe_ms.py",
         "metrics/moe_product_roofline.py", "metrics/turn_ms.py",
         "metrics/gemm_ms.py", "metrics/prefill_attention_ms.py")


def check_entries(root: str) -> None:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    configs = {c["name"]: c for c in b["configs"]}
    cells = {w["name"]: w for w in b["workloads"]}
    assert configs[CONFIG]["reduced"] == []
    assert cells[CELL]["config"] == CONFIG
    names = [m["name"] for m in b["per_layer"]]
    first = names.index(NEW_METRICS[0])
    assert names[first:first + len(NEW_METRICS)] == NEW_METRICS
    assert not any(CELL in m.get("workloads", ())
                   for m in b["per_layer"][:first])
    mine = [m for m in b["per_layer"][first:]
            if CELL in m.get("workloads", ())]
    assert [m["name"] for m in mine] == NEW_METRICS + LATER_METRICS
    for m in mine:
        assert m["workloads"] == [CELL]
        assert m["moves"] == RATE
    rates = {m["name"]: m["workloads"] for m in b["end_to_end"]
             if "workloads" in m}
    assert {"pv2smiles-k2-b512", CELL} <= set(rates[RATE])
    assert not any(CELL in cells_of for name, cells_of in rates.items()
                   if name != RATE)
    with open(os.path.join(root, configs[CONFIG]["file"])) as f:
        cfg = json.load(f)
    assert all(cfg[k] == v for k, v in PUBLISHED.items())
    assert "published" not in cfg
    assert (cfg["model"], cfg["reference"]) == (
        "latent_moe", "portbench/reference/latent_moe.py")
    for kind in FILES:
        assert os.path.exists(os.path.join(root, "portbench", kind)), kind
