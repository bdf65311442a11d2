"""The routed experts of a configuration, under either name that published
configurations give their count: ``n_routed_experts`` (DeepSeek-V3's
layout) or ``num_experts`` (Kimi-Linear's).  The contract's cut rules
(``portbench/tests/test_portbench_harness.py``), the references and the
counts all read them here."""

from __future__ import annotations

EXPERTS = ("n_routed_experts", "num_experts")


def routed_experts(cfg: dict) -> tuple[int, int]:
    """(held here, published) routed experts of an expert layer, under the
    first of ``EXPERTS`` that ``cfg`` names: the published count from
    ``published`` where the configuration cuts it."""
    key = next(k for k in EXPERTS if k in cfg)
    held = cfg[key]
    return held, cfg.get("published", {}).get(key, held)
