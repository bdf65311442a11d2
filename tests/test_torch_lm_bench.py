"""The benchmark's latent MoE cell on the CPU: ``BENCHMARK.json`` with the
``moonlight-16b-a3b`` configuration and the ``moonlight-8k-turn256-b128``
cell still meets the contract, the cell's files are new files beside the
others, its driver runs a tiny copy end to end with ``correct`` true (and
the fp8 reference in the program's place reads far wider gaps), and its
readers give the right values on a hand-built trace and None where their
kernels or spans are absent.  The benchmark itself runs only on a card;
these tests hand the run the CPU."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.metrics import (
    gemm_ms, idle_pct, k3_roofline, mfu, moe_ms, moe_product_roofline,
    prefill_attention_ms, turn_ms)
from portbench.tests.test_portbench_harness import (
    test_benchmark_json_meets_the_contract)
from portbench.tests.tiny import REPO, edit, tiny_root
from portbench.trace import Trace

CELL = "moonlight-8k-turn256-b128"
CONFIG = "moonlight-16b-a3b"
NEW_METRICS = ["k3_roofline.moonlight", "moe_ms.moonlight",
               "moe_product_roofline.moonlight", "turn_ms.moonlight",
               "mfu.moonlight", "idle_pct.moonlight", "gemm_ms.moonlight"]
# the cell's metrics added after it, in order, after its first ones (later
# entries for other cells may come after them)
LATER_METRICS = ["prefill_attention_ms.moonlight"]
TINY = {"vocab_size": 97, "hidden_size": 64, "num_hidden_layers": 3,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
        "v_head_dim": 16, "intermediate_size": 96,
        "moe_intermediate_size": 32, "n_routed_experts": 8,
        "num_experts_per_tok": 2, "n_shared_experts": 1,
        "max_position_embeddings": 64}
TINY_TRAFFIC = {"batch": 3, "history": {"min": 5, "max": 20}, "turn": 4,
                "answer": 5, "positions": 64, "trace_batches": 1,
                "check_rows": 2,
                # bf16 program against the fp32 reference at hidden 64
                "limits": {"mean_token_gap": 0.01}}


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_the_contract_holds_with_the_new_cell():
    test_benchmark_json_meets_the_contract()


def test_the_cell_is_new_files_and_entries_beside_the_others():
    b = bench()
    assert b["configs"][-1]["name"] == CONFIG
    assert b["configs"][-1]["reduced"] == []
    assert b["workloads"][-1]["name"] == CELL
    assert b["workloads"][-1]["config"] == CONFIG
    cells = NEW_METRICS + LATER_METRICS
    names = [m["name"] for m in b["per_layer"]]
    first = names.index(NEW_METRICS[0])
    assert names[first:first + len(NEW_METRICS)] == NEW_METRICS
    assert not any(CELL in m.get("workloads", ())
                   for m in b["per_layer"][:first])
    mine = [m for m in b["per_layer"][first:]
            if CELL in m.get("workloads", ())]
    assert [m["name"] for m in mine] == cells
    for m in mine:
        assert m["workloads"] == [CELL]
        assert m["moves"] == "mol_per_s.pv2smiles"
    rates = {m["name"]: m.get("workloads") for m in b["end_to_end"]}
    assert rates["mol_per_s.pv2smiles"] == ["pv2smiles-k2-b512", CELL]
    assert CELL not in rates["mol_per_s.rxn"] + rates["mol_per_s.smiles2pv"]
    with open(os.path.join(REPO, "portbench", "configs",
                           f"{CONFIG}.json")) as f:
        cfg = json.load(f)
    # the catalog's published numbers, none cut
    published = {"hidden_size": 2048, "num_hidden_layers": 27,
                 "n_routed_experts": 64, "num_experts_per_tok": 6,
                 "vocab_size": 163840, "kv_lora_rank": 512,
                 "moe_intermediate_size": 1408, "intermediate_size": 11264,
                 "max_position_embeddings": 8192, "n_shared_experts": 2}
    assert all(cfg[k] == v for k, v in published.items())
    for kind in ("drivers/lm_turn.py", "lm_counts.py",
                 "reference/latent_moe.py", f"traffic/{CELL}.json",
                 "metrics/k3_roofline.py", "metrics/moe_ms.py",
                 "metrics/moe_product_roofline.py", "metrics/turn_ms.py",
                 "metrics/gemm_ms.py", "metrics/prefill_attention_ms.py"):
        assert os.path.exists(os.path.join(REPO, "portbench", kind))


def tiny_cell(tmp_path) -> str:
    root = tiny_root(tmp_path)
    edit(os.path.join(root, "portbench", "configs", f"{CONFIG}.json"),
         lambda c: {**c, **TINY})
    edit(os.path.join(root, "portbench", "traffic", f"{CELL}.json"),
         lambda t: {**t, **TINY_TRAFFIC})
    return root


def test_driver_runs_end_to_end_correct(tmp_path):
    """A window and a traced run of the tiny cell, in a process of its own:
    the harness refuses to run where JAX is loaded, as it is in this one."""
    code = f"""
import sys, torch
from portbench import run
from tests.test_torch_lm_bench import CELL, tiny_cell
root = tiny_cell({str(tmp_path)!r})
for trace in ("0", "1"):
    rc = run.main(["--workload", CELL, "--seed", "3987654321", "--seconds",
                   "0.5", "--trace", trace], root=root,
                  device=torch.device("cpu"))
    if rc:
        sys.exit(rc)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    window, traced = (json.loads(x) for x in out.stdout.strip().splitlines())
    for line in (window, traced):
        assert line["correct"] is True and line["failed"] == 0
        assert line["attempted"] % 3 == 0 and line["attempted"] > 0
        assert set(line["checks"]) == {"mean_token_gap", "answer_errors"}
    assert set(window["metrics"]) == {"mol_per_s.pv2smiles", "setup_s"}
    assert set(traced["metrics"]) <= set(NEW_METRICS)
    assert "mfu.moonlight" in traced["metrics"]


def test_fp8_reference_in_the_programs_place_reads_wider_gaps(tmp_path):
    """The control the limits are set against: at the tiny widths too the
    fp8 reference's choices sit further below the reference's best than
    the program's."""
    from portbench.drivers import lm_turn
    from portbench.traffic import WINDOW

    root = tiny_cell(tmp_path)
    with open(os.path.join(root, "portbench", "configs",
                           f"{CONFIG}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "portbench", "traffic",
                           f"{CELL}.json")) as f:
        mix = json.load(f)
    readings = {}
    for control in (None, "ref_fp8"):
        d = lm_turn.Driver(cfg, mix, 11, torch.device("cpu"), control)
        d.setup()
        batches = [(0, d.run(d.inputs(WINDOW, 0)[1]))]
        d.free()
        readings[control] = dict((n, v) for n, v, _ in d.check(batches))
    assert readings["ref_fp8"]["mean_token_gap"] > \
        4 * readings[None]["mean_token_gap"]
    assert readings[None]["answer_errors"] == 0


# ---- readers on a hand-built trace ----

def hand_trace(with_kernels=True):
    """Two graph steps after a prefill span: a GEMM of 10 us; the prefill's
    expert layer (router, a dispatch sort, two products of 3 and 2 us, the
    pairs' sum) over 8 us; then k3 launches (attention and combine) of
    2 us each a step, and the first step's expert layer over 5 us."""
    dev = [("nvjet_gemm_bf16", 100.0, 110.0)]
    if with_kernels:
        dev += [("void (anonymous namespace)::moe_route_kernel<32>(...)",
                 110.0, 111.0),
                ("void at::native::radixSortKVInPlace<...>(...)",
                 111.0, 112.0),
                ("void (anonymous namespace)::moe_product_kernel<true, ...>",
                 112.0, 115.0),
                ("void (anonymous namespace)::moe_product_kernel<false, ...>",
                 115.0, 117.0),
                ("(anonymous namespace)::moe_combine_kernel(...)",
                 117.0, 118.0),
                ("(anonymous namespace)::mla_decode_attention_kernel(...)",
                 200.0, 202.0),
                ("(anonymous namespace)::mla_decode_combine_kernel(...)",
                 202.0, 204.0),
                ("void (anonymous namespace)::moe_route_kernel<8>(...)",
                 204.0, 205.0),
                ("void (anonymous namespace)::moe_product_kernel<true, ...>",
                 205.0, 207.0),
                ("void (anonymous namespace)::moe_product_kernel<false, ...>",
                 207.0, 208.0),
                ("(anonymous namespace)::moe_combine_kernel(...)",
                 208.0, 209.0),
                ("(anonymous namespace)::mla_decode_attention_kernel(...)",
                 300.0, 302.0),
                ("(anonymous namespace)::mla_decode_combine_kernel(...)",
                 302.0, 304.0)]
    host = [("spmm.lm.turn", 90.0, 400.0), ("spmm.lm.prefill", 95.0, 150.0)]
    if with_kernels:
        host += [("cudaGraphLaunch", 160.0, 170.0),
                 ("cudaGraphLaunch", 260.0, 270.0)]
    t = Trace(sorted(dev, key=lambda e: e[1]), host, [(90.0, 400.0)],
              0.00031)
    t.plain_s = [0.0004]
    return t


def works():
    return [{"model_flops": 4e10, "peak_flops": 1e15, "steps": 2,
             "k3": (4, 4e-6), "moe_product": (4, 4e-6)}]


def test_readers_on_a_hand_built_trace():
    t = hand_trace()
    assert k3_roofline.read(t, works(), CELL) == pytest.approx(50.0)
    assert moe_product_roofline.read(t, works(), CELL) == pytest.approx(50.0)
    # the two expert layers: 110-118 and 204-209 us
    assert moe_ms.read(t, works(), CELL) == pytest.approx(0.013)
    assert gemm_ms.read(t, works(), CELL) == pytest.approx(0.01)
    # prefill's first kernel at 100 us, the first graph's at 200 us
    assert turn_ms.read(t, works(), CELL) == pytest.approx(0.1)
    assert mfu.read(t, works(), CELL) == pytest.approx(10.0)
    busy = (18 + 9 + 4) / 1e6
    assert idle_pct.read(t, works(), CELL) == pytest.approx(
        100 * (1 - busy / 0.0004))


def test_readers_give_none_where_their_kernels_are_absent():
    t = hand_trace(with_kernels=False)
    for reader in (k3_roofline, moe_product_roofline, moe_ms, turn_ms):
        assert reader.read(t, works(), CELL) is None
    # the parent of this change: no such work counted either
    assert k3_roofline.read(hand_trace(), [{"steps": 2}], CELL) is None


def test_prefill_attention_reader_sums_its_launches():
    """``prefill_attention_ms``: the prefill kernel's launches summed a
    batch (not the expansions' GEMMs beside them); None in a trace without
    them, as the parent of the kernel's change gives."""
    dev = [("(anonymous namespace)::mla_prefill_attention_kernel(...)",
            100.0, 104.0),
           ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 104.0, 106.0),
           ("(anonymous namespace)::mla_prefill_attention_kernel(...)",
            106.0, 109.0),
           ("(anonymous namespace)::mla_prefill_attention_kernel(...)",
            300.0, 305.0)]
    t = Trace(dev, [], [(90.0, 200.0), (290.0, 400.0)], 0.00022)
    assert prefill_attention_ms.read(t, works(), CELL) == pytest.approx(0.006)
    assert prefill_attention_ms.read(hand_trace(), works(), CELL) is None
