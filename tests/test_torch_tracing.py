"""The program's spans (``utils.spans.span``) and the benchmark's readers
of them, on the CPU.

- With the profiler off, ``span`` is one shared no-op.
- Under ``torch.profiler`` a tiny batch of each k-beam entry point, run by
  the eager loop, records one root span, the prologue's spans before one
  ``spmm.decode.loop``, a ``spmm.decode.step`` a step and a
  ``spmm.decode.stop_test`` a step (less one when the loop ran all its
  positions), properly nested; ``SmilesTokenizer.decode`` records one
  ``spmm.detokenize`` a call, and the tokenizer's module loads no torch.
- ``loop_gap_us``, ``prologue_idle_ms`` and ``detok_ms`` read exact values
  from a hand-built trace, and None from one without spans, graph
  launches or device work.
- A traced run of the tiny benchmark prints ``detok_ms.rxn``.
The same spans on the card, replayed as CUDA graphs, are held by
tests/test_torch_cuda.py."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.metrics import detok_ms, loop_gap_us, prologue_idle_ms
from portbench.trace import Trace
from spmm_tpu_torch.configs import BertArchConfig
from spmm_tpu_torch.inference import decoding, pv2smiles, rxn
from spmm_tpu_torch.models.rxn import Rxn
from spmm_tpu_torch.models.spmm import N_PROPERTIES, SPMM
from spmm_tpu_torch.tokenizer import SmilesTokenizer
from spmm_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, MAX_STEPS = 2, 5
PROLOGUE = ("spmm.decode.cross_kv", "spmm.decode.load")


def _arch(layers: int, fusion: int, **kw) -> BertArchConfig:
    return BertArchConfig(hidden_size=32, num_hidden_layers=layers,
                          num_attention_heads=2, intermediate_size=64,
                          fusion_layer=fusion, encoder_width=32,
                          max_position_embeddings=128, **kw)


def _pv2smiles(spec):
    model = SPMM.random_init(0, _arch(2, 1), _arch(2, 2),
                             device="cpu").eval()
    decoder = pv2smiles.decoder_for(model, bf16=False)
    pv = torch.as_tensor(np.random.default_rng(1).normal(
        size=(3, N_PROPERTIES)).astype(np.float32))
    return decoder, lambda: pv2smiles._beam_batch(model, decoder, pv, None,
                                                  spec)


def _rxn(spec):
    model = Rxn.random_init(0, _arch(2, 1), _arch(1, 1,
                                                  add_cross_attention=False),
                            device="cpu").eval()
    decoder = pv2smiles.decoder_for(model, bf16=False)
    ids = torch.as_tensor(np.random.default_rng(2).integers(
        4, 300, size=(3, 12)))
    ids[:, 0] = 2
    mask = torch.ones_like(ids, dtype=torch.int32)
    mask[1, 9:] = 0
    return decoder, lambda: rxn._beam_batch(model, decoder, ids, mask, spec)


def _spans(prof) -> list:
    return [(ev.name, ev.time_range.start, ev.time_range.end)
            for ev in prof.events() if ev.name.startswith("spmm.")]


def _named(spans: list, name: str) -> list:
    return [(a, b) for n, a, b in spans if n == name]


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_the_span_is_a_shared_no_op_with_the_profiler_off():
    off = profiling.span("spmm.test")
    assert off is profiling.span("spmm.other")
    with off as entered:
        assert entered is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = profiling.span("spmm.test.on")
        with on:
            pass
    assert on is not off
    assert [n for n, _, _ in _spans(prof)] == ["spmm.test.on"]


@pytest.mark.parametrize("entry,root,encode", [
    (_pv2smiles, "spmm.pv2smiles.batch", "spmm.pv2smiles.encode"),
    (_rxn, "spmm.rxn.batch", "spmm.rxn.encode")])
@pytest.mark.parametrize("stops_early", [False, True])
def test_an_entry_points_spans_on_the_eager_loop(entry, root, encode,
                                                 stops_early):
    """Early: a [SEP] logit raised by 5 and stop_count k end the search at
    its second step; else stop_count is unreachable and every position
    runs."""
    spec = decoding.BeamSpec(
        k=K, max_steps=MAX_STEPS,
        stop_count=K if stops_early else K * K * (MAX_STEPS + 1))
    decoder, run = entry(spec)
    if stops_early:
        with torch.no_grad():
            decoder.cls.predictions.bias[spec.sep_id] += 5.0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = run()
    spans = _spans(prof)
    n_pos = MAX_STEPS + 1
    assert (res["steps"] < n_pos) == stops_early
    (top,) = _named(spans, root)
    (loop,) = _named(spans, "spmm.decode.loop")
    steps = _named(spans, "spmm.decode.step")
    stop_tests = _named(spans, "spmm.decode.stop_test")
    assert len(steps) == res["steps"]
    assert len(stop_tests) == res["steps"] - (res["steps"] == n_pos)
    for name in (encode,) + PROLOGUE:
        (part,) = _named(spans, name)
        assert _inside(part, top) and part[1] <= loop[0], name
    (result,) = _named(spans, "spmm.decode.result")
    assert _inside(loop, top) and _inside(result, top)
    assert loop[1] <= result[0]
    assert all(_inside(s, loop) for s in steps + stop_tests)
    for _, a, b in spans:        # any two: disjoint, or one holds the other
        for _, c, d in spans:
            assert b <= c or d <= a or (a <= c and d <= b) or (
                c <= a and b <= d)


def test_decode_records_one_detokenize_span_a_call():
    tok = SmilesTokenizer()
    ids = tok.encode("[CLS]CC(=O)O")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        strings = [tok.decode(ids) for _ in range(3)]
    assert len(set(strings)) == 1
    assert [n for n, _, _ in _spans(prof)] == ["spmm.detokenize"] * 3


def test_the_tokenizer_names_its_work_without_loading_torch():
    code = ("import sys, spmm_tpu_torch.tokenizer as t; "
            "t.SmilesTokenizer().decode([2, 10, 3]); "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


def _trace(host: list) -> Trace:
    """Two batches over 0-120 us; the device busy at 0-10, 30-40, 60-70 and
    100-110."""
    device = [("k", 0.0, 10.0), ("k", 30.0, 40.0), ("k", 60.0, 70.0),
              ("k", 100.0, 110.0)]
    return Trace(device, sorted(host, key=lambda ev: ev[1]),
                 [(0.0, 60.0), (60.0, 120.0)], 1.2e-4)


SPANS = [("spmm.rxn.batch", 0.0, 111.0), ("spmm.rxn.encode", 0.0, 12.0),
         ("spmm.decode.loop", 20.0, 110.0),
         ("spmm.decode.step", 20.0, 24.0), ("cudaGraphLaunch", 21.0, 23.0),
         ("spmm.decode.stop_test", 25.0, 36.0),
         ("cudaStreamSynchronize", 26.0, 30.0),
         ("cudaStreamSynchronize", 31.0, 35.0),
         ("spmm.decode.step", 45.0, 51.0), ("cudaGraphLaunch", 47.0, 50.0),
         ("spmm.decode.stop_test", 52.0, 58.0),
         ("cudaStreamSynchronize", 53.0, 57.0),
         ("spmm.decode.step", 75.0, 80.0), ("cudaGraphLaunch", 77.0, 78.0),
         ("cudaGraphLaunch", 79.0, 80.0),
         ("spmm.decode.stop_test", 81.0, 84.0),
         ("cudaStreamSynchronize", 82.0, 83.0),
         ("spmm.decode.step", 90.0, 100.0),
         ("cudaGraphLaunch_v10000", 93.0, 99.0),
         ("spmm.detokenize", 112.0, 114.0), ("spmm.detokenize", 115.0, 118.0)]


def test_the_readers_read_exact_values_from_a_hand_built_trace():
    trace = _trace(SPANS)
    # from the last synchronise of each stop test to the first launch of
    # the step after it: 47 - 35, 77 - 57, 93 - 83; their median
    assert loop_gap_us.read(trace, [], {}) == pytest.approx(12.0)
    # idle from the root's start to the loop's: 10-20
    assert prologue_idle_ms.read(trace, [], {}) == pytest.approx(0.010)
    # 2 + 3 us over 2 batches
    assert detok_ms.read(trace, [], {}) == pytest.approx(0.0025)


def test_the_readers_read_none_without_spans():
    bare = _trace([("aten::addmm", 1.0, 2.0), ("cudaGraphLaunch", 22.0, 35.0),
                   ("cudaStreamSynchronize", 36.0, 40.0)])
    for reader in (loop_gap_us, prologue_idle_ms, detok_ms):
        assert reader.read(bare, [], {}) is None
    # the eager loop launches no graph: no loop gap; a CPU trace holds no
    # device work: no prologue idle
    eager = _trace([ev for ev in SPANS if not ev[0].startswith("cudaGraph")])
    assert loop_gap_us.read(eager, [], {}) is None
    cpu = Trace([], SPANS, [(0.0, 120.0)], 1.2e-4)
    assert prologue_idle_ms.read(cpu, [], {}) is None


def test_a_traced_tiny_run_prints_detok_ms(tmp_path):
    """In a process of its own: the harness refuses to run where JAX is
    loaded, as it is in this one."""
    code = f"""
import json, sys, torch
from portbench.tests.tiny import tiny_root
from portbench import run
root = tiny_root({str(tmp_path)!r})
sys.exit(run.main(["--workload", "rxn-beam-k5-b32", "--seed", "4100000007",
                   "--seconds", "0.5", "--trace", "1"], root=root,
                  device=torch.device("cpu")))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["detok_ms.rxn"]["value"] > 0
    assert line["metrics"]["detok_ms.rxn"]["unit"] == "ms"
