"""The port's bench (spmm_tpu_torch/bench.py) on the CPU at a tiny width.

- Every workload's lines carry the JAX bench's metric names and units (read
  from the root bench.py as text, never imported), the fields the port's
  bench adds, and ``"correct": true``.
- A perturbed kernel path turns ``correct`` false and ``main``'s exit code
  non-zero.
- The inputs depend on the seed; an out-of-memory error falls to the next
  batch; a spent budget runs nothing and fails; ``main`` prints the PENDING
  notes first and the headline again last.
- The decode and SMILES->PV workloads' searches and inputs, on the same
  weights, give what JAX's ``_beam_batch`` and ``predict_pv`` give.
"""

import json
import os
import re
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spmm_tpu.inference import decoding as jdec
from spmm_tpu.inference import pv2smiles as jpv
from spmm_tpu.inference.smiles2pv import predict_pv as jpredict_pv

from spmm_tpu_torch import bench
from spmm_tpu_torch.configs import BertArchConfig
from spmm_tpu_torch.inference.smiles2pv import predict_pv

from torch_parity import CPU, jax_configs, jax_tree, port_model, t, to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TEXT = BertArchConfig(hidden_size=32, num_hidden_layers=2,
                       num_attention_heads=2, intermediate_size=64,
                       fusion_layer=1, encoder_width=32)
_ENCODER = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=64, fusion_layer=2,
                add_cross_attention=False)
TINY = bench.Setup(
    text_cfg=_TEXT, prop_cfg=BertArchConfig(vocab_size=1, **_ENCODER),
    smiles_cfg=BertArchConfig(**_ENCODER), decode_steps=(4, 6),
    decode_batches=(4,), n_molecules=8, s2p_batches=(4,), s2p_timed=2,
    rxn_batches=(4,), rxn_max_steps=4, rxn_timed=2, beam_batch=4,
    pipeline_lines=500, pretrain_runs=((4, "bf16"), (4, "fp32")), windows=2,
    window=2)

COMMON = ("metric", "value", "unit", "vs_baseline", "baseline",
          "median_batch_ms", "batch_ms", "n_samples", "device", "card",
          "torch", "cuda", "correct")
# workload -> (its metrics, the fields each of its lines carries, timed
# samples a line)
EXPECTED = {
    "decode": (list(bench.DECODE_METRICS),
               ("batch", "k", "max_steps", "steps", "attention"), 2),
    "pipeline": (["host_pipeline_samples_per_sec"],
                 ("batch", "native_tokenizer", "uses_device"), 5),
    "smiles2pv": (["smiles2pv_mol_per_sec"],
                  ("batch", "seq_len", "attention"), 2),
    "rxn_greedy": (["rxn_greedy_mol_per_sec"],
                   ("batch", "src_len", "max_steps", "attention"), 2),
    "rxn_beam": (["rxn_beam_k5_mol_per_sec"],
                 ("batch", "k", "src_len", "max_steps", "attention"), 2),
    "pretrain": (["pretrain_samples_per_sec_chip"] * 2 + ["pretrain_mfu"],
                 ("batch", "accum", "compute", "step_ms_best",
                  "step_ms_device", "flops_per_step"), 2),
}


def jax_bench_units() -> dict:
    """metric -> unit of every line the root bench.py prints, from its
    source text."""
    with open(os.path.join(REPO, "bench.py")) as f:
        text = f.read()
    return dict(re.findall(r'"metric":\s*"(\w+)",.*?"unit":\s*"([^"]+)"',
                           text, re.S))


@pytest.fixture(scope="module")
def lines() -> dict:
    b = bench.Bench(CPU, "kernel", TINY)
    return {name: list(getattr(b, name)()) for name in bench.WORKLOADS}


def test_every_jax_metric_has_its_unit_in_the_port():
    jax_units = jax_bench_units()
    assert set(jax_units) == {
        "pv2smiles_beam_k2_throughput",
        "pv2smiles_beam_k2_throughput_100step",
        "host_pipeline_samples_per_sec", "smiles2pv_mol_per_sec",
        "rxn_greedy_mol_per_sec", "pretrain_samples_per_sec_chip",
        "pretrain_mfu"}
    for metric, unit in jax_units.items():
        assert bench.UNITS[metric] == unit
    assert set(bench.UNITS) - set(jax_units) == {"rxn_beam_k5_mol_per_sec"}
    assert bench.UNITS["rxn_beam_k5_mol_per_sec"] == "mol/s"


@pytest.mark.parametrize("workload", bench.WORKLOADS)
def test_workload_lines(lines, workload):
    metrics, fields, n_samples = EXPECTED[workload]
    got = lines[workload]
    assert [ln["metric"] for ln in got] == metrics
    jax_units = jax_bench_units()
    for ln in got:
        assert set(COMMON + fields) <= set(ln), ln
        assert ln["unit"] == bench.UNITS[ln["metric"]] == jax_units.get(
            ln["metric"], "mol/s")
        assert ln["correct"] is True
        assert ln["device"] == "cpu" and ln["card"] is None
        assert ln["torch"] == torch.__version__
        assert ln["n_samples"] == len(ln["batch_ms"]) == n_samples
        assert ln["median_batch_ms"] == np.median(ln["batch_ms"])
        if "attention" in fields:
            assert ln["attention"] == "kernel"
        if ln["metric"] == "pretrain_mfu":     # a device metric: not on the CPU
            assert ln["value"] is None and ln["flops_per_step"] > 0
        else:
            assert np.isfinite(ln["value"]) and ln["value"] > 0
        json.dumps(ln)
    if workload == "decode":
        assert [ln["max_steps"] for ln in got] == list(TINY.decode_steps)
        assert all(ln["vs_baseline"] is not None and ln["baseline"]
                   for ln in got)
    if workload == "pipeline":
        assert got[0]["uses_device"] is False
        assert got[0]["samples"] == 480          # 5 whole batches of 96


def _perturbed(fn, is_kernel, offset):
    """``fn`` with ``offset`` added to its result where ``is_kernel`` says
    the call takes the kernel path."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        if not is_kernel(args, kwargs):
            return out
        if isinstance(out, torch.Tensor):
            return out + offset
        return {**out, **{key: out[key] + offset
                          for key in ("logp", "seqs") if key in out}}
    return wrapped


@pytest.mark.parametrize("workload,name,is_kernel,offset", [
    ("decode", "pv_beam_batch",
     lambda a, kw: a[4].attention == "kernel", 1e-3),
    ("smiles2pv", "predict_pv",
     lambda a, kw: kw["attention_impl"] == "kernel", 1e-4),
    ("rxn_greedy", "_greedy_batch",
     lambda a, kw: kw["attention"] == "kernel", 1),
    ("rxn_beam", "rxn_beam_batch",
     lambda a, kw: a[4].attention == "kernel", 1e-3),
])
def test_perturbed_kernel_path_is_not_correct(monkeypatch, capsys, workload,
                                              name, is_kernel, offset):
    monkeypatch.setattr(bench, name, _perturbed(getattr(bench, name),
                                                is_kernel, offset))
    got = list(getattr(bench.Bench(CPU, "kernel", TINY), workload)())
    assert got and not any(ln["correct"] for ln in got)
    assert bench.main(["--device", "cpu", "--only", workload],
                      setup=TINY) != 0
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()
               if x.startswith("{")]
    assert printed and all(ln["correct"] is False for ln in printed)


def test_inputs_depend_on_the_seed():
    a, b = bench.decode_inputs(0, 1, 4), bench.decode_inputs(0, 1, 4)
    assert a.shape == (4, 53) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, bench.decode_inputs(1, 1, 4))
    assert not np.array_equal(a, bench.decode_inputs(0, 2, 4))
    ids, mask = bench.token_inputs(0, 3, 1, 4, 16, cls_first=True)
    assert (ids[:, 0] == 2).all() and (ids[:, 1:] >= 4).all() \
        and (ids < 300).all() and (mask == 1).all()
    np.testing.assert_array_equal(
        ids, bench.token_inputs(0, 3, 1, 4, 16, cls_first=True)[0])
    assert not np.array_equal(
        ids, bench.token_inputs(1, 3, 1, 4, 16, cls_first=True)[0])


def test_main_prints_the_notes_first_and_the_headline_last(capsys):
    assert bench.main(["--device", "cpu", "--only", "decode"],
                      setup=TINY) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(("PENDING", "RUN NOW")) and \
        out[1].startswith(("PENDING", "RUN NOW"))
    recs = [json.loads(x) for x in out[2:]]
    assert [r["metric"] for r in recs] == list(bench.DECODE_METRICS) + [
        bench.HEADLINE]
    assert recs[-1] == recs[0]


def test_a_spent_budget_runs_nothing_and_fails(capsys):
    assert bench.main(["--device", "cpu", "--budget_s", "-1"],
                      setup=TINY) != 0
    assert not [x for x in capsys.readouterr().out.splitlines()
                if x.startswith("{")]


def test_the_tokenizer_builds_before_the_clock_starts(monkeypatch):
    """The native tokenizer's first use (its c++ build) belongs to the
    pipeline's warm-up, not to its first timed batch."""
    class SlowFirstUse(bench.SmilesTokenizer):
        def native_encoder(self):
            if not getattr(self, "_ready", False):
                time.sleep(1.0)
                self._ready = True
            return super().native_encoder()

    monkeypatch.setattr(bench, "SmilesTokenizer", SlowFirstUse)
    line, = bench.Bench(CPU, "kernel", TINY).pipeline()
    assert line["correct"] and max(line["batch_ms"]) < 500


def test_out_of_memory_falls_to_the_next_batch():
    tried = []

    def measure(batch):
        tried.append(batch)
        if batch > 4:
            raise torch.OutOfMemoryError("out of memory")
        return {"batch": batch}

    assert bench.first_that_fits(CPU, (16, 8, 4), measure) == {"batch": 4}
    assert tried == [16, 8, 4]
    with pytest.raises(torch.OutOfMemoryError):
        bench.first_that_fits(CPU, (16, 8), measure)


def test_decode_workload_matches_jax():
    """The bench's search and inputs, fp32, on JAX's weights: seqs and
    n_finished equal to JAX's ``_beam_batch``, logp within the bench's
    bar."""
    tree = jax_tree(3, sep_bias=0.3)
    tcj, pcj = jax_configs()
    steps = 6
    pv = bench.decode_inputs(0, 1, 4)
    spec = jdec.BeamSpec(k=bench.K, stop_count=bench.K * bench.K * steps,
                         max_steps=steps)
    want = jax.device_get(jpv._beam_batch(
        to_jax(tree), jnp.asarray(pv), None,
        jax.random.split(jax.random.PRNGKey(0), 4), spec, tcj, pcj,
        bf16=False))
    model = port_model(tree)
    got = bench.pv_beam_batch(model, model.text_encoder, t(pv), None,
                              bench.decode_spec(steps, "kernel"))
    np.testing.assert_array_equal(got["seqs"].numpy(), want["seqs"])
    np.testing.assert_array_equal(got["n_finished"].numpy(),
                                  want["n_finished"])
    assert bench.close(got["logp"], t(want["logp"]), 1e-5, 5e-7)


def test_smiles2pv_workload_matches_jax():
    """The bench's SMILES->PV inputs through JAX's ``predict_pv`` and the
    port's on the same weights: within 2e-5."""
    tree = jax_tree(0)
    tcj, pcj = jax_configs()
    ids, mask = bench.token_inputs(0, bench._S2P, 1, 4, bench.S2P_SEQ_LEN)
    want = np.asarray(jpredict_pv(to_jax(tree), jnp.asarray(ids),
                                  jnp.asarray(mask), text_cfg=tcj,
                                  prop_cfg=pcj))
    got = predict_pv(port_model(tree), ids, mask, attention_impl="kernel",
                     device=CPU)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
