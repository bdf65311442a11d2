"""The comparison that decides ``correct`` has to fail what it exists to
catch.

- Faults, on the CPU at tiny widths: the run is driven with the timed
  path broken underneath it, and ``correct`` comes out false: a token (or
  a prediction) altered where it is produced, and half of each batch's
  answers left out.
- A k-beam search that drops the beams' summed scores, on the CPU at tiny
  widths: ``correct`` comes out false.
- Controls, on the card at each cell's own size (skipped without one):
  the nearest lower precision in the program's place comes out not
  correct: the reference in fp8 for the bf16 decoders, the program with
  TF32 products for the fp32 SMILES->PV.  ``portbench.calibrate`` takes
  the same readings on many seeds.
"""

import json
import os

import numpy as np
import pytest
import torch

from portbench import run
from portbench.tests.tiny import REPO, tiny_root

CPU = torch.device("cpu")
SEED = "2718281828"


def altered_tokens(decode):
    def wrapper(*args, **kwargs):
        res = decode(*args, **kwargs)
        seqs = res["seqs"]
        seqs[:, 0, 3] = 4 + (seqs[:, 0, 3] + 101) % 296
        return res
    return wrapper


def half_of_the_rows(decode):
    def wrapper(*args, **kwargs):
        res = decode(*args, **kwargs)
        if isinstance(res, torch.Tensor):
            return res[: res.shape[0] // 2]
        return {k: v[: v.shape[0] // 2] if isinstance(v, torch.Tensor) else v
                for k, v in res.items()}
    return wrapper


def altered_predictions(predict):
    def wrapper(*args, **kwargs):
        pv = predict(*args, **kwargs)
        pv[:, 7] += 0.01
        return pv
    return wrapper


CASES = [
    ("pv2smiles-k2-b512", "spmm_tpu_torch.inference.pv2smiles", "_beam_batch",
     altered_tokens),
    ("pv2smiles-k2-b512", "spmm_tpu_torch.inference.pv2smiles", "_beam_batch",
     half_of_the_rows),
    ("rxn-beam-k5-b32", "spmm_tpu_torch.inference.rxn", "_beam_batch",
     altered_tokens),
    ("rxn-beam-k5-b32", "spmm_tpu_torch.inference.rxn", "_beam_batch",
     half_of_the_rows),
    ("smiles2pv-b128", "spmm_tpu_torch.inference.smiles2pv", "predict_pv",
     altered_predictions),
    ("smiles2pv-b128", "spmm_tpu_torch.inference.smiles2pv", "predict_pv",
     half_of_the_rows),
]


def drive(root, workload, capsys):
    rc = run.main(["--workload", workload, "--seed", SEED, "--seconds",
                   "0.3"], root=root, device=CPU)
    out = capsys.readouterr().out
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("workload,module,name,fault", CASES,
                         ids=[f"{c[0]}-{c[3].__name__}" for c in CASES])
def test_a_fault_is_not_correct(tmp_path, capsys, monkeypatch, workload,
                                module, name, fault):
    import importlib

    root = tiny_root(tmp_path)
    assert drive(root, workload, capsys)["correct"] is True
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    assert drive(root, workload, capsys)["correct"] is False


@pytest.mark.parametrize("workload", ["pv2smiles-k2-b512",
                                      "rxn-beam-k5-b32"])
def test_a_search_that_drops_the_summed_score_is_not_correct(
        tmp_path, capsys, workload):
    from portbench import calibrate

    root = tiny_root(tmp_path)
    assert drive(root, workload, capsys)["correct"] is True
    with calibrate.drop_score():
        line = drive(root, workload, capsys)
    assert line["correct"] is False
    assert line["checks"]["score_gap"]["value"] > \
        line["checks"]["score_gap"]["limit"]


CONTROLS = [("pv2smiles-k2-b512", "ref_fp8"), ("rxn-beam-k5-b32", "ref_fp8"),
            ("smiles2pv-b128", "tf32")]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,control", CONTROLS)
def test_the_control_is_not_correct_on_the_card(workload, control):
    """The control in the program's place, at the cell's own size, fails
    the cell's comparison: for the beam cells the reference in fp8 (its
    top k at each served position), for SMILES->PV the program with TF32
    products."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the controls run at the cell's size")
    from portbench import calibrate, traffic

    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    cell = run.cell_of(bench, workload)
    config = run.load_json(REPO, "portbench", "configs",
                           f"{cell['config']}.json")
    mix = run.load_json(REPO, "portbench", "traffic", f"{cell['traffic']}.json")
    driver_mod = run.load_module(REPO, "drivers", mix["driver"])
    checks = calibrate.readings(
        driver_mod.Driver(config, mix, 1234567, torch.device("cuda"), control),
        2, traffic)
    assert all(np.isfinite(value) for _, value, limit in checks
               if limit is not None)
    assert run.passes(checks) is False
