"""The harness on the CPU at tiny widths: the contract line, a cell, a
configuration, a traffic mix and a per-layer metric added as new files and
entries alone, and the refusal to run without a card.  These tests drive
the run on the CPU by handing it the device; the benchmark itself never
runs there."""

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.tests.tiny import REPO, edit, tiny_root

CPU = torch.device("cpu")
SEED = "3987654321"


def drive(root, workload, trace, capsys, seconds="0.5"):
    rc = run.main(["--workload", workload, "--seed", SEED, "--seconds",
                   seconds, "--trace", trace], root=root, device=CPU)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("workload", ["pv2smiles-k2-b512", "rxn-beam-k5-b32",
                                      "smiles2pv-b128"])
@pytest.mark.parametrize("trace", ["0", "1"])
def test_contract_line(tmp_path, capsys, workload, trace):
    root = tiny_root(tmp_path)
    rc, out, err = drive(root, workload, trace, capsys)
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    if trace == "0":
        rate = {"pv2smiles-k2-b512": "mol_per_s.pv2smiles",
                "rxn-beam-k5-b32": "mol_per_s.rxn",
                "smiles2pv-b128": "mol_per_s.smiles2pv"}[workload]
        assert set(line["metrics"]) == {rate, "setup_s"}
        assert line["metrics"][rate]["unit"] == "mol/s"
    else:
        allowed = {m["name"] for m in run.reported(bench["per_layer"],
                                                   workload)}
        assert set(line["metrics"]) <= allowed
        assert any(name.startswith("mfu.") for name in line["metrics"])
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    lines = err.strip().splitlines()
    assert all(lines[-len(line["checks"]) + j].startswith(f"check {name}:")
               for j, name in enumerate(line["checks"]))
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}


def tree_digest(top: str) -> dict:
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            if "__pycache__" not in d:
                path = os.path.join(d, f)
                out[os.path.relpath(path, top)] = hashlib.sha256(
                    open(path, "rb").read()).hexdigest()
    return out


def test_new_cell_config_traffic_and_metric_as_new_files(tmp_path, capsys):
    root = tiny_root(tmp_path)
    bench_dir = os.path.join(root, "portbench")
    before = tree_digest(bench_dir)
    configs = os.path.join(bench_dir, "configs")
    with open(os.path.join(configs, "spmm.json")) as f:
        small = json.load(f)
    small["text"].update(num_hidden_layers=2, fusion_layer=1)
    with open(os.path.join(configs, "spmm_shallow.json"), "w") as f:
        json.dump(small, f)
    with open(os.path.join(bench_dir, "traffic",
                           "pv2smiles-k2-b512.json")) as f:
        mix = json.load(f)
    mix.update(batch=2, k=3, max_steps=4)
    with open(os.path.join(bench_dir, "traffic", "pv2smiles-k3-b2.json"),
              "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench_dir, "metrics", "steps_a_batch.py"),
              "w") as f:
        f.write("def read(trace, works, cell):\n"
                "    return float(works[0]['steps'])\n")

    def register(bench):
        bench["configs"].append(dict(bench["configs"][0], name="spmm_shallow",
                                     file="portbench/configs/"
                                          "spmm_shallow.json"))
        bench["workloads"].append({"name": "pv2smiles-shallow-k3",
                                   "config": "spmm_shallow",
                                   "traffic": "pv2smiles-k3-b2", "chips": 1,
                                   "why": "a test cell"})
        bench["per_layer"].append({
            "name": "steps_a_batch", "unit": "steps", "better": "lower",
            "source": "program_counter", "layer": "decode runner",
            "moves": "mol_per_s.pv2smiles",
            "workloads": ["pv2smiles-shallow-k3"]})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in ("mol_per_s.pv2smiles", "mfu.pv2smiles"):
                m["workloads"].append("pv2smiles-shallow-k3")
        return bench

    edit(os.path.join(root, "BENCHMARK.json"), register)
    rc, out, err = drive(root, "pv2smiles-shallow-k3", "1", capsys)
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["metrics"]["steps_a_batch"]["value"] == 5.0
    assert line["correct"] is True
    rc, out, err = drive(root, "pv2smiles-shallow-k3", "0", capsys)
    assert rc == 0 and json.loads(out)["correct"] is True
    after = tree_digest(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "configs/spmm_shallow.json", "traffic/pv2smiles-k3-b2.json",
        "metrics/steps_a_batch.py"}


def test_same_seed_same_batches():
    from portbench import traffic

    mix = json.load(open(os.path.join(REPO, "portbench", "traffic",
                                      "smiles2pv-b128.json")))
    a, b = (traffic.make_batch(mix, 2 ** 31 + 11, traffic.WINDOW, 3)
            for _ in range(2))
    c = traffic.make_batch(mix, 2 ** 31 + 12, traffic.WINDOW, 3)
    assert (a["ids"] == b["ids"]).all() and not (a["ids"] == c["ids"]).all()
    assert sorted(a["lengths"]) == sorted(c["lengths"])   # the same work
    assert a["ids"].shape[1] == 100 and (a["ids"][a["mask"] == 0] == 0).all()


def test_refuses_without_a_card(tmp_path):
    """No card here: the command prints no result and exits non-zero, also
    in a directory that holds only BENCHMARK.json and portbench/."""
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(tmp_path, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    for cwd in (REPO, str(tmp_path)):
        out = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload",
             "smiles2pv-b128", "--seed", SEED, "--seconds", "1",
             "--trace", "0"], cwd=cwd, env=env, capture_output=True,
            text=True, timeout=300)
        assert out.returncode != 0 and out.stdout == ""
        assert "card" in out.stderr or "CUDA" in out.stderr


def test_refuses_without_the_program(tmp_path, monkeypatch):
    """Handed a device, a checkout without the program still refuses."""
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(tmp_path, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setitem(sys.modules, "spmm_tpu_torch", None)
    rc = run.main(["--workload", "smiles2pv-b128", "--seed", SEED,
                   "--seconds", "1"], root=str(tmp_path), device=CPU)
    assert rc != 0


NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$"
UNIT = r"^[A-Za-z0-9_/%.-]{1,16}$"


def test_benchmark_json_meets_the_contract():
    import re

    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert c["file"].startswith("portbench/") and c["reduced"] == []
    cells = {w["name"]: w for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert os.path.exists(os.path.join(
            REPO, "portbench", "traffic", f"{w['traffic']}.json"))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert re.match(NAME, m["name"]) and re.match(UNIT, m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert "bound" not in m and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        assert any(os.path.exists(os.path.join(
            REPO, "portbench", "metrics", f"{name}.py"))
            for name in (m["name"], m["name"].split(".")[0]))
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        names = {m["name"] for m in run.reported(bench["end_to_end"], cell)}
        assert "setup_s" in names and len(names) >= 2
        assert run.reported(bench["per_layer"], cell)
        mix = json.load(open(os.path.join(
            REPO, "portbench", "traffic", f"{cells[cell]['traffic']}.json")))
        assert mix["rate_metric"] in names
        assert all(v is not None for v in mix["limits"].values())
    assert len(json.dumps(bench)) <= 64 * 1024
