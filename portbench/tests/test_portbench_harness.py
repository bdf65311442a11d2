"""The harness on the CPU at tiny widths: the contract line, a cell, a
configuration, a traffic mix and a per-layer metric added as new files and
entries alone, a configuration cut to one chip's share added so, a second
language model with a reference module of its own added so, the refusal to
run without a card, and ``BENCHMARK.json``'s contract
(``contract_errors``), which refuses each wrong cut with its own message.
These tests drive the run on the CPU by handing it the device; the
benchmark itself never runs there."""

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.experts import EXPERTS
from portbench.tests import moonlight
from portbench.tests.tiny import (
    LM_CELL, LM_CONFIG, LM_TINY_TRAFFIC, REPO, edit, lm_tiny, tiny_root)

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
# the keys that a cut to one chip's share may change (model-configs, section
# 4): the routed experts held here, the depth and the vocabulary; never a
# width, a head count or size, an expert's width or experts per token
CUT_KEYS = EXPERTS + ("num_hidden_layers", "vocab_size")
MIN_EXPERTS = 8
VOCAB_SHARE = 8          # at least an eighth of the vocabulary
MIN_LAYERS_PAST_DENSE = 4


def cut_errors(name: str, reduced: list, cfg: dict) -> list[str]:
    """What keeps ``cfg`` (configuration ``name``, its file's dict) from
    being a cut to one chip's share of a stated deployment."""
    out = []
    published = cfg.get("published")
    if not reduced:
        if published is not None:
            out.append(f"config {name}: nothing cut, yet a published object")
        return out
    if not isinstance(published, dict):
        return [f"config {name}: cut, but no published object"]
    for key in reduced:
        if key not in CUT_KEYS:
            out.append(f"config {name}: {key} is cut, and a cut may change "
                       f"only {', '.join(CUT_KEYS)}")
        elif key not in cfg:
            out.append(f"config {name}: cut key {key} is not in the file")
        elif key not in published:
            out.append(f"config {name}: cut key {key} has no published value")
        elif published[key] == cfg[key]:
            out.append(f"config {name}: {key} is {cfg[key]}, its published "
                       "value: not cut")
    for key in sorted(set(published) - set(reduced)):
        out.append(f"config {name}: published {key} is not in reduced")
    deployment = cfg.get("deployment")
    if not (isinstance(deployment, str) and deployment.strip()):
        out.append(f"config {name}: cut, but no deployment that says over "
                   "how many chips each layer is divided, and how")

    def cut(key):
        return key in reduced and key in cfg and key in published

    for key in EXPERTS:
        if cut(key):
            held, whole = cfg[key], published[key]
            if held < MIN_EXPERTS:
                out.append(f"config {name}: {held} experts held, under "
                           f"{MIN_EXPERTS}")
            elif whole % held:
                out.append(f"config {name}: {held} experts held do not "
                           f"divide the published {whole}")
    if cut("vocab_size"):
        least = -(-published["vocab_size"] // VOCAB_SHARE)
        if cfg["vocab_size"] < least:
            out.append(f"config {name}: vocabulary {cfg['vocab_size']}, "
                       f"under an eighth of {published['vocab_size']}")
    if cut("num_hidden_layers"):
        least = cfg.get("first_k_dense_replace", 0) + MIN_LAYERS_PAST_DENSE
        if cfg["num_hidden_layers"] < least:
            out.append(f"config {name}: {cfg['num_hidden_layers']} layers, "
                       f"under the leading dense ones and "
                       f"{MIN_LAYERS_PAST_DENSE} more ({least})")
    return out


def contract_errors(bench: dict, root: str) -> list[str]:
    """Each way in which ``bench`` (``BENCHMARK.json``'s dict, its files
    under ``root``) breaks the benchmark's contract, one message each."""
    import re

    out = []

    def need(ok, msg):
        if not ok:
            out.append(msg)

    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    need(set(bench) == keys, f"top-level keys {sorted(bench)}")
    need(bench.get("paths") == ["portbench"], "paths is not [portbench]")
    seconds = bench.get("run_seconds", 0)
    need(1 <= seconds <= 51, f"run_seconds {seconds} outside 1-51")
    runs = 2 + 14 * 24
    need(runs * (seconds + 60) + 24 * 180 + 1200 <= 43200,
         f"run_seconds {seconds}: a full check of 24 cells overruns")
    configs = {c["name"]: c for c in bench.get("configs", [])}
    for c in bench.get("configs", []):
        name = c["name"]
        need(set(c) == {"name", "source", "file", "reduced", "why"},
             f"config {name}: keys {sorted(c)}")
        path = os.path.join(root, c["file"])
        need(os.path.exists(path), f"config {name}: no file {c['file']}")
        need(c["file"].startswith("portbench/"),
             f"config {name}: file {c['file']} outside portbench/")
        if os.path.exists(path):
            with open(path) as f:
                cfg = json.load(f)
            out += cut_errors(name, c["reduced"], cfg)
            ref = cfg.get("reference")
            need(ref and os.path.exists(os.path.join(root, ref)),
                 f"config {name}: no reference {ref}")
    workloads = bench.get("workloads", [])
    cells = {w["name"]: w for w in workloads}
    for w in workloads:
        name = w["name"]
        need(set(w) == {"name", "config", "traffic", "chips", "why"},
             f"cell {name}: keys {sorted(w)}")
        need(w["config"] in configs, f"cell {name}: no config {w['config']}")
        need(w["chips"] in (1, 4), f"cell {name}: chips {w['chips']}")
        need(len(w["why"]) <= 200 and "\n" not in w["why"],
             f"cell {name}: why longer than 200 or on two lines")
        need(os.path.exists(os.path.join(
            root, "portbench", "traffic", f"{w['traffic']}.json")),
            f"cell {name}: no traffic {w['traffic']}")
    four = sum(w["chips"] == 4 for w in workloads)
    most = max(1, len(workloads) // 4)
    need(four <= most, f"{four} four-chip cells of {len(workloads)}: at most "
                       f"{most}")
    e2e = {m["name"]: m for m in bench.get("end_to_end", [])}
    need(e2e.get("setup_s", {}).get("bound") == 0.25,
         "setup_s is missing or its bound is not 0.25")
    for m in bench.get("end_to_end", []) + bench.get("per_layer", []):
        name = m["name"]
        need(re.match(NAME, name), f"metric {name}: not a name")
        need(re.match(UNIT, m["unit"]), f"metric {name}: unit {m['unit']}")
        need(m["better"] in ("lower", "higher"),
             f"metric {name}: better {m['better']}")
        need(set(m.get("workloads", cells)) <= set(cells),
             f"metric {name}: names a cell that is not there")
    for m in bench.get("end_to_end", []):
        name = m["name"]
        need(m["source"] in ("host_clock", "device_trace"),
             f"metric {name}: source {m['source']}")
        need(0.01 <= m.get("bound", 0) <= 0.25,
             f"metric {name}: bound outside 0.01-0.25")
    for m in bench.get("per_layer", []):
        name = m["name"]
        need("bound" not in m, f"metric {name}: a per-layer bound")
        need(m["moves"] in e2e, f"metric {name}: moves {m['moves']}")
        need("workloads" in m, f"metric {name}: no workloads")
        for cell in m.get("workloads", []) if m["moves"] in e2e else []:
            need(cell in e2e[m["moves"]].get("workloads", [cell]),
                 f"metric {name}: cell {cell} does not report "
                 f"{m['moves']}")
        need(any(os.path.exists(os.path.join(
            root, "portbench", "metrics", f"{base}.py"))
            for base in (name, name.split(".")[0])),
            f"metric {name}: no reader")
    layers = {}
    for m in bench.get("per_layer", []):
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for base, names in layers.items():
        need(len(names) == 1, f"metrics {base}.*: layers {sorted(names)}")
    for cell, w in cells.items():
        names = {m["name"] for m in run.reported(bench["end_to_end"], cell)}
        need("setup_s" in names and len(names) >= 2,
             f"cell {cell}: end-to-end metrics {sorted(names)}")
        need(run.reported(bench["per_layer"], cell),
             f"cell {cell}: no per-layer metric")
        path = os.path.join(root, "portbench", "traffic",
                            f"{w['traffic']}.json")
        if os.path.exists(path):
            with open(path) as f:
                mix = json.load(f)
            rates = sorted(m["name"] for m in run.reported(
                bench["end_to_end"], cell)
                if m["name"] != "setup_s" and m["unit"].endswith("/s"))
            need(rates == [mix["rate_metric"]],
                 f"cell {cell}: rates {rates}, where its traffic's is "
                 f"{mix['rate_metric']} alone")
            need(all(v is not None for v in mix["limits"].values()),
                 f"cell {cell}: a limit of None")
    need(len(json.dumps(bench)) <= 64 * 1024, "BENCHMARK.json over 64 KiB")
    return out


def test_benchmark_json_meets_the_contract():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert contract_errors(bench, REPO) == []


def test_moonlight_entries_by_name():
    moonlight.check_entries(REPO)


# ---- a configuration cut to one chip's share ----

CUT = "depth5"
CUT_CONFIG, CUT_CELL = f"moonlight-{CUT}", f"moonlight-{CUT}-turn4"
# 5 of the published 27 layers: the dense one and 4 expert layers
DEPTH_CUT = {"num_hidden_layers": 5, "published": {"num_hidden_layers": 27},
             "deployment": "layers 1-5 of 27 on this chip, whole: the rest "
                           "are further stages of a pipeline"}


def add_lm_cell(root: str, name: str, cell: str, suffix: str, cfg: dict,
                reduced: list, bases=None) -> None:
    """Add to the tiny copy at ``root``, as new files and entries alone, a
    language model's configuration ``name`` (``cfg``; its entry M's with
    ``reduced``), its traffic (M's at tiny sizes), ``cell`` over them under
    M's rate, and the cell's per-layer entries ``<base>.<suffix>``, copied
    from M's for each of ``bases`` (all of M's by default)."""
    bench_dir = os.path.join(root, "portbench")
    with open(os.path.join(bench_dir, "configs", f"{name}.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench_dir, "traffic", f"{LM_CELL}.json")) as f:
        mix = dict(json.load(f), **LM_TINY_TRAFFIC)
    with open(os.path.join(bench_dir, "traffic", f"{cell}.json"), "w") as f:
        json.dump(mix, f)

    def register(bench):
        entry = next(c for c in bench["configs"] if c["name"] == LM_CONFIG)
        bench["configs"].append(dict(
            entry, name=name, reduced=reduced,
            file=f"portbench/configs/{name}.json"))
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": cell, "chips": 1,
                                   "why": "a test cell"})
        for m in bench["end_to_end"]:
            if LM_CELL in m.get("workloads", ()):
                m["workloads"].append(cell)
        for m in list(bench["per_layer"]):
            base = m["name"].split(".")[0]
            if m.get("workloads") == [LM_CELL] and base in (bases or [base]):
                bench["per_layer"].append(
                    dict(m, name=f"{base}.{suffix}", workloads=[cell]))
        return bench

    edit(os.path.join(root, "BENCHMARK.json"), register)


def add_cut_cell(root: str) -> None:
    """A depth cut of the latent MoE configuration at tiny widths, its
    traffic, a cell over them and all of M's per-layer entries for it."""
    add_lm_cell(root, CUT_CONFIG, CUT_CELL, CUT, lm_tiny(**DEPTH_CUT),
                ["num_hidden_layers"])


def test_a_cut_configuration_as_new_files_and_entries(tmp_path, capsys):
    root = tiny_root(tmp_path)
    bench_dir = os.path.join(root, "portbench")
    before = tree_digest(bench_dir)
    add_cut_cell(root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        assert contract_errors(json.load(f), root) == []
    lines = {}
    for trace in ("0", "1"):
        rc, out, err = drive(root, CUT_CELL, trace, capsys)
        assert rc == 0, err
        lines[trace] = json.loads(out.strip().splitlines()[-1])
        assert lines[trace]["correct"] is True
        assert lines[trace]["failed"] == 0
    assert set(lines["0"]["metrics"]) == {"mol_per_s.pv2smiles", "setup_s"}
    assert f"mfu.{CUT}" in lines["1"]["metrics"]
    after = tree_digest(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {f"configs/{CUT_CONFIG}.json",
                                        f"traffic/{CUT_CELL}.json"}


# ---- a second language model, with a reference module of its own ----

SECOND = "second"
SECOND_CONFIG, SECOND_CELL = "second-lm", "second-lm-turn4"
SECOND_REFERENCE = "portbench/reference/second_lm.py"


def test_a_second_language_model_as_new_files_and_entries(tmp_path, capsys):
    """A language model after M whose configuration names a reference
    module of its own (here one that gives latent_moe.py's interface),
    added as new files and entries alone: the contract holds, M's entries
    stand as they were, and the LM turn driver runs the cell ``correct``
    through the module that its configuration names."""
    root = tiny_root(tmp_path)
    bench_dir = os.path.join(root, "portbench")
    before = tree_digest(bench_dir)
    with open(os.path.join(root, SECOND_REFERENCE), "w") as f:
        f.write('"""A second language model\'s reference."""\n\n'
                "from portbench.reference.latent_moe import (  # noqa: F401\n"
                "    Reference, make_tensor, tensor_kinds, work)\n")
    add_lm_cell(root, SECOND_CONFIG, SECOND_CELL, SECOND,
                lm_tiny(**DEPTH_CUT, reference=SECOND_REFERENCE),
                ["num_hidden_layers"], bases=["mfu"])
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        assert contract_errors(json.load(f), root) == []
    moonlight.check_entries(root)
    lines = {}
    for trace in ("0", "1"):
        rc, out, err = drive(root, SECOND_CELL, trace, capsys)
        assert rc == 0, err
        lines[trace] = json.loads(out.strip().splitlines()[-1])
        assert lines[trace]["correct"] is True
        assert lines[trace]["failed"] == 0
    assert set(lines["0"]["metrics"]) == {"mol_per_s.pv2smiles", "setup_s"}
    assert set(lines["1"]["metrics"]) == {f"mfu.{SECOND}"}
    cfg = run.load_json(root, "portbench", "configs", f"{SECOND_CONFIG}.json")
    mix = run.load_json(root, "portbench", "traffic", f"{SECOND_CELL}.json")
    driver = run.load_module(root, "drivers", "lm_turn").Driver(
        cfg, mix, 1, CPU)
    assert driver.reference.__file__ == os.path.join(root, SECOND_REFERENCE)
    after = tree_digest(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        f"configs/{SECOND_CONFIG}.json", f"traffic/{SECOND_CELL}.json",
        "reference/second_lm.py"}


@pytest.mark.parametrize("rates", [
    ["mol_per_s.pv2smiles", "mol_per_s.rxn"], ["mol_per_s.rxn"]],
    ids=["a second rate", "another rate"])
def test_the_contract_holds_a_cell_to_its_traffics_rate(tmp_path, rates):
    root = tiny_root(tmp_path)
    add_cut_cell(root)

    def move(bench):
        for m in bench["end_to_end"]:
            if "workloads" in m:
                m["workloads"] = [w for w in m["workloads"] if w != CUT_CELL]
                if m["name"] in rates:
                    m["workloads"].append(CUT_CELL)
        return bench

    edit(os.path.join(root, "BENCHMARK.json"), move)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        errors = contract_errors(json.load(f), root)
    assert (f"cell {CUT_CELL}: rates {rates}, where its traffic's is "
            "mol_per_s.pv2smiles alone") in errors


def test_the_contract_refuses_a_configuration_without_its_reference(
        tmp_path):
    root = tiny_root(tmp_path)
    add_cut_cell(root)
    edit(os.path.join(root, "portbench", "configs", f"{CUT_CONFIG}.json"),
         lambda c: dict(c, reference="portbench/reference/absent.py"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        errors = contract_errors(json.load(f), root)
    assert errors == [f"config {CUT_CONFIG}: no reference "
                      "portbench/reference/absent.py"]


def _cut(entry, cfg, key, kept, published):
    cfg[key], cfg["published"][key] = kept, published
    entry["reduced"].append(key)


# one change at a time to the cut configuration, and the error it earns
MUTATIONS = {
    "a width cut": (lambda bench, entry, cfg: _cut(
        entry, cfg, "hidden_size", 64, 2048),
        "hidden_size is cut, and a cut may change only"),
    "no published value": (lambda bench, entry, cfg: entry["reduced"].append(
        "vocab_size"), "cut key vocab_size has no published value"),
    "the published value kept": (lambda bench, entry, cfg: cfg[
        "published"].update(num_hidden_layers=5),
        "num_hidden_layers is 5, its published value: not cut"),
    "no deployment": (lambda bench, entry, cfg: cfg.pop("deployment"),
                      "no deployment"),
    "4 experts held": (lambda bench, entry, cfg: _cut(
        entry, cfg, "n_routed_experts", 4, 8), "4 experts held, under 8"),
    "48 held of 100": (lambda bench, entry, cfg: _cut(
        entry, cfg, "n_routed_experts", 48, 100),
        "48 experts held do not divide the published 100"),
    "under an eighth of the vocabulary": (lambda bench, entry, cfg: _cut(
        entry, cfg, "vocab_size", 97, 1000),
        "vocabulary 97, under an eighth of 1000"),
    "4 layers": (lambda bench, entry, cfg: cfg.update(num_hidden_layers=4),
                 "4 layers, under the leading dense ones and 4 more (5)"),
    "two four-chip cells of 5": (lambda bench, entry, cfg: [
        w.update(chips=4) for w in bench["workloads"][-2:]],
        "2 four-chip cells of 5: at most 1"),
}


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_the_contract_refuses_a_wrong_cut(tmp_path, mutation):
    root = tiny_root(tmp_path)
    add_cut_cell(root)
    change, message = MUTATIONS[mutation]
    cfg_path = os.path.join(root, "portbench", "configs",
                            f"{CUT_CONFIG}.json")

    def mutate(bench):
        entry = next(c for c in bench["configs"] if c["name"] == CUT_CONFIG)
        with open(cfg_path) as f:
            cfg = json.load(f)
        change(bench, entry, cfg)
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        return bench

    edit(os.path.join(root, "BENCHMARK.json"), mutate)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        errors = contract_errors(json.load(f), root)
    assert len(errors) == 1 and message in errors[0], errors
