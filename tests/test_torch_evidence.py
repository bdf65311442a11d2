"""The port's evidence runs (scripts/torch_run_convergence.py,
scripts/torch_run_finetune_evidence.py) on the CPU at a tiny size:

- their data generators write the JAX scripts' files byte for byte (the
  JAX scripts are loaded by path: neither imports JAX);
- their gates, from hand-made metric streams: ok for falling losses and a
  contiguous resume, not ok for each failure alone;
- the whole chain in-process through the scripts' ``run`` seam, with tiny
  configs patched into the CLIs: pretrain 12 steps, resume from step 8,
  fine-tune both heads from the resumed run's step_12.pt; both summaries
  carry the JAX summaries' keys.
"""

import contextlib
import importlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from spmm_tpu_torch.configs import BertArchConfig as TorchCfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
TINY = dict(vocab_size=300, hidden_size=32, num_hidden_layers=4,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, type_vocab_size=2, fusion_layer=2,
            encoder_width=32)
TTEXT = TorchCfg(**TINY, add_cross_attention=True)
TPROP = TorchCfg(**{**TINY, "vocab_size": 1, "num_hidden_layers": 2},
                 add_cross_attention=False)
TENC = TorchCfg(**{**TINY, "num_hidden_layers": 2},
                add_cross_attention=False)


def load_script(name: str, alias: str):
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


conv = load_script("torch_run_convergence", "torch_run_convergence")
ft = load_script("torch_run_finetune_evidence", "torch_run_finetune_evidence")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread is several times faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree_bytes(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


# ---------------------------------------------------------------- (a) data


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("what", ["corpus", "rxn", "cls"])
def test_data_is_the_jax_scripts(tmp_path, what, seed):
    jax_conv = load_script("run_convergence", "jax_run_convergence")
    jax_ft = load_script("run_finetune_evidence", "jax_run_finetune_evidence")
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir()
    theirs.mkdir()
    if what == "corpus":
        got = conv.make_corpus(str(ours), n=20_000, seed=seed)
        want = jax_conv.make_corpus(str(theirs), n=20_000, seed=seed)
        assert [os.path.basename(p) for p in got] == \
            [os.path.basename(p) for p in want]
        with np.load(got[1]) as a, np.load(want[1]) as b:
            assert a["pv"].dtype == b["pv"].dtype == np.float32
            assert np.array_equal(a["pv"], b["pv"])
        paths = (got[0], want[0])
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            assert a.read() == b.read()
        return
    make = {"rxn": (ft.make_rxn_data, jax_ft.make_rxn_data),
            "cls": (ft.make_cls_data, jax_ft.make_cls_data)}[what]
    sizes = {"rxn": (1536, 48), "cls": (512, 128)}[what]
    make[0](str(ours), *sizes, seed=seed)
    make[1](str(theirs), *sizes, seed=seed)
    got, want = tree_bytes(ours), tree_bytes(theirs)
    assert got and got == want


# --------------------------------------------------------------- (b) gates


def stream(first_step: int, n: int, fall: dict | None = None) -> list:
    """n logged steps from ``first_step`` whose losses fall linearly by
    ``fall[key]`` nats over the run (1.0 where not given)."""
    fall = fall or {}
    start = {"loss_mlm": 5.0, "loss_mpm": 30.0, "loss_ita": 11.0,
             "loss_itm": 0.7}
    return [{"step": first_step + i,
             **{k: v - fall.get(k, 1.0) * i / max(n - 1, 1)
                for k, v in start.items()}} for i in range(n)]


def convergence_case(case: str, steps: int = 900) -> dict:
    ma = stream(1, steps, {"loss_ita": 6.0})
    mb = stream(2 * (steps // 3) + 1, steps - 2 * (steps // 3))
    if case.startswith("rises_"):
        key = case[len("rises_"):]
        ma = stream(1, steps, {"loss_ita": 6.0, key: -0.5})
    elif case == "gap":
        mb = mb[:10] + mb[11:]
    elif case == "late_start":
        mb = mb[1:]
    elif case == "early_start":
        mb = stream(2 * (steps // 3), len(mb))
    elif case == "small_ita_fall":
        ma = stream(1, steps, {"loss_ita": 1.4})
    elif case == "no_phase_b":
        mb = []
    return conv.convergence_summary(ma, mb, steps, 32)


def test_convergence_gates_pass_falling_losses_and_a_clean_resume():
    s = convergence_case("ok")
    assert s["ok"] and s["ita_gate"] is True
    assert s["resume_from_step"] == 600 and \
        s["resume_first_logged_step"] == 601
    assert s["resume_steps_contiguous"] and all(s["decreased"].values())
    # a linear fall of 6 nats over steps 0..899: windows 20 steps wide
    assert s["ita_drop_nats"] == pytest.approx(6.0 * 880 / 899)
    # below 600 steps a small ITA fall is not gated
    short = conv.convergence_summary(stream(1, 300, {"loss_ita": 0.5}),
                                     stream(201, 100), 300, 32)
    assert short["ok"] and isinstance(short["ita_gate"], str)


@pytest.mark.parametrize("case", [
    "rises_loss_mlm", "rises_loss_mpm", "rises_loss_ita", "rises_loss_itm",
    "gap", "late_start", "early_start", "small_ita_fall", "no_phase_b"])
def test_convergence_gates_fail_each_fault_alone(case):
    s = convergence_case(case)
    assert s["ok"] is False
    if case.startswith("rises_"):
        assert [k for k, v in s["decreased"].items() if not v] == \
            [case[len("rises_"):]]
    if case == "small_ita_fall":
        assert s["ita_gate"] is False and all(s["decreased"].values())


def test_window_means_use_half_of_a_short_run():
    records = stream(1, 10)
    first = conv.window_means(records, ["loss_mlm"])
    assert first["loss_mlm"] == pytest.approx(
        np.mean([r["loss_mlm"] for r in records[:5]]))
    assert conv.window_means(records[:1], ["loss_mlm"])["loss_mlm"] == 5.0


RXN_OK = {"best_valid_acc": 1.0, "best_test_acc": 0.9, "epochs": []}
CLS_OK = {"best_valid": 0.95, "best_test": 0.9, "epochs": []}


@pytest.mark.parametrize("case,ok", [
    ("ok", True), ("rxn_loss_rises", False), ("cls_loss_rises", False),
    ("exact_match_0", False), ("auroc_0.7", False)])
def test_finetune_gates(case, ok):
    rxn_losses, cls_losses = (4.5, 0.01, 576), (0.64, 0.003, 96)
    rxn, cls = dict(RXN_OK), dict(CLS_OK)
    if case == "rxn_loss_rises":
        rxn_losses = (4.5, 4.6, 576)
    elif case == "cls_loss_rises":
        cls_losses = (0.64, 0.7, 96)
    elif case == "exact_match_0":
        rxn["best_test_acc"] = 0.0
    elif case == "auroc_0.7":
        cls["best_test"] = 0.7
    s = ft.finetune_summary(rxn_losses, rxn, cls_losses, cls)
    assert s["ok"] is ok
    assert s["rxn"]["best_test_exact_match"] == rxn["best_test_acc"]
    assert s["classification"]["best_test_auroc"] == cls["best_test"]


def test_find_pretrain_ckpt_takes_the_newest_of_phase_b(tmp_path):
    assert ft.find_pretrain_ckpt(str(tmp_path)) is None
    for phase, steps in (("phaseA", (4, 8, 12)), ("phaseB", (9, 10))):
        (tmp_path / phase).mkdir()
        for s in steps:
            (tmp_path / phase / f"step_{s}.pt").write_bytes(b"")
    assert ft.find_pretrain_ckpt(str(tmp_path)) == str(
        tmp_path / "phaseB" / "step_10.pt")


# ------------------------------------------------------ (c) the whole chain


@pytest.fixture
def tiny_clis(monkeypatch):
    from spmm_tpu_torch.cli import _finetune_driver
    from spmm_tpu_torch.cli import pretrain as pretrain_cli
    from spmm_tpu_torch.models.rxn import Rxn

    monkeypatch.setattr(pretrain_cli, "text_config", lambda: TTEXT)
    monkeypatch.setattr(pretrain_cli, "property_config", lambda: TPROP)
    monkeypatch.setattr(_finetune_driver, "text_config", lambda: TTEXT)
    real = Rxn.random_init.__func__
    monkeypatch.setattr(Rxn, "random_init", classmethod(
        lambda cls, seed, device=None: real(cls, seed, TTEXT, TENC,
                                            device=device)))


def in_process(module: str, argv: list) -> str:
    """The seam: the CLI's main in this process, its output returned."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        importlib.import_module(module).main(argv)
    return buf.getvalue()


def test_the_chain_runs_in_process(tmp_path, tiny_clis):
    evidence = tmp_path / "evidence"
    conv_dir = tmp_path / "convergence"
    s = conv.convergence(conv.parse_args([
        "--steps", "12", "--batch_size", "8", "--device", "cpu",
        "--workdir", str(conv_dir), "--evidence_dir", str(evidence)]),
        run=in_process)
    assert s["resume_from_step"] == 8
    assert s["resume_first_logged_step"] == 9 and s["resume_steps_contiguous"]
    phase_a = conv.load_metrics(evidence / "torch_metrics_phaseA.jsonl")
    phase_b = conv.load_metrics(evidence / "torch_metrics_phaseB.jsonl")
    assert [m["step"] for m in phase_a] == list(range(1, 13))
    assert [m["step"] for m in phase_b] == [9, 10, 11, 12]
    assert sorted(os.listdir(conv_dir / "phaseA")) == [
        "metrics.jsonl", "run_meta.json", "step_12.pt", "step_4.pt",
        "step_8.pt"]
    with open(os.path.join(REPO, "evidence", "convergence_summary.json")) as f:
        jax_keys = set(json.load(f))
    assert jax_keys <= set(s) and s["device"] == "cpu"
    assert {"card", "power_limit", "torch", "cuda", "wall_s",
            "samples_per_s"} <= set(s)
    assert set(s["wall_s"]) == {"phaseA", "phaseB"}
    assert json.loads((evidence / "torch_convergence_summary.json")
                      .read_text()) == json.loads(json.dumps(s))

    f = ft.finetune(ft.parse_args([
        "--device", "cpu", "--rxn_epochs", "1", "--cls_epochs", "1",
        "--workdir", str(tmp_path / "finetune"),
        "--convergence_workdir", str(conv_dir),
        "--evidence_dir", str(evidence)]), run=in_process)
    assert f["pretrain_ckpt_source"] == "convergence_run"
    assert f["pretrain_ckpt"] == str(conv_dir / "phaseB" / "step_12.pt")
    with open(os.path.join(REPO, "evidence", "finetune_summary.json")) as fh:
        jax_summary = json.load(fh)
    assert set(jax_summary) - {"donate"} <= set(f) and "donate" not in f
    for part in ("rxn", "classification"):
        assert set(jax_summary[part]) <= set(f[part])
        assert len(f[part]["epochs"]) == 1
        assert np.isfinite(f[part]["loss_first20_mean"])
    assert f["rxn"]["steps"] == 1536 // 16
    assert f["classification"]["steps"] == 512 // 16
    assert isinstance(f["rxn"]["seed"], int)
    assert set(f["wall_s"]) == {"rxn", "classification"}
    for name in ("torch_metrics_rxn_finetune.jsonl",
                 "torch_metrics_cls_finetune.jsonl",
                 "torch_finetune_summary.json"):
        assert (evidence / name).is_file()
