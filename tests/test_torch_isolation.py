"""Port boundary: spmm_tpu_torch and the port's scripts (scripts/torch_*.py,
chip_smoke.py) import neither jax nor anything of spmm_tpu, nor pandas,
sklearn, optax or orbax (the GPU machine has none of them; RDKit only
behind chem.featurizer's guard), and their entry points never drop to the
CPU unasked."""

import ast
import glob
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "spmm_tpu_torch")


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith(("jax.", "jaxlib"))
            or name == "spmm_tpu" or name.startswith("spmm_tpu."))


# absent where the port runs: no module may need them
_ABSENT = ("pandas", "sklearn", "optax", "orbax")


def _modules() -> list[str]:
    import spmm_tpu_torch

    return ["spmm_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(spmm_tpu_torch.__path__,
                                              "spmm_tpu_torch.")]


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    assert "spmm_tpu_torch.ops.decode_attention" in mods
    assert "spmm_tpu_torch.ops.fused_attention" in mods
    assert "spmm_tpu_torch.cli.smiles2pv" in mods
    for new in ("models.rxn", "inference.rxn", "cli.rxn_prediction",
                "cli.pv2smiles_single", "cli.pv2smiles_batched",
                "models.downstream", "training.finetune", "training.schedules",
                "data.pipeline", "utils.logging", "cli._finetune_driver",
                "cli.classification", "cli.classification_multilabel",
                "cli.regression", "training.pretrain", "checkpoint.io",
                "utils.profiling", "cli.pretrain", "cli.convert_checkpoint",
                "parallel.mesh", "parallel.multihost", "training.optim",
                "parallel.tp", "parallel.sp", "parallel.fsdp",
                "parallel.replicas", "models.introspect", "parallel.pp",
                "parallel.ep", "parallel.dryrun", "ops._host_build"):
        assert f"spmm_tpu_torch.{new}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith(('jax.', 'jaxlib')) or n == 'spmm_tpu' or "
        "n.startswith('spmm_tpu.') or "
        f"n.split('.')[0] in {_ABSENT!r})\n"
        "assert not bad, bad\n"
        "import spmm_tpu_torch.tokenizer as tok\n"
        "assert not tok._native_build, 'importing built the tokenizer'\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_replica_workers_load_no_jax():
    """The worker processes of ``parallel.replicas`` (spawned; entry
    ``replicas._serve``) load neither jax nor spmm_tpu: a fresh interpreter
    starts a worker and asks it what it has loaded, after a call."""
    from spmm_tpu_torch.parallel import replicas

    assert replicas._serve.__module__ in _modules()
    code = (
        "import torch\n"
        "import torch_replica_fns as fns\n"
        "from spmm_tpu_torch.parallel.replicas import Replicas\n"
        "with Replicas(torch.nn.Linear(2, 2), ['cpu']) as reps:\n"
        "    print(reps.map(fns.forbidden_modules, torch.zeros(1, 2)))\n"
        "print(fns.forbidden_modules(None, None, None, None))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([REPO, os.path.join(REPO, "tests")])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == ["[[]]", "[]"]


def _offending_imports(path: str, rdkit_ok: bool = False) -> list:
    """(path, name) of each import statement in ``path`` that names jax,
    spmm_tpu or a package absent where the port runs; rdkit too unless
    ``rdkit_ok``."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    offenders = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        offenders += [(path, n) for n in names if _forbidden(n)
                      or n.split(".")[0] in _ABSENT]
        if not rdkit_ok:
            offenders += [(path, n) for n in names
                          if n.split(".")[0] == "rdkit"]
    return offenders


def test_no_import_statement_names_jax_or_spmm_tpu():
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            offenders += _offending_imports(path, rdkit_ok=path.endswith((
                os.path.join("chem", "featurizer.py"),
                os.path.join("data", "datasets.py"))))
    assert not offenders


# the port's scripts beside the package: the evidence runs and the smoke run
PORT_SCRIPTS = sorted(
    [os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "scripts", "torch_*.py"))] + ["chip_smoke.py"])


@pytest.mark.parametrize("script", PORT_SCRIPTS)
def test_port_scripts_import_no_jax_or_spmm_tpu(script):
    assert not _offending_imports(os.path.join(REPO, script))


def test_port_scripts_are_listed():
    assert {"scripts/torch_run_convergence.py",
            "scripts/torch_run_finetune_evidence.py",
            "chip_smoke.py"} <= set(PORT_SCRIPTS)


@pytest.mark.parametrize("script", ["torch_run_convergence",
                                    "torch_run_finetune_evidence"])
def test_evidence_scripts_need_a_gpu_unless_told_otherwise(tmp_path, script):
    """Both evidence scripts raise without a GPU before they write a file,
    unless given --device cpu."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        script, os.path.join(REPO, "scripts", f"{script}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)

    def no_cli(module_name, argv):
        raise AssertionError(f"{module_name} ran")

    work = tmp_path / "work"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(["--workdir", str(work), "--evidence_dir",
                     str(tmp_path / "evidence")], run=no_cli)
    assert not work.exists() and not (tmp_path / "evidence").exists()


def test_entry_points_need_a_gpu_unless_told_otherwise():
    """Without device=..., an entry point runs on cuda; with no GPU it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from spmm_tpu_torch.chem.normalize import PropertyStats
    from spmm_tpu_torch.cli.smiles2pv import pv_generate
    from spmm_tpu_torch.configs import BertArchConfig
    from spmm_tpu_torch.inference.pv2smiles import (
        generate_batched, generate_with_property)
    from spmm_tpu_torch.inference.smiles2pv import predict_pv
    from spmm_tpu_torch.models.spmm import SPMM
    from spmm_tpu_torch.serving import Pv2SmilesService, Smiles2PvService
    from spmm_tpu_torch.tokenizer import SmilesTokenizer

    tc = BertArchConfig(hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=1, intermediate_size=32,
                        fusion_layer=1, encoder_width=32)
    pc = BertArchConfig(vocab_size=1, hidden_size=32, num_hidden_layers=1,
                        num_attention_heads=1, intermediate_size=32,
                        fusion_layer=1, add_cross_attention=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SPMM.random_init(0, tc, pc)
    model = SPMM.random_init(0, tc, pc, device="cpu")
    tok = SmilesTokenizer()
    pvs = np.zeros((1, 53), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_batched(model, tok, pvs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_with_property(model, tok, pvs[0], pvs[0], n_generate=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pv2SmilesService(model, tok)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Smiles2PvService(model, tok)
    ids, mask = tok.encode_batch(["[CLS]CCO"], max_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict_pv(model, ids, mask)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pv_generate(model, tok, ["CCO"], PropertyStats.load())
    # a model on one device and a call for another: refused, not moved
    with pytest.raises(ValueError, match="is on"):
        generate_batched(model, tok, pvs, device="meta")
    with pytest.raises(ValueError, match="is on"):
        predict_pv(model, ids, mask, device="meta")
    from spmm_tpu_torch.parallel.ep import init_moe_params

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_moe_params(0, tc, 4)


def test_bench_needs_a_gpu_unless_told_otherwise():
    """``python -m spmm_tpu_torch.bench`` with no GPU and no --device cpu
    exits non-zero before it prints any line."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-m", "spmm_tpu_torch.bench"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == "" and "device='cpu'" in proc.stderr


def test_bench_is_held_by_the_import_scans():
    """The bench is a module of the package, so both scans above cover it:
    the import check imports it and the AST scan reads it."""
    assert "spmm_tpu_torch.bench" in _modules()
    path = os.path.join(PKG, "bench.py")
    walked = [os.path.join(root, f) for root, _, files in os.walk(PKG)
              for f in files]
    assert path in walked and not _offending_imports(path)


def test_rxn_entry_points_need_a_gpu_unless_told_otherwise(tmp_path):
    """Reaction prediction and the three file CLIs: cuda by default,
    raising without a GPU before they read any file."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from spmm_tpu_torch.cli import (
        pv2smiles_batched, pv2smiles_single, rxn_prediction)
    from spmm_tpu_torch.configs import BertArchConfig
    from spmm_tpu_torch.inference.rxn import predict_beam, predict_greedy
    from spmm_tpu_torch.models.rxn import Rxn
    from spmm_tpu_torch.tokenizer import SmilesTokenizer

    dc = BertArchConfig(hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=1, intermediate_size=32,
                        fusion_layer=1, encoder_width=32)
    ec = BertArchConfig(hidden_size=32, num_hidden_layers=1,
                        num_attention_heads=1, intermediate_size=32,
                        fusion_layer=1, add_cross_attention=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Rxn.random_init(0, dc, ec)
    model = Rxn.random_init(0, dc, ec, device="cpu")
    tok = SmilesTokenizer()
    for fn in (predict_greedy, predict_beam):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(model, tok, ["CCO"])
        with pytest.raises(ValueError, match="is on"):
            fn(model, tok, ["CCO"], device="meta")
        assert len(fn(model, tok, ["CCO"], device="cpu")) == 1
    missing = str(tmp_path / "missing")
    for argv, cli in (
            (["--evaluate", "--data_dir", missing], rxn_prediction),
            (["--data_dir", missing], rxn_prediction),
            (["--checkpoint", missing], pv2smiles_single),
            (["--checkpoint", missing, "--input_file", missing,
              "--property_cache", missing], pv2smiles_batched)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)


@pytest.mark.parametrize("cli_name", ["classification",
                                      "classification_multilabel",
                                      "regression"])
def test_finetune_clis_need_a_gpu_unless_told_otherwise(tmp_path, cli_name):
    """The MoleculeNet fine-tune CLIs: cuda by default, raising without a
    GPU before they read any file."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    import importlib

    from spmm_tpu_torch.models.downstream import Downstream

    cli = importlib.import_module(f"spmm_tpu_torch.cli.{cli_name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--data_dir", str(tmp_path / "missing")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Downstream.random_init(0, "classification")


def test_pretraining_needs_a_gpu_unless_told_otherwise(tmp_path):
    """Pretraining: cuda by default, raising without a GPU before it reads
    any file."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from spmm_tpu_torch.cli import pretrain as cli
    from spmm_tpu_torch.configs import BertArchConfig, PretrainConfig
    from spmm_tpu_torch.training.pretrain import init_pretrain_state

    missing = str(tmp_path / "missing")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--data_path", missing, "--property_cache", missing])
    tc = BertArchConfig(hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=1, intermediate_size=32,
                        fusion_layer=1, encoder_width=32)
    pc = BertArchConfig(vocab_size=1, hidden_size=32, num_hidden_layers=1,
                        num_attention_heads=1, intermediate_size=32,
                        fusion_layer=1, add_cross_attention=False)
    pcfg = PretrainConfig(embed_dim=8, queue_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_pretrain_state(0, pcfg, tc, pc)
    assert init_pretrain_state(0, pcfg, tc, pc,
                               device="cpu").temp.device.type == "cpu"
