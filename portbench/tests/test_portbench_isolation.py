"""What the benchmark imports, compared by whole top-level names (the part
before the first dot; ``spmm_tpu_torch`` begins with ``spmm_tpu``):

- nothing under ``portbench/`` imports ``jax``, ``jaxlib``, ``flax`` or the
  JAX package ``spmm_tpu``;
- nothing under ``portbench/reference/`` imports the program
  (``spmm_tpu_torch``) either;
- after a tiny run driven in its own process, none of them but the
  program is in ``sys.modules``."""

import ast
import os
import subprocess
import sys

from portbench.tests.tiny import REPO

BENCH = os.path.join(REPO, "portbench")
NEVER = {"jax", "jaxlib", "flax", "spmm_tpu"}


def imported_tops(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(node.args[0].value.split(".")[0])
    return tops


def sources(top: str) -> list:
    return [os.path.join(d, f) for d, _, files in os.walk(top)
            for f in files if f.endswith(".py")]


def test_whole_top_level_names():
    from portbench import run

    assert set(run.FORBIDDEN) == NEVER
    assert run.forbidden_loaded(["spmm_tpu_torch", "spmm_tpu_torch.ops",
                                 "jaxtyping", "flaxen"]) == []
    assert run.forbidden_loaded(["spmm_tpu.models", "jax", "jaxlib.xla",
                                 "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                    "spmm_tpu"]


def test_no_jax_anywhere_in_the_benchmark():
    files = sources(BENCH)
    assert len(files) > 10
    for path in files:
        bad = imported_tops(path) & NEVER
        assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    files = sources(os.path.join(BENCH, "reference"))
    assert files
    for path in files:
        bad = imported_tops(path) & (NEVER | {"spmm_tpu_torch"})
        assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_a_driven_run_loads_no_jax(tmp_path):
    code = f"""
import sys, torch
from portbench.tests.tiny import tiny_root
from portbench import run
root = tiny_root({str(tmp_path)!r})
for trace in ("0", "1"):
    rc = run.main(["--workload", "rxn-beam-k5-b32", "--seed", "4100000003",
                   "--seconds", "0.5", "--trace", trace], root=root,
                  device=torch.device("cpu"))
    assert rc == 0, rc
tops = {{n.split(".")[0] for n in sys.modules}}
assert "spmm_tpu_torch" in tops
print("FORBIDDEN", run.forbidden_loaded())
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
