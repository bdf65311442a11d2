"""The port's entry points of the parallel paths (spmm_tpu_torch.parallel.
dryrun), the counterpart of the JAX package's ``__graft_entry__.py``:

- ``python -m spmm_tpu_torch.parallel.dryrun --n 4 --device cpu`` starts
  four gloo ranks and runs all seven stages (dp, decode, pp, ep, tp, sp,
  fsdp), none skipped, and exits 0 (about 10 s here; a 300 s limit);
- without ``device="cpu"`` and with fewer than n cards it raises, and it
  never falls back to the CPU;
- ``entry()``'s loss: on the card unless asked, finite and the same at
  every call (dropout off, the noise fixed), here at a tiny width.
"""

import dataclasses
import math
import os
import re
import subprocess
import sys

import pytest
import torch

from spmm_tpu_torch.configs import BertArchConfig
from spmm_tpu_torch.parallel import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("dp", "decode", "pp", "ep", "tp", "sp", "fsdp")


def run_cli(*args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "spmm_tpu_torch.parallel.dryrun", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def test_dryrun_four_gloo_ranks_runs_every_stage():
    proc = run_cli("--n", "4", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    for name in STAGES:
        assert any(line.startswith(f"dryrun stage {name}: OK in ")
                   for line in lines), name
    summary = [line for line in lines
               if line.startswith("dryrun_multichip(4) OK in ")]
    assert len(summary) == 1
    parts = re.findall(r"(\w+) (loss|seqs|max_err)=(\([^)]*\)|[^,]+)",
                       summary[0])
    assert [p[0] for p in parts] == list(STAGES)
    assert ("decode", "seqs", "(4, 2, 16)") in parts
    for _, key, value in parts:
        if key != "seqs":
            assert math.isfinite(float(value)), (key, value)
    assert "SKIPPED" not in proc.stdout


def test_dryrun_without_cards_raises(monkeypatch):
    """No device: NCCL on n cards, which this machine does not have."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
        dryrun.dryrun_multichip(4, device="cuda")
    with pytest.raises(ValueError, match="even number"):
        dryrun.dryrun_multichip(3, device="cpu")


def test_dryrun_cli_without_device_fails_here():
    if torch.cuda.device_count() >= 2:
        pytest.skip("this machine has the cards the NCCL run needs")
    proc = run_cli("--n", "2", timeout=120)
    assert proc.returncode != 0
    assert "needs 2 CUDA devices" in proc.stderr


TEXT = BertArchConfig(hidden_size=32, num_hidden_layers=4,
                      num_attention_heads=4, intermediate_size=64,
                      fusion_layer=2, encoder_width=32)
PROP = dataclasses.replace(TEXT, vocab_size=1, num_hidden_layers=2,
                           add_cross_attention=False)


def test_entry_loss_is_fixed_and_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(dryrun, "text_config", lambda: TEXT)
    monkeypatch.setattr(dryrun, "property_config", lambda: PROP)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dryrun.entry()
    fn, args = dryrun.entry(device="cpu")
    model, batch, noise = args
    assert batch["ids"].shape == (2, 16) and model.prop_queue.shape[1] == 512
    first, second = fn(*args).item(), fn(*args).item()
    assert math.isfinite(first) and first == second
