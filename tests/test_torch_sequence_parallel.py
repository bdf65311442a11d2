"""Port parity: sequence parallelism (spmm_tpu_torch.parallel.sp) on top of
tensor parallelism, over gloo ranks, against one process, at the tiny
pretrain config of tests/test_torch_pretrain.py (text length 12 and the
54 property positions, both cut in two by tp=2).

Four gloo ranks (dp=2 x tp=2, sp on) run once as subprocesses of
tests/torch_dist_worker.py (module fixture).  Bars, as
tests/test_sequence_parallel.py and tests/test_tensor_parallel.py:

- the MLM forward under sp, dropout on, against one process: 1e-5 (the
  residual dropout's mask is drawn over all positions and cut to the
  rank's);
- two pretrain steps with sp, dropout on, against the port's dp=2 step
  (one process at accum 2): loss 1e-5, parameters 2e-5, queues 1e-5,
  ``queue_ptr`` equal;
- sp composed with remat and accum 2 (global batch 8) against one process
  at accum 4 without remat: the same bars;
- cli.pretrain --tp 2 --sp on 2 gloo ranks under torch.distributed.run
  (one dp rank) against the one-process CLI at the same global batch: the
  logged losses within 1e-5 relative, the last checkpoint's tensors at the
  step bars, and the run's metadata counting one dp rank.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spmm_tpu_torch.checkpoint.convert import pretrain_state_dict_from_jax
from spmm_tpu_torch.parallel import fsdp, mesh, multihost, sp
from spmm_tpu_torch.training import pretrain

from test_torch_distributed import (
    REPO, TIMEOUT, WORKER, global_data, run_ranks, worker_env)
from test_torch_pretrain_cli import corpus  # noqa: F401 - a fixture
from test_torch_pretrain import (
    PCFG, STEPS_PER_EPOCH, TPROP, TTEXT, jax_state, pcfgs, port_state,
    torch_tree)
from test_torch_tensor_parallel import (
    assert_step_bars, dropout_steps, mlm_inputs)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sp_run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("sp")
    st = jax_state(2, ptr=61)
    data4 = global_data(10, 4, 2)
    data8 = global_data(20, 8, 2)
    grid = [2, 2, "tp"]
    scenarios = [
        dict(name="mlm", kind="mlm", mesh=grid, sp=True),
        dict(name="step", kind="pretrain", mesh=grid, sp=True, accum=1,
             steps=2, dropout=True, batches="data4"),
        dict(name="remat_accum", kind="pretrain", mesh=grid, sp=True,
             accum=2, steps=2, dropout=True, batches="data8",
             pcfg={"remat": True})]
    torch.save({"state": pretrain_state_dict_from_jax(st, TTEXT, TPROP),
                "configs": [dataclasses.asdict(TTEXT),
                            dataclasses.asdict(TPROP)],
                "pcfg": PCFG, "steps_per_epoch": STEPS_PER_EPOCH,
                "mlm": mlm_inputs(),
                "data4": tuple([torch_tree(x) for x in d] for d in data4),
                "data8": tuple([torch_tree(x) for x in d] for d in data8),
                "scenarios": scenarios}, workdir / "input.pt")
    run_ranks(workdir, world=4, mode="parallel")
    out = {sc["name"]: [torch.load(workdir / f"{sc['name']}_rank{r}.pt",
                                   weights_only=True) for r in range(4)]
           for sc in scenarios}
    return {"st": st, "data4": data4, "data8": data8, "out": out}


def test_sp_without_tp_raises(tmp_path):
    """No mesh, or a dp x fsdp mesh: make_pretrain_step(sp=True) raises, as
    JAX's does without a 'tp' axis (spmm_tpu/training/pretrain.py:505-508);
    outside its context every sp hook is the identity."""
    model = port_state(jax_state(0))
    with pytest.raises(ValueError, match="'tp'"):
        pretrain.make_pretrain_step(model, pcfgs()[1], STEPS_PER_EPOCH,
                                    sp=True)
    x = torch.randn(2, 5, 4)
    assert sp.scatter(x) is x and sp.gather(x) is x
    multihost.initialize("cpu", init_method=f"file://{tmp_path}/s",
                         world_size=1, rank=0)
    try:
        fsdp.dp_fsdp_mesh(fsdp=1)
        assert mesh.minor_dim() == "fsdp"
        with pytest.raises(ValueError, match="'tp'"):
            pretrain.make_pretrain_step(model, pcfgs()[1], STEPS_PER_EPOCH,
                                        sp=True)
    finally:
        torch.distributed.destroy_process_group()


def test_mlm_forward_sp_matches_one_process(sp_run):
    model = port_state(sp_run["st"])
    ids, mask, enc = mlm_inputs()
    with torch.no_grad():
        want = model.text_encoder(
            input_ids=ids, attention_mask=mask, encoder_hidden_states=enc,
            is_decoder=True, generator=torch.Generator().manual_seed(5))
    for rank in sp_run["out"]["mlm"]:
        torch.testing.assert_close(rank["logits"], want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name,data,accum", [("step", "data4", 2),
                                             ("remat_accum", "data8", 4)])
def test_pretrain_step_sp_matches_dp(sp_run, name, data, accum):
    batches, _ = sp_run[data]
    model = port_state(sp_run["st"])
    losses = dropout_steps(model, batches, accum, range(2))
    want = model.state_dict()
    gb = batches[0]["prop"].shape[0]
    for rank in sp_run["out"][name]:
        np.testing.assert_allclose(rank["losses"], losses, atol=1e-5,
                                   rtol=1e-5)
        assert_step_bars(rank["state"], want, (61 + 2 * gb) % 64)


def test_cli_tp_sp_equals_one_process(tmp_path, corpus, monkeypatch):
    from spmm_tpu_torch.cli import pretrain as cli

    path, cache = corpus
    common = ["--data_path", path, "--property_cache", cache,
              "--queue_size", "64", "--max_steps", "3", "--save_every", "2",
              "--seed", "5", "--device", "cpu", "--batch_size", "8"]
    one, two = tmp_path / "one", tmp_path / "two"
    monkeypatch.setattr(cli, "text_config", lambda: TTEXT)
    monkeypatch.setattr(cli, "property_config", lambda: TPROP)
    cli.main(common + ["--output_dir", str(one)])
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", WORKER, "cli",
         json.dumps(dataclasses.asdict(TTEXT)),
         json.dumps(dataclasses.asdict(TPROP)), *common,
         "--tp", "2", "--sp", "--output_dir", str(two)],
        cwd=REPO, env=worker_env(), capture_output=True, text=True,
        timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("saved step_2.pt") == 1     # rank 0 prints
    assert sorted(os.listdir(two)) == ["metrics.jsonl", "run_meta.json",
                                       "step_2.pt", "step_3.pt"]
    with open(two / "run_meta.json") as f:
        assert json.load(f) == {"global_bs": 8, "seed": 5, "n_dev": 1,
                                "batch_size": 8}
    runs = []
    for d in (one, two):
        with open(d / "metrics.jsonl") as f:
            runs.append([json.loads(line) for line in f])
    assert [r["step"] for r in runs[1]] == [1, 2, 3]
    np.testing.assert_allclose([r["loss"] for r in runs[1]],
                               [r["loss"] for r in runs[0]], rtol=1e-5)
    a, b = (torch.load(d / "step_3.pt", weights_only=True) for d in (one,
                                                                      two))
    assert b["step"] == 3
    assert_step_bars(b["state_dict"], a["state_dict"], (3 * 8) % 64)
