"""Port parity: fully-sharded data parallelism (spmm_tpu_torch.parallel.fsdp,
FSDP2) on a dp x fsdp mesh over gloo ranks, against one process and
against JAX's ``spmm_tpu.parallel.fsdp`` (tests/test_fsdp.py), at the tiny
pretrain config of tests/test_torch_pretrain.py.

Four gloo ranks (dp=2 x fsdp=2) run once as subprocesses of
tests/torch_dist_worker.py (module fixture).  Bars, as tests/test_fsdp.py:

- the layout rule: each parameter sharded on the dim JAX's
  ``fsdp_param_specs`` shards (read through the port's name map and the
  transpose of linear weights), or replicated where JAX replicates;
- each rank holds exactly 1/F of every sharded parameter, twin and AdamW
  moment, and the replicated leaves whole;
- three steps at dp=2 x fsdp=2, dropout on, against the port's dp=2 step
  (one process at accum 2): loss 1e-5, parameters 2e-5, queues 1e-5,
  ``queue_ptr`` equal;
- the fsdp run's step-2 checkpoint resumes in one process with equal
  losses, and the one-process step-2 checkpoint resumes under fsdp;
- cli.pretrain --fsdp 2 on 2 gloo ranks under torch.distributed.run
  equals the one-process CLI (losses within 1e-5 relative, the last
  checkpoint at the step bars), and one process resumes from its step-2
  checkpoint with equal losses.
"""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from spmm_tpu.parallel import fsdp as jfsdp

from spmm_tpu_torch.checkpoint.convert import pretrain_state_dict_from_jax
from spmm_tpu_torch.checkpoint.io import restore_checkpoint, save_checkpoint
from spmm_tpu_torch.parallel import fsdp, mesh, multihost
from spmm_tpu_torch.training import pretrain

from test_torch_distributed import (
    REPO, TIMEOUT, WORKER, global_data, run_ranks, worker_env)
from test_torch_pretrain_cli import corpus  # noqa: F401 - a fixture
from test_torch_pretrain import (
    PCFG, STEPS_PER_EPOCH, TPROP, TTEXT, jax_state, pcfgs, port_state,
    torch_tree)
from test_torch_tensor_parallel import assert_step_bars, dropout_steps


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fsdp_run(tmp_path_factory):
    """The one-process reference (accum 2, three steps, a checkpoint after
    step 2) and one 4-rank run: "step" (three steps, a checkpoint after
    step 2) and "resume" (step 3 from the one-process checkpoint)."""
    workdir = tmp_path_factory.mktemp("fsdp")
    st = jax_state(2, ptr=61)
    data4 = global_data(10, 4, 2)
    ref = port_state(st)
    opt, opt_step = pretrain.make_pretrain_step(ref, pcfgs()[1],
                                                STEPS_PER_EPOCH, accum=2)
    ref_losses = dropout_steps(ref, data4[0], 2, range(2), opt_step)
    ref_ckpt = str(workdir / "one_step2.pt")
    save_checkpoint(ref_ckpt, ref, opt, 2)
    ref_losses += dropout_steps(ref, data4[0], 2, [2], opt_step)
    grid = [2, 2, "fsdp"]
    scenarios = [
        dict(name="step", kind="pretrain", mesh=grid, accum=1, steps=3,
             dropout=True, batches="data4", save_at=2),
        dict(name="resume", kind="pretrain", mesh=grid, accum=1, steps=3,
             dropout=True, batches="data4", resume=ref_ckpt)]
    torch.save({"state": pretrain_state_dict_from_jax(st, TTEXT, TPROP),
                "configs": [dataclasses.asdict(TTEXT),
                            dataclasses.asdict(TPROP)],
                "pcfg": PCFG, "steps_per_epoch": STEPS_PER_EPOCH,
                "data4": tuple([torch_tree(x) for x in d] for d in data4),
                "scenarios": scenarios}, workdir / "input.pt")
    run_ranks(workdir, world=4, mode="parallel")
    out = {sc["name"]: [torch.load(workdir / f"{sc['name']}_rank{r}.pt",
                                   weights_only=True) for r in range(4)]
           for sc in scenarios}
    return {"st": st, "data4": data4, "workdir": workdir, "ref": ref,
            "ref_losses": ref_losses, "out": out}


@pytest.mark.parametrize("size", [2, 4])
def test_layout_rule_matches_jax_fsdp_param_specs(size):
    """Leaf by leaf, the params and the EMA twins: JAX's spec of a leaf,
    carried to the port's name by filling it with its index."""
    st = jax_state(0)
    specs, leaves = [], []

    def fill(tree):
        def one(spec, leaf):
            specs.append(spec)
            leaves.append(np.shape(leaf))
            return np.full(np.shape(leaf), len(specs) - 1, np.float32)
        return jax.tree.map(one, jfsdp.fsdp_param_specs(tree, size), tree,
                            is_leaf=lambda x: isinstance(x, P))

    filled = {"params": fill(st["params"]), "ema": fill(st["ema"]),
              "queue": st["queue"]}
    by_name = pretrain_state_dict_from_jax(filled, TTEXT, TPROP)
    model = port_state(st)
    linears = {id(m.weight) for m in model.modules()
               if isinstance(m, torch.nn.Linear)}
    embeddings = {id(m.weight) for m in model.modules()
                  if isinstance(m, torch.nn.Embedding)}
    params = dict(model.named_parameters())
    mine = fsdp.fsdp_param_specs(model, size)
    assert mine.keys() == params.keys()
    for name, dim in mine.items():
        idx = {int(v) for v in torch.unique(by_name[name]).tolist()}
        assert len(idx) == 1, name
        spec = tuple(specs[idx.pop()])
        jdim = next((d for d, a in enumerate(spec) if a == "fsdp"), None)
        p = params[name]
        if jdim is not None and id(p) in linears and id(p) not in embeddings:
            jdim = 1 - jdim            # [in, out] in JAX, [out, in] here
        assert dim == jdim, (name, spec, tuple(p.shape))
    assert None in mine.values() and 0 in mine.values() \
        and 1 in mine.values()


def test_each_rank_holds_a_share_of_the_state(fsdp_run):
    """Parameters, twins and both moments: a sharded leaf 1/F a rank, a
    replicated one whole (exactly), and the DTensors placed by the rule."""
    model = port_state(fsdp_run["st"])
    specs = fsdp.fsdp_param_specs(model, 2)
    params = dict(model.named_parameters())
    twins, online = model.ema_pairs()[0], model.online_parameters()

    def share(tensors):
        names = {id(p): n for n, p in params.items()}
        return sum(p.numel() // (1 if specs[names[id(p)]] is None else 2)
                   for p in tensors)

    full = sum(p.numel() for p in online)
    for rank in fsdp_run["out"]["step"]:
        held = rank["held"]
        assert held["params"] == share(online) < 0.6 * full
        assert held["twins"] == share(twins)
        assert held["moments"] == 2 * held["params"]
        for name, place in rank["placements"].items():
            want = ("None" if specs[name] is None
                    else f"(Shard(dim={specs[name]}),)")
            assert place == want, name


def test_pretrain_step_dp_fsdp_matches_dp(fsdp_run):
    for rank in fsdp_run["out"]["step"]:
        np.testing.assert_allclose(rank["losses"], fsdp_run["ref_losses"],
                                   atol=1e-5, rtol=1e-5)
        assert_step_bars(rank["state"], fsdp_run["ref"].state_dict(),
                         (61 + 12) % 64)


def test_fsdp_checkpoint_resumes_in_one_process(fsdp_run):
    batches, _ = fsdp_run["data4"]
    model = port_state(fsdp_run["st"])
    opt, opt_step = pretrain.make_pretrain_step(model, pcfgs()[1],
                                                STEPS_PER_EPOCH, accum=2)
    path = fsdp_run["workdir"] / "step_step2.pt"
    ckpt = torch.load(path, weights_only=True)
    assert {k: tuple(v.shape) for k, v in ckpt["state_dict"].items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert restore_checkpoint(str(path), model, opt) == 2
    loss = dropout_steps(model, batches, 2, [2], opt_step)
    rank0 = fsdp_run["out"]["step"][0]
    np.testing.assert_allclose(loss, rank0["losses"][2:], atol=1e-5,
                               rtol=1e-5)
    assert_step_bars(model.state_dict(), rank0["state"], (61 + 12) % 64)


def test_one_process_checkpoint_resumes_under_fsdp(fsdp_run):
    for rank in fsdp_run["out"]["resume"]:
        np.testing.assert_allclose(rank["losses"],
                                   fsdp_run["ref_losses"][2:], atol=1e-5,
                                   rtol=1e-5)
        assert_step_bars(rank["state"], fsdp_run["ref"].state_dict(),
                         (61 + 12) % 64)


def test_zero1_with_fsdp_raises(tmp_path):
    multihost.initialize("cpu", init_method=f"file://{tmp_path}/s",
                         world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="dp=2 x fsdp=1"):
            fsdp.dp_fsdp_mesh(dp=2, fsdp=1)
        fsdp.dp_fsdp_mesh(fsdp=1)
        assert mesh.minor_dim() == "fsdp"
        with pytest.raises(ValueError, match="zero1"):
            pretrain.make_pretrain_step(port_state(jax_state(0)),
                                        pcfgs(zero1=True)[1],
                                        STEPS_PER_EPOCH)
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("flags", [["--fsdp", "2", "--tp", "2"],
                                   ["--fsdp", "2", "--zero1"],
                                   ["--tp", "2", "--zero1"],
                                   ["--sp"], ["--sp", "--tp", "1"],
                                   ["--tp", "5"]])
def test_cli_flag_checks(flags, capsys):
    """cli.pretrain refuses what JAX's refuses (spmm_tpu/cli/pretrain.py:
    97-117) before it reads any data."""
    from spmm_tpu_torch.cli import pretrain as cli

    with pytest.raises(SystemExit):
        cli.main(["--data_path", "/nonexistent", "--property_cache",
                  "/nonexistent.npz", "--device", "cpu"] + flags)
    assert "error" in capsys.readouterr().err


def test_cli_fsdp_equals_one_process_and_resumes_there(tmp_path, corpus,
                                                       monkeypatch):
    from spmm_tpu_torch.cli import pretrain as cli

    path, cache = corpus
    common = ["--data_path", path, "--property_cache", cache,
              "--queue_size", "64", "--max_steps", "3", "--save_every", "2",
              "--seed", "5", "--device", "cpu"]
    one, two, back = tmp_path / "one", tmp_path / "two", tmp_path / "back"
    monkeypatch.setattr(cli, "text_config", lambda: TTEXT)
    monkeypatch.setattr(cli, "property_config", lambda: TPROP)
    cli.main(common + ["--batch_size", "8", "--accum", "2",
                       "--output_dir", str(one)])
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", WORKER, "cli",
         json.dumps(dataclasses.asdict(TTEXT)),
         json.dumps(dataclasses.asdict(TPROP)), *common,
         "--batch_size", "8", "--accum", "2", "--fsdp", "2",
         "--output_dir", str(two)],
        cwd=REPO, env=worker_env(), capture_output=True, text=True,
        timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    cli.main(common + ["--batch_size", "8", "--accum", "2", "--resume",
                       str(two / "step_2.pt"), "--output_dir", str(back)])
    runs = []
    for d in (one, two, back):
        with open(d / "metrics.jsonl") as f:
            runs.append([json.loads(line)["loss"] for line in f])
    assert len(runs[1]) == 3 and len(runs[2]) == 1
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-5)
    np.testing.assert_allclose(runs[2], runs[0][2:], rtol=1e-5)
    for d in (two, back):
        got = torch.load(d / "step_3.pt", weights_only=True)
        want = torch.load(one / "step_3.pt", weights_only=True)
        assert_step_bars(got["state_dict"], want["state_dict"], 24)
