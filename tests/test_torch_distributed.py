"""Port parity: data-parallel pretraining over torch.distributed
(spmm_tpu_torch.parallel, training.pretrain's data-parallel step, ZeRO-1,
bf16 Adam moments, checkpoint.io's layout and AsyncSaver, cli.pretrain
under torch.distributed.run), on the CPU at the tiny config of
tests/test_torch_pretrain.py (hidden 32, 4 + 2 layers, embed 16, queue 64).

Two gloo ranks run as subprocesses of tests/torch_dist_worker.py, which
imports torch and the port only, and meet through a file store in the
test's temporary directory; each writes its state there.  One 2-rank run
(module fixture) holds every scenario; each test reads its part.  Bars:

- 2 ranks at accum 1 against 1 process at accum 2 (the same chunks of the
  global batch, each chunk's noise fixed): bitwise, since each rank
  backpropagates its loss over world x accum and the ranks sum, which is
  the one process's arithmetic;
- against the JAX oracle of tests/test_torch_pretrain.py (``jax_oracle_
  steps``): its bars, parameters within 1e-6 + 1e-5 relative, EMA twins
  too, queues within 1e-5, ``queue_ptr`` equal;
- ZeRO-1 (the AdamW moments and, at rest, the EMA twins sharded) against
  replicated, and checkpoints resumed across world sizes and across
  ``zero1``: bitwise;
- bf16 moments against optax's ``mu_dtype=bfloat16`` AdamW (``make_
  optimizer(bf16_moments=True)``): parameters at the step bar, the stored
  first moment in bf16 within one bf16 ulp of optax's; through three
  pretrain steps, the three-step bars plus 2**-7 x the lr of each step
  after the first (a bf16 moment rounded the other way).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from spmm_tpu.parallel import multihost as jmultihost
from spmm_tpu.training import pretrain as jpre
from spmm_tpu.training.schedules import reference_cosine_schedule

from spmm_tpu_torch.checkpoint.convert import pretrain_state_dict_from_jax
from spmm_tpu_torch.checkpoint.io import (
    AsyncSaver, restore_checkpoint, save_checkpoint)
from spmm_tpu_torch.data.pipeline import batch_pretrain
from spmm_tpu_torch.parallel import mesh, multihost
from spmm_tpu_torch.tokenizer import SmilesTokenizer
from spmm_tpu_torch.training import optim, pretrain

from test_torch_pretrain_cli import corpus  # noqa: F401 - a fixture
from test_torch_pretrain import (
    PCFG, STEPS_PER_EPOCH, TPROP, TTEXT, jax_oracle_steps, jax_state,
    make_batch, make_noise, pcfgs, port_state, torch_tree)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
EXAMPLES = os.path.join(REPO, "examples", "s2p_input.txt")
TIMEOUT = 240          # a hung rank fails its test, not the suite


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread is several times faster, and the
    ranks run with one too, so that the sums are the same."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def worker_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return env


def run_ranks(workdir, world: int = 2, mode: str = "steps") -> None:
    """``world`` ranks of tests/torch_dist_worker.py ``mode`` over
    ``workdir``; each must exit 0 within TIMEOUT."""
    procs = [subprocess.Popen(
        [sys.executable, WORKER, mode, str(workdir), str(r), str(world)],
        cwd=REPO, env=worker_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"


def global_data(seed: int, bs: int, micro: int, n: int = 3):
    """``n`` global batches of ``bs`` rows and their noise, fixed per
    chunk of ``micro`` rows."""
    return ([make_batch(seed + s, bs=bs) for s in range(n)],
            [make_noise(seed + s, bs=bs, micro=micro) for s in range(n)])


def one_process(st, batches, noises, accum, steps=3, save_at=None,
                path=None, resume=None, **kw):
    """The port's step in this process, no process group: the model after
    ``steps`` steps and the losses."""
    _, tp = pcfgs(**kw)
    model = port_state(st)
    opt, step = pretrain.make_pretrain_step(model, tp, STEPS_PER_EPOCH,
                                            accum=accum)
    first = 0 if resume is None else restore_checkpoint(resume, model, opt)
    losses = []
    for s in range(first, steps):
        losses.append(step(s, torch_tree(batches[s]),
                           noise=torch_tree(noises[s]))["loss"].item())
        if save_at == s + 1:
            save_checkpoint(path, model, opt, s + 1)
    return model, opt, losses


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    """The 1-process references and one 2-rank run of every scenario:
    "dp" (accum 1, global batch 4), "dp_accum2" (accum 2, global batch 8),
    "zero1" (as "dp" with ZeRO-1, a checkpoint after step 2) and
    "zero1_resume" (ZeRO-1 from the 1-process accum-2 run's step-2
    checkpoint)."""
    workdir = tmp_path_factory.mktemp("dist")
    st = jax_state(2, ptr=61)
    data4 = global_data(10, 4, 2)
    data8 = global_data(20, 8, 2)
    ref_ckpt = str(workdir / "one_step2.pt")
    ref, _, ref_losses = one_process(st, *data4, accum=2, save_at=2,
                                     path=ref_ckpt)
    base = dict(zero1=False, bf16_moments=False, steps=3)
    scenarios = [
        dict(base, name="dp", accum=1, batches="data4"),
        dict(base, name="dp_accum2", accum=2, batches="data8"),
        dict(base, name="zero1", accum=1, batches="data4", zero1=True,
             save_at=2),
        dict(base, name="zero1_resume", accum=1, batches="data4",
             zero1=True, resume=ref_ckpt)]
    torch.save({"state": pretrain_state_dict_from_jax(st, TTEXT, TPROP),
                "configs": [dataclasses.asdict(TTEXT),
                            dataclasses.asdict(TPROP)],
                "pcfg": PCFG, "steps_per_epoch": STEPS_PER_EPOCH,
                "data4": tuple([torch_tree(x) for x in d] for d in data4),
                "data8": tuple([torch_tree(x) for x in d] for d in data8),
                "scenarios": scenarios}, workdir / "input.pt")
    run_ranks(workdir)
    out = {sc["name"]: [torch.load(workdir / f"{sc['name']}_rank{r}.pt",
                                   weights_only=True) for r in range(2)]
           for sc in scenarios}
    return {"st": st, "data4": data4, "data8": data8, "workdir": workdir,
            "ref": ref, "ref_losses": ref_losses, "ref_ckpt": ref_ckpt,
            "out": out}


def assert_equal_states(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for name, val in want.items():
        assert torch.equal(got[name], val), name


def assert_matches_jax(got: dict, want: dict, ptr: int,
                       atol: float = 1e-6) -> None:
    """tests/test_torch_pretrain.py's three-step bars."""
    for name, val in pretrain_state_dict_from_jax(want, TTEXT,
                                                  TPROP).items():
        if name == "queue_ptr":
            assert got[name].tolist() == val.tolist() == [ptr]
        elif name.endswith("_queue"):
            torch.testing.assert_close(got[name], val, atol=1e-5, rtol=1e-5,
                                       msg=name)
        else:
            torch.testing.assert_close(got[name], val, atol=atol, rtol=1e-5,
                                       msg=name)


@pytest.mark.parametrize("n_global,count", [(8, 1), (8, 2), (12, 3),
                                            (96, 8), (7, 2)])
def test_process_rows_match_jax(n_global, count):
    for index in range(count):
        try:
            want = jmultihost.process_rows(n_global, index, count)
        except ValueError:
            with pytest.raises(ValueError, match="not divisible"):
                multihost.process_rows(n_global, index, count)
            continue
        assert multihost.process_rows(n_global, index, count) == want


@pytest.mark.parametrize("n,world,accum", [(8, 2, 1), (8, 2, 2), (24, 3, 2)])
def test_local_rows_follow_the_microbatch_split(n, world, accum):
    """Microbatch i of rank r holds rows [i*M + r*m, i*M + (r+1)*m): the
    ranks' rows, microbatch by microbatch, rebuild the global batch in
    order (JAX reshapes to (accum, n / accum) and splits each over dp)."""
    rows = [multihost.local_rows(n, r, world, accum) for r in range(world)]
    m = n // (world * accum)
    chunks = [rows[r][i * m:(i + 1) * m] for i in range(accum)
              for r in range(world)]
    assert np.concatenate(chunks).tolist() == list(range(n))
    if accum == 1:
        for r in range(world):
            assert rows[r].tolist() == list(jmultihost.process_rows(
                n, r, world))


def test_batch_pretrain_rows_are_rows_of_the_global_batch():
    """Each rank pads with the global batch: its rows equal the global
    batch's rows, the padded length included."""
    tok = SmilesTokenizer()
    with open(EXAMPLES) as f:
        smiles = [line.strip() for line in f if line.strip()]
    ds = [(np.full(53, i, np.float32), "[CLS]" + smiles[i % len(smiles)])
          for i in range(12)]
    full = list(batch_pretrain(tok, ds, 6, seed=1))
    rows = multihost.local_rows(6, 1, 2, accum=1)
    mine = list(batch_pretrain(tok, ds, 6, seed=1, rows=rows))
    assert len(mine) == len(full) == 2
    for a, b in zip(mine, full):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k][rows], err_msg=k)


def test_without_a_process_group_the_step_is_one_process(tmp_path):
    """No group: world 1, rank 0; zero1 refuses to run.  A group of one
    (gloo, a file store): the mesh reads it, and a second initialize
    raises, as JAX's does."""
    assert (mesh.dp_group(), mesh.dp_size(), mesh.dp_rank()) == (None, 1, 0)
    _, tz = pcfgs(zero1=True)
    with pytest.raises(ValueError, match="process group"):
        pretrain.make_pretrain_step(port_state(jax_state(0)), tz,
                                    STEPS_PER_EPOCH)
    dev = multihost.initialize("cpu", init_method=f"file://{tmp_path}/s",
                               world_size=1, rank=0)
    try:
        assert dev == torch.device("cpu")
        assert mesh.dp_group() is not None
        assert (mesh.dp_size(), mesh.dp_rank()) == (1, 0)
        with pytest.raises(RuntimeError, match="already initialized"):
            multihost.initialize("cpu", init_method=f"file://{tmp_path}/t",
                                 world_size=1, rank=0)
    finally:
        torch.distributed.destroy_process_group()
    assert mesh.dp_group() is None


def test_chunk_0_generator_is_the_one_process_generator():
    """A one-process, accum-1 run draws from the generator seeded with the
    mix of the run's seed and the step, and chunk 0 is that generator."""
    cpu = torch.device("cpu")
    want = torch.Generator().manual_seed(
        pretrain._splitmix64(((7 + 1) << 32) + 5))
    got = pretrain.step_generator(7, 5, cpu)
    assert torch.equal(torch.rand(8, generator=got),
                       torch.rand(8, generator=want))
    other = pretrain.step_generator(7, 5, cpu, chunk=1)
    assert not torch.equal(torch.rand(8, generator=other),
                           torch.rand(8, generator=pretrain.step_generator(
                               7, 5, cpu)))


@pytest.mark.parametrize("chunk", [0, 1, 3])
def test_cpu_generators_of_two_seeds_differ(chunk):
    """The run's seed reaches the CPU's generator: seeds 1 and 2 draw
    different dropout, property masks and negatives at one step and chunk
    (the Mersenne Twister reads only the low 32 bits of its seed)."""
    cpu = torch.device("cpu")
    a, b = (torch.rand(16, generator=pretrain.step_generator(
        seed, 3, cpu, chunk=chunk)) for seed in (1, 2))
    assert not torch.equal(a, b)


def test_two_ranks_equal_one_process_at_twice_the_accum(dist_run):
    """Bitwise: every rank ends with the one process's state (parameters,
    twins, queues in global row order, ptr, temp) and its losses."""
    want = dist_run["ref"].state_dict()
    for rank in dist_run["out"]["dp"]:
        assert_equal_states(rank["state"], want)
        assert rank["losses"] == dist_run["ref_losses"]


def test_two_ranks_and_one_process_match_jax_at_accum_2(dist_run):
    batches, noises = dist_run["data4"]
    jp, _ = pcfgs()
    want, want_losses = jax_oracle_steps(dist_run["st"], batches, noises, jp,
                                         accum=2)
    np.testing.assert_allclose(dist_run["ref_losses"], want_losses,
                               atol=2e-4, rtol=1e-4)
    assert_matches_jax(dist_run["ref"].state_dict(), want, (61 + 12) % 64)
    for rank in dist_run["out"]["dp"]:
        assert_matches_jax(rank["state"], want, (61 + 12) % 64)


def test_two_ranks_at_accum_2_match_jax_at_accum_4(dist_run):
    """Global batch 8: chunk c = 2 * i + r is microbatch i of rank r, rows
    [2c, 2c + 2); the queue takes the features in global row order."""
    batches, noises = dist_run["data8"]
    jp, _ = pcfgs()
    want, want_losses = jax_oracle_steps(dist_run["st"], batches, noises, jp,
                                         accum=4)
    for rank in dist_run["out"]["dp_accum2"]:
        np.testing.assert_allclose(rank["losses"], want_losses, atol=2e-4,
                                   rtol=1e-4)
        assert_matches_jax(rank["state"], want, (61 + 24) % 64)


def test_zero1_equals_replicated(dist_run):
    for got, want in zip(dist_run["out"]["zero1"], dist_run["out"]["dp"]):
        assert_equal_states(got["state"], want["state"])
        assert got["losses"] == want["losses"]


def test_zero1_shards_the_optimizer_state(dist_run):
    """Each rank holds the moments of part of the parameters (replicated:
    two moments of all of them); together they hold all."""
    repl = dist_run["out"]["dp"][0]
    assert repl["opt_elements"] == 2 * repl["param_elements"]
    held = [r["opt_elements"] for r in dist_run["out"]["zero1"]]
    assert all(0 < h < repl["opt_elements"] for h in held)
    assert sum(held) == repl["opt_elements"]


def test_zero1_shards_the_ema_twins(dist_run):
    """Between steps a zero1 rank keeps its half of the twins (one flat
    buffer padded to a multiple of the 2 ranks) and no whole twin; a
    replicated rank keeps all of them, as JAX's ``_zero1_spec`` shards the
    EMA over dp at rest (spmm_tpu/training/pretrain.py:159-195)."""
    repl = dist_run["out"]["dp"][0]
    total = repl["twin_total"]
    assert repl["twin_elements"] == total
    for rank in dist_run["out"]["zero1"] + dist_run["out"]["zero1_resume"]:
        assert rank["twin_elements"] == -(-total // 2)


def test_zero1_checkpoint_resumes_in_one_process(dist_run):
    """The 2-rank ZeRO-1 checkpoint after step 2 has a plain AdamW's
    layout: one process without zero1 (accum 2) takes step 3 from it and
    ends where the 2 ranks ended."""
    path = str(dist_run["workdir"] / "zero1_step2.pt")
    ckpt = torch.load(path, weights_only=True)
    plain = torch.load(dist_run["ref_ckpt"], weights_only=True)
    assert ckpt["step"] == 2
    assert ckpt["optimizer"]["param_groups"] == \
        plain["optimizer"]["param_groups"]
    assert ckpt["optimizer"]["state"].keys() == \
        plain["optimizer"]["state"].keys()
    model, _, _ = one_process(dist_run["st"], *dist_run["data4"], accum=2,
                              resume=path)
    assert_equal_states(model.state_dict(),
                        dist_run["out"]["zero1"][0]["state"])


def test_one_process_checkpoint_resumes_under_zero1(dist_run):
    for rank in dist_run["out"]["zero1_resume"]:
        assert_equal_states(rank["state"], dist_run["ref"].state_dict())


def test_bf16_adamw_matches_optax_mu_dtype():
    """Three steps of make_optimizer(bf16_moments=True) (the clip, then
    optax.adamw with mu_dtype bf16) against clip_by_global_norm_ and the
    port's AdamW on the same parameters and gradients; the clip acts at
    the second step.  Bars: the step bar on the parameters, one bf16 ulp
    on the stored moment (found bitwise apart from the clip's norm, whose
    sum runs in another order)."""
    jp, tp = pcfgs(bf16_moments=True)
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": (3,), "c": ()}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    tx = jpre.make_optimizer(jp)
    jparams = jax.tree.map(jnp.asarray, params)
    state = tx.init(jparams)
    mine = [torch.nn.Parameter(torch.tensor(params[k])) for k in shapes]
    opt = optim.AdamW(mine, lr=0.0, weight_decay=tp.weight_decay,
                      mu_dtype=torch.bfloat16)
    for s in range(3):
        lr = 1e-3 * (s + 1)
        grads = {k: (rng.normal(size=sh) * (2.0 if s == 1 else 0.01)
                     ).astype(np.float32) for k, sh in shapes.items()}
        state.hyperparams["learning_rate"] = jnp.float32(lr)
        upd, state = tx.update(jax.tree.map(jnp.asarray, grads), state,
                               jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, k in zip(mine, shapes):
            p.grad = torch.tensor(grads[k])
        pretrain.clip_by_global_norm_([p.grad for p in mine], tp.grad_clip)
        opt.param_groups[0]["lr"] = lr
        opt.step()
    mu = optax.tree_utils.tree_get(state, "mu")
    for p, k in zip(mine, shapes):
        torch.testing.assert_close(p.detach(), torch.tensor(
            np.asarray(jparams[k])), atol=1e-6, rtol=1e-5, msg=k)
        got = opt.state[p]["exp_avg"]
        want = torch.tensor(np.asarray(mu[k].astype(jnp.float32)))
        assert got.dtype == torch.bfloat16 and mu[k].dtype == jnp.bfloat16
        ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want)[1] - 8)
        assert ((got.float() - want).abs() <= ulp).all(), k


def test_bf16_moments_three_steps_match_jax():
    """The pretrain step with bf16 moments against the JAX oracle whose
    optimizer is make_optimizer(bf16_moments=True), at the three-step
    bars plus what a bf16 moment makes of gradients that differ in their
    last bits: such a gradient can round the stored moment to the
    neighbouring bf16 value (one ulp, at most 2**-7 of it), which moves
    each later step's Adam ratio (|m_hat| / sqrt(v_hat), at most about 1)
    by as much, so the parameters get 2**-7 x the lr of every step after
    the first on top of the bar (the optimizer alone is bitwise, above).
    The stored first moments are bf16."""
    jp, _ = pcfgs(bf16_moments=True)
    st = jax_state(3, ptr=61)
    batches, noises = global_data(30, 4, 4)
    want, want_losses = jax_oracle_steps(st, batches, noises, jp, accum=1)
    model, opt, losses = one_process(st, batches, noises, accum=1,
                                     bf16_moments=True)
    np.testing.assert_allclose(losses, want_losses, atol=2e-4, rtol=1e-4)
    schedule = reference_cosine_schedule(
        jp.lr, jp.min_lr, jp.warmup_lr, jp.epochs, jp.warmup_epochs,
        STEPS_PER_EPOCH, step_size=100)
    flips = 2.0 ** -7 * sum(float(schedule(s)) for s in (1, 2))
    assert_matches_jax(model.state_dict(), want, (61 + 12) % 64,
                       atol=1e-6 + flips)
    assert {s["exp_avg"].dtype for s in opt.state.values()} == {
        torch.bfloat16}


def tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(tree_equal, a, b))
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_async_saver_writes_save_checkpoints_file(tmp_path):
    """The snapshot is taken at save(): a step taken while the thread
    writes does not reach the file, which equals save_checkpoint's of the
    same state (weights, twins, queues, bf16 moments, step)."""
    st = jax_state(4)
    batches, noises = global_data(40, 4, 4)
    _, tp = pcfgs(bf16_moments=True)
    model = port_state(st)
    opt, step = pretrain.make_pretrain_step(model, tp, STEPS_PER_EPOCH)
    step(0, torch_tree(batches[0]), noise=torch_tree(noises[0]))
    save_checkpoint(str(tmp_path / "blocking.pt"), model, opt, 1)
    with AsyncSaver() as saver:
        saver.save(str(tmp_path / "async.pt"), model, opt, 1)
        step(1, torch_tree(batches[1]), noise=torch_tree(noises[1]))
    assert sorted(os.listdir(tmp_path)) == ["async.pt", "blocking.pt"]
    a, b = (torch.load(tmp_path / f"{n}.pt", weights_only=True)
            for n in ("async", "blocking"))
    assert tree_equal(a, b)
    assert not tree_equal(a["state_dict"], model.state_dict())


@pytest.mark.parametrize("where", ["close", "wait", "save"])
def test_async_saver_raises_the_threads_error(tmp_path, where):
    """A write that fails in the thread (its directory is a file) is raised
    at the next save, wait or close, with the cause attached."""
    model = port_state(jax_state(5))
    opt = pretrain.make_pretrain_optimizer(model, pcfgs()[1])
    (tmp_path / "a_file").write_text("")
    saver = AsyncSaver()
    saver.save(str(tmp_path / "a_file" / "step_1.pt"), model, opt, 1)
    call = {"close": saver.close, "wait": saver.wait,
            "save": lambda: saver.save(str(tmp_path / "ok.pt"), model, opt,
                                       2)}[where]
    with pytest.raises(RuntimeError, match="asynchronous") as err:
        call()
    assert isinstance(err.value.__cause__, OSError)
    saver.close()
    assert not os.path.exists(tmp_path / "ok.pt")


def test_cli_under_torch_distributed_run_equals_accum_2(tmp_path, corpus,
                                                       monkeypatch):
    """cli.pretrain on 2 gloo ranks (torch.distributed.run --standalone,
    --batch_size 4 per rank, --zero1 --async_save) for 4 steps, dropout
    on, equals one process at --accum 2 with --batch_size 8: the losses
    and every tensor of step_4.pt; and the run's metadata says 2 ranks."""
    from spmm_tpu_torch.cli import pretrain as cli

    path, cache = corpus
    common = ["--data_path", path, "--property_cache", cache,
              "--queue_size", "64", "--max_steps", "4", "--save_every", "2",
              "--seed", "5", "--device", "cpu", "--bf16_moments"]
    one, two = tmp_path / "one", tmp_path / "two"
    monkeypatch.setattr(cli, "text_config", lambda: TTEXT)
    monkeypatch.setattr(cli, "property_config", lambda: TPROP)
    cli.main(common + ["--batch_size", "8", "--accum", "2",
                       "--output_dir", str(one)])
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", WORKER, "cli",
         json.dumps(dataclasses.asdict(TTEXT)),
         json.dumps(dataclasses.asdict(TPROP)), *common,
         "--batch_size", "4", "--zero1", "--async_save",
         "--output_dir", str(two)],
        cwd=REPO, env=worker_env(), capture_output=True, text=True,
        timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("resumed") == 0
    assert proc.stdout.count("saved step_2.pt") == 1     # rank 0 prints
    assert sorted(os.listdir(two)) == ["metrics.jsonl", "run_meta.json",
                                       "step_2.pt", "step_4.pt"]
    with open(two / "run_meta.json") as f:
        assert json.load(f) == {"global_bs": 8, "seed": 5, "n_dev": 2,
                                "batch_size": 4}
    runs = []
    for d in (one, two):
        with open(d / "metrics.jsonl") as f:
            runs.append([json.loads(line) for line in f])
    assert [r["step"] for r in runs[1]] == [1, 2, 3, 4]
    for a, b in zip(*runs):
        assert {k: v for k, v in a.items() if k != "time"} == \
            {k: v for k, v in b.items() if k != "time"}
    a, b = (torch.load(d / "step_4.pt", weights_only=True) for d in (one,
                                                                      two))
    assert tree_equal(a, b)
