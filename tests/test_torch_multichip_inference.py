"""Port parity: data-parallel inference (spmm_tpu_torch.parallel.replicas,
the ``devices=`` arguments of inference/pv2smiles.py, inference/rxn.py,
inference/smiles2pv.py, cli/smiles2pv.py and serving.py, and
``parallel.mesh.auto_mesh``) against the unsharded port and JAX, as
tests/test_multichip_inference.py holds JAX's sharded runs to its
single-device ones.

On the CPU ``devices=[cpu] * n`` runs the split, pad, worker-process and
gather code with n replicas of one model, each in a worker process of its
own.  To keep the file short, most cases share one started pool per n
(``parallel.replicas.WorkerPool``, passed as ``devices``; each case still
sends its own weights), and the rest start their own.  Bars: ``seqs``
exact; ``logp`` and PVs within 1e-5 of the unsharded port (JAX: 1e-5,
``logp`` also 5e-7 x |logp|, tests/test_torch_decoding.py's note).  The
pool's failures: a worker's exception reaches the parent with its message,
a worker that dies or hangs makes the call raise within its timeout, a
lambda is refused, and no worker outlives ``close()`` or its interpreter.
"""

import os
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spmm_tpu.inference import pv2smiles as jpv
from spmm_tpu.inference import rxn as jrxn
from spmm_tpu.inference.decoding import BeamSpec as JBeamSpec
from spmm_tpu.inference.smiles2pv import predict_pv as jax_predict_pv
from spmm_tpu.tokenizer import SmilesTokenizer as JTok

from spmm_tpu_torch.cli._common import load_stats
from spmm_tpu_torch.cli.smiles2pv import pv_generate
from spmm_tpu_torch.inference import pv2smiles, rxn
from spmm_tpu_torch.inference.decoding import BeamSpec
from spmm_tpu_torch.inference.smiles2pv import predict_pv, predict_pv_rows
from spmm_tpu_torch.parallel import mesh
from spmm_tpu_torch.ops.decode_attention import beam_decode_attention
from spmm_tpu_torch.ops.fused_attention import fused_mha
from spmm_tpu_torch.parallel import replicas
from spmm_tpu_torch.parallel.replicas import (
    Replicas, WorkerError, WorkerPool, pad_rows)
from spmm_tpu_torch.serving import Pv2SmilesService, Smiles2PvService
from spmm_tpu_torch.tokenizer import SmilesTokenizer

import torch_replica_fns as fns
from torch_parity import CPU, jax_configs, jax_tree, port_model, t, to_jax
from test_torch_rxn import (
    SEP_BIAS, _fresh_jax_path, port_rxn, reactions, rxn_tree)

M = 8
SHARDS = [2, 4]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pools(one_thread):
    """One started pool of n CPU workers for each n of SHARDS, the pools
    started at once."""
    with ThreadPoolExecutor(len(SHARDS)) as ex:
        started = list(ex.map(lambda n: WorkerPool([CPU] * n), SHARDS))
    yield dict(zip(SHARDS, started))
    for pool in started:
        pool.close()


@pytest.fixture(scope="module")
def pv_case():
    tree = jax_tree(3, sep_bias=0.3)
    pv = np.random.default_rng(8).normal(size=(M, 53)).astype(np.float32)
    return tree, port_model(tree), pv


@pytest.fixture(scope="module")
def quick_model():
    """A tiny SPMM whose [SEP] logit is raised so far that beams finish
    within a few steps: the whole-call tests stay short."""
    return port_model(jax_tree(4, sep_bias=4.0))


@pytest.fixture(scope="module")
def rxn_pair():
    tree = rxn_tree(0, sep_bias=SEP_BIAS)
    return tree, port_rxn(tree)


def smiles(n: int) -> list:
    return [s.split(".")[0] for s in reactions(n)]


@pytest.mark.parametrize("n", SHARDS)
def test_beam_rows_match_unsharded_and_jax(pv_case, pools, n):
    """fp32 k=2 beams of 8 PVs over n replicas: the unsharded port's and
    JAX's single-device _beam_batch."""
    tree, model, pv = pv_case
    spec = BeamSpec(k=2, stop_count=2, max_steps=16)
    one = pv2smiles.to_host(pv2smiles._beam_batch(
        model, pv2smiles.decoder_for(model, bf16=False), t(pv), None, spec))
    with pv2smiles.replicas_for(model, pools[n], bf16=False) as reps:
        got = pv2smiles.beam_rows(reps, pv, None, spec, None)
    tcj, pcj = jax_configs()
    want = jax.device_get(jpv._beam_batch(
        to_jax(tree), jnp.asarray(pv), None,
        jax.random.split(jax.random.PRNGKey(0), M),
        JBeamSpec(k=2, stop_count=2, max_steps=16), tcj, pcj, bf16=False))
    for ref in (one, want):
        np.testing.assert_array_equal(got["seqs"], ref["seqs"])
        np.testing.assert_array_equal(got["n_finished"], ref["n_finished"])
    np.testing.assert_allclose(got["logp"], one["logp"], atol=1e-5, rtol=5e-7)
    finite = np.isfinite(want["logp"])
    np.testing.assert_allclose(got["logp"][finite], want["logp"][finite],
                               atol=1e-5, rtol=5e-7)
    assert got["steps"] == one["steps"]


@pytest.mark.parametrize("n", SHARDS)
def test_stochastic_beam_rows_draw_the_unsharded_noise(pv_case, pools, n):
    """Each card draws every row's noise and keeps its own: the sharded
    search equals the unsharded one, and leaves its generator where the
    unsharded search leaves it."""
    _, model, pv = pv_case
    spec = BeamSpec(k=2, stop_count=4, stochastic=True, max_steps=12)
    gens = [torch.Generator().manual_seed(4) for _ in range(2)]
    one = pv2smiles.to_host(pv2smiles._beam_batch(
        model, pv2smiles.decoder_for(model, bf16=False), t(pv), None, spec,
        gens[0]))
    with pv2smiles.replicas_for(model, pools[n], bf16=False) as reps:
        got = pv2smiles.beam_rows(reps, pv, None, spec, gens[1])
    np.testing.assert_array_equal(got["seqs"], one["seqs"])
    np.testing.assert_allclose(got["logp"], one["logp"], atol=1e-5, rtol=5e-7)
    assert torch.equal(*(torch.rand(4, generator=g) for g in gens))


@pytest.mark.parametrize("n", SHARDS)
def test_generate_batched_and_with_property_sharded(pv_case, quick_model,
                                                   pools, n):
    """6 molecules in batches of 4 (the last padded): the strings of the
    unsharded run, deterministic and stochastic."""
    model = pv_case[1]
    tok = SmilesTokenizer()
    pvs = np.random.default_rng(1).normal(size=(6, 53)).astype(np.float32)
    kw = dict(k=2, seed=0, device_batch=4, device=CPU)
    one = pv2smiles.generate_batched(model, tok, pvs, **kw)
    got = pv2smiles.generate_batched(model, tok, pvs, devices=pools[n],
                                     **kw)
    assert got == one and len(got) == 6 and got[0]
    model = quick_model
    cond = (np.zeros(53, np.float32), (np.arange(53) % 2).astype(np.float32))
    one = pv2smiles.generate_with_property(model, tok, *cond, n_generate=6,
                                           **kw)
    got = pv2smiles.generate_with_property(model, tok, *cond, n_generate=6,
                                           devices=pools[n], **kw)
    assert got == one and len(got) == 6 and len(set(got)) > 2


@pytest.mark.parametrize("n", SHARDS)
def test_rxn_greedy_and_beam_sharded_match_jax(rxn_pair, monkeypatch, pools,
                                               n):
    """7 reactions in batches of 4 (the last padded to 4 with [CLS] rows):
    greedy and k=3 beam strings of the unsharded port and of JAX's XLA
    path."""
    tree, model = rxn_pair
    _fresh_jax_path(monkeypatch, "xla")
    tok, sources = SmilesTokenizer(), reactions(7)
    kw = dict(batch_size=4, bf16=False, device=CPU)
    one = rxn.predict_greedy(model, tok, sources, **kw)
    got = rxn.predict_greedy(model, tok, sources, devices=pools[n], **kw)
    want = jrxn.predict_greedy(to_jax(tree), JTok(), sources, batch_size=4)
    assert got == one == want and len(set(got)) > 1
    one = rxn.predict_beam(model, tok, sources, k=3, **kw)
    got = rxn.predict_beam(model, tok, sources, k=3, devices=pools[n],
                           **kw)
    want = jrxn.predict_beam(to_jax(tree), JTok(), sources, k=3,
                             batch_size=4)
    assert got == one == want


@pytest.mark.parametrize("n", SHARDS)
def test_predict_pv_sharded_matches_unsharded_and_jax(pv_case, pools, n):
    tree, model, _ = pv_case
    tok = SmilesTokenizer()
    ids, mask = tok.encode_batch(["[CLS]" + s for s in smiles(8)],
                                 max_len=100)
    ids, mask = ids[:, 1:], mask[:, 1:]
    one = predict_pv(model, ids, mask, n_properties=5,
                     device=CPU).numpy()
    with Replicas(model, pools[n]) as reps:
        got = predict_pv_rows(reps, ids, mask, n_properties=5)
    tcj, pcj = jax_configs()
    want = np.asarray(jax_predict_pv(to_jax(tree), jnp.asarray(ids),
                                     jnp.asarray(mask), text_cfg=tcj,
                                     prop_cfg=pcj, n_properties=5))
    np.testing.assert_allclose(got, one, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_pv_generate_pads_a_short_last_batch(pv_case, pools):
    """cli.smiles2pv's batcher: 10 SMILES in batches of 4 over 2 replicas
    (the last batch padded with [CLS] rows, whose outputs are dropped),
    in a pool of its own; a batch that does not divide is refused."""
    _, model, _ = pv_case
    tok, stats, mols = SmilesTokenizer(), load_stats(), smiles(10)
    one = pv_generate(model, tok, mols, stats, batch_size=4, device=CPU)
    got = pv_generate(model, tok, mols, stats, batch_size=4, device=CPU,
                      devices=[CPU, CPU])
    assert got.shape == (10, 53)
    np.testing.assert_allclose(got, one, atol=1e-5, rtol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        pv_generate(model, tok, mols, stats, batch_size=5, device=CPU,
                    devices=pools[2])


def test_pad_rows_and_one_copy_per_card(pv_case):
    """A card named three times gets three worker processes, each with its
    own copy, none of them this process; each gets its own rows, as numpy
    arrays."""
    ids, mask = np.ones((3, 5), np.int64), np.ones((3, 5), np.int64)
    pids, pmask = pad_rows(ids, mask, 4, cls_id=2)
    assert pids.shape == (4, 5) and pids[3].tolist() == [2, 0, 0, 0, 0]
    assert pmask[3].tolist() == [0] * 5
    _, model, _ = pv_case
    with Replicas(model, [CPU, CPU, CPU]) as reps:
        x = torch.arange(6.0).reshape(6, 1)
        out = reps.map(fns.rows_and_pid, x)
        assert [o["rows"] for o in out] == [(0, 2), (2, 4), (4, 6)]
        assert all(isinstance(o["x"], np.ndarray) for o in out)
        assert np.concatenate([o["x"] for o in out]).ravel().tolist() == \
            list(range(6))
        workers = {o["pid"] for o in out}
        assert len(workers) == 3 and os.getpid() not in workers
        assert workers == {p.pid for p in reps.pool._procs}
        with pytest.raises(ValueError, match="divide"):
            reps.map(fns.rows_and_pid, np.zeros((4, 2)))


@pytest.mark.parametrize("n", SHARDS)
def test_services_shard_their_batches(quick_model, pools, n):
    model = quick_model
    tok = SmilesTokenizer()
    pvs = [np.random.default_rng(i).normal(size=53).astype(np.float32)
           for i in range(3)]
    outs = []
    for devices in (None, pools[n]):
        # the three requests must share one batch in both runs: a batch's
        # noise depends on which requests it holds, so a caller descheduled
        # past the wait (a loaded CPU) would change the stochastic strings
        with Pv2SmilesService(model, tok, k=2, stochastic=True,
                              batch_size=4, max_wait_ms=1000, device=CPU,
                              devices=devices) as svc:
            strings = svc.map(pvs)
        with Smiles2PvService(model, tok, batch_size=4, max_wait_ms=1,
                              device=CPU, devices=devices) as svc:
            values = np.stack(svc.map(smiles(3)))
        outs.append((strings, values))
    assert outs[0][0] == outs[1][0] and len(set(outs[0][0])) > 1
    np.testing.assert_allclose(outs[1][1], outs[0][1], atol=1e-5, rtol=0)


def test_auto_mesh_is_none_with_at_most_one_card(monkeypatch):
    """No card (this machine) or one: None, the unsharded path.  Two or
    more: every card, in order."""
    assert mesh.auto_mesh() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.auto_mesh() is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert mesh.auto_mesh() == [torch.device("cuda", i) for i in range(3)]


def test_a_workers_exception_reaches_the_parent(quick_model, pools):
    """The worker's traceback, with its message, raises in the parent, from
    a batch or from a model's load; the pool then serves the next call."""
    with pytest.raises(WorkerError, match="this model cannot be prepared"):
        Replicas(quick_model, pools[2], prepare=fns.fail_to_prepare)
    with Replicas(quick_model, pools[2]) as reps:
        with pytest.raises(WorkerError, match="rows 2:4 cannot be decoded"):
            reps.map(fns.raise_in_worker, np.zeros((4, 1)))
        out = reps.map(fns.rows_and_pid, np.zeros((4, 1)))
        assert [o["rows"] for o in out] == [(0, 2), (2, 4)]


def test_a_dead_worker_raises_within_the_timeout(quick_model, monkeypatch):
    """A worker killed before a call, one that dies in the middle of one,
    and one that outlives the call's timeout: each call raises, well
    within the timeout, and leaves no worker running."""
    x = np.zeros((2, 1))
    monkeypatch.setattr(replicas, "CALL_TIMEOUT", 60.0)
    with Replicas(quick_model, [CPU, CPU]) as reps:
        os.kill(reps.pool._procs[1].pid, signal.SIGKILL)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="worker 1 .* died"):
            reps.map(fns.rows_and_pid, x)
        assert time.monotonic() - t0 < 30.0
        assert not any(p.is_alive() for p in reps.pool._procs)
        with pytest.raises(RuntimeError, match="closed"):
            reps.map(fns.rows_and_pid, x)
    with Replicas(quick_model, [CPU, CPU]) as reps:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="died .*exit code 3"):
            reps.map(fns.exit_worker, x)
        assert time.monotonic() - t0 < 30.0
        assert not any(p.is_alive() for p in reps.pool._procs)
    with Replicas(quick_model, [CPU]) as reps:
        monkeypatch.setattr(replicas, "CALL_TIMEOUT", 1.0)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="within 1 s"):
            reps.map(fns.sleep_in_worker, x, seconds=120)
        assert time.monotonic() - t0 < 30.0
        assert not any(p.is_alive() for p in reps.pool._procs)


def test_a_lambda_is_refused(quick_model, pools):
    def nested(model, dev, rows, x):
        return x

    with Replicas(quick_model, pools[2]) as reps:
        for fn in (lambda model, dev, rows, x: x, nested):
            with pytest.raises(TypeError, match="module-level function"):
                reps.map(fn, np.zeros((2, 1)))
    with pytest.raises(TypeError, match="module-level function"):
        Replicas(quick_model, pools[2], prepare=lambda m: m)


def test_close_leaves_no_live_child(quick_model):
    """close() joins every worker; an interpreter that exits without
    close() leaves none behind either."""
    reps = Replicas(quick_model, [CPU, CPU])
    procs = list(reps.pool._procs)
    assert all(p.is_alive() for p in procs)
    reps.close()
    reps.close()
    assert not any(p.is_alive() for p in procs)
    import multiprocessing

    assert not set(multiprocessing.active_children()) & set(procs)
    code = ("import torch\n"
            "from spmm_tpu_torch.parallel.replicas import Replicas\n"
            "reps = Replicas(torch.nn.Linear(2, 2), ['cpu', 'cpu'])\n"
            "print(*(p.pid for p in reps.pool._procs))\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    pids = [int(p) for p in proc.stdout.split()]
    assert len(pids) == 2

    def alive(pid):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        return True

    deadline = time.monotonic() + 30.0
    while any(map(alive, pids)) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not any(map(alive, pids))


def test_launch_counts_come_back_with_each_shard(quick_model, pools):
    """Each shard's launches of the call, by wrapper, from a worker that
    counts as a decode launches; this process's counts do not move."""
    mine = (beam_decode_attention.launches, fused_mha.launches)
    with Replicas(quick_model, pools[4]) as reps:
        assert reps.launches == []
        for _ in range(2):          # deltas of each call, not totals
            assert reps.map(fns.count_launches, np.zeros((8, 1))) == \
                [None] * 4
            assert reps.launches == [
                {"beam_decode_attention": 2 * i + 1,
                 "fused_mha": 2 * (2 * i + 1)} for i in range(4)]
    assert (beam_decode_attention.launches, fused_mha.launches) == mine
