"""Port parity: tensor parallelism (spmm_tpu_torch.parallel.tp) on a dp x tp
mesh over gloo ranks, against one process and against JAX's
``spmm_tpu.parallel.tp`` (tests/test_tensor_parallel.py), at the tiny
pretrain config of tests/test_torch_pretrain.py (hidden 32, 4 heads, MLP
64, 4 + 2 layers, embed 16, queue 64).

Four gloo ranks (dp=2 x tp=2) run once as subprocesses of
tests/torch_dist_worker.py (module fixture) and write each scenario's
result; each test reads its part.  Bars:

- the MLM forward at tp=2, dropout on, against one process: 1e-5 (the
  attention-probability mask is drawn for all heads and cut to the rank's);
- ``predict_pv`` at dp=2 x tp=2 against JAX's single-device ``predict_pv``:
  2e-5, as JAX's test;
- two pretrain steps at dp=2 x tp=2, dropout on (a generator per chunk),
  against the port's dp=2 step, which is one process at accum 2 bitwise
  (tests/test_torch_distributed.py): loss 1e-5, parameters 2e-5, queues
  1e-5, ``queue_ptr`` equal, as tests/test_tensor_parallel.py:146-193;
- a tp checkpoint resumes in one process: its third step equals the tp
  run's third step at the same bars;
- two AdamW steps of the classification fine-tune at dp=2 x tp=2 (each dp
  rank on its 4 rows of a batch of 8, dropout off) against JAX's
  single-device ``make_downstream_step``: losses and parameters 1e-5, as
  tests/test_tensor_parallel.py:96-143.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from spmm_tpu.configs import FinetuneConfig as JaxFcfg
from spmm_tpu.inference.smiles2pv import predict_pv as jax_predict_pv
from spmm_tpu.models.downstream import init_downstream_params
from spmm_tpu.models.spmm import init_spmm_params
from spmm_tpu.parallel import tp as jtp
from spmm_tpu.training.finetune import make_downstream_step

from spmm_tpu_torch.checkpoint.convert import (
    downstream_state_dict_from_jax_tree, pretrain_state_dict_from_jax,
    state_dict_from_jax_tree)
from spmm_tpu_torch.checkpoint.io import restore_checkpoint
from spmm_tpu_torch.models.spmm import SPMM
from spmm_tpu_torch.parallel import mesh, multihost, tp
from spmm_tpu_torch.training import pretrain

from test_torch_distributed import global_data, run_ranks
from test_torch_pretrain import (
    JPROP, JTEXT, PCFG, STEPS_PER_EPOCH, TPROP, TTEXT, jax_state, pcfgs,
    port_state, torch_tree)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mlm_inputs(seed: int = 3):
    rng = np.random.default_rng(seed)
    ids = torch.tensor(rng.integers(4, 300, size=(4, 12)))
    mask = torch.ones(4, 12, dtype=torch.int64)
    mask[1, 8:] = 0
    enc = torch.tensor(rng.normal(size=(4, 6, 32)), dtype=torch.float32)
    return ids, mask, enc


def s2p_inputs(seed: int = 6):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 300, size=(8, 12)).astype(np.int32)
    mask = np.ones((8, 12), np.int32)
    mask[3, 7:] = 0
    return ids * mask, mask


def spmm_tree() -> dict:
    tree = init_spmm_params(jax.random.PRNGKey(5), JTEXT, JPROP,
                            with_pretrain_heads=False)
    return jax.tree.map(np.asarray, tree)


FCFG = dict(epochs=2, batch_size_train=8)
FT_STEPS_PER_EPOCH = 4


def downstream_tree() -> dict:
    return jax.tree.map(np.asarray, init_downstream_params(
        jax.random.PRNGKey(3), "classification", cfg=JTEXT))


def ft_batches() -> list:
    """Two batches of 8 x 10 (tests/test_tensor_parallel.py:108-116)."""
    out = []
    for i in range(2):
        k = jax.random.PRNGKey(10 + i)
        out.append({
            "ids": np.asarray(jax.random.randint(k, (8, 10), 4, 300)),
            "mask": np.ones((8, 10), np.int32),
            "target": np.asarray(jax.random.randint(
                jax.random.fold_in(k, 1), (8,), 0, 2))})
    return out


def dropout_steps(model, batches, accum: int, steps, opt_step=None):
    """The port's one-process step with dropout on, a generator per chunk
    from seed 11 (as the worker's), over ``steps``; the losses."""
    if opt_step is None:
        _, opt_step = pretrain.make_pretrain_step(
            model, pcfgs()[1], STEPS_PER_EPOCH, accum=accum)
    return [opt_step(s, torch_tree(batches[s]), functools.partial(
        pretrain.step_generator, 11, s, CPU))["loss"].item() for s in steps]


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("tp")
    st = jax_state(2, ptr=61)
    data4 = global_data(10, 4, 2)
    ids, mask = s2p_inputs()
    scenarios = [
        dict(name="mlm", kind="mlm", mesh=[2, 2, "tp"]),
        dict(name="pv", kind="predict_pv", mesh=[2, 2, "tp"]),
        dict(name="step", kind="pretrain", mesh=[2, 2, "tp"], accum=1,
             steps=3, dropout=True, batches="data4", save_at=2),
        dict(name="finetune", kind="finetune", mesh=[2, 2, "tp"])]
    torch.save({"state": pretrain_state_dict_from_jax(st, TTEXT, TPROP),
                "spmm": state_dict_from_jax_tree(spmm_tree(), TTEXT, TPROP),
                "configs": [dataclasses.asdict(TTEXT),
                            dataclasses.asdict(TPROP)],
                "pcfg": PCFG, "steps_per_epoch": STEPS_PER_EPOCH,
                "mlm": mlm_inputs(), "s2p": (torch.tensor(ids),
                                             torch.tensor(mask)),
                "data4": tuple([torch_tree(x) for x in d] for d in data4),
                "downstream": downstream_state_dict_from_jax_tree(
                    downstream_tree(), TTEXT),
                "fcfg": FCFG, "ft_steps_per_epoch": FT_STEPS_PER_EPOCH,
                "ft_batches": [{k: torch.tensor(v) for k, v in b.items()}
                               for b in ft_batches()],
                "scenarios": scenarios}, workdir / "input.pt")
    run_ranks(workdir, world=4, mode="parallel")
    out = {sc["name"]: [torch.load(workdir / f"{sc['name']}_rank{r}.pt",
                                   weights_only=True) for r in range(4)]
           for sc in scenarios}
    return {"st": st, "data4": data4, "workdir": workdir, "out": out}


def jax_specs_by_port_name(st: dict) -> dict:
    """JAX's tp_param_specs of the pretrain params and EMA, carried to the
    port's names: each leaf is filled with its own index, converted by the
    port's name map, and read back."""
    leaves, specs = [], []

    def fill(spec_tree, tree):
        def one(spec, leaf):
            specs.append(spec)
            leaves.append(leaf)
            return np.full(np.shape(leaf), len(leaves) - 1, np.float32)
        return jax.tree.map(one, spec_tree, tree,
                            is_leaf=lambda x: isinstance(x, P))

    filled = {"params": fill(jtp.tp_param_specs(st["params"]), st["params"]),
              "ema": fill(jtp.tp_param_specs(st["ema"]), st["ema"]),
              "queue": st["queue"]}
    out = {}
    for name, val in pretrain_state_dict_from_jax(filled, TTEXT,
                                                  TPROP).items():
        if name.endswith("_queue") or name == "queue_ptr":
            continue
        idx = {int(v) for v in torch.unique(val.float()).tolist()}
        assert len(idx) == 1, name
        spec = specs[idx.pop()]
        out[name] = {P(None, "tp"): "colwise", P("tp"): "colwise",
                     P("tp", None): "rowwise", P(): None}[spec]
    return out


def test_plan_matches_jax_tp_param_specs(tp_run):
    """Every parameter, twins included: column-parallel where JAX shards
    the output dim, row-parallel where it shards the contracting dim,
    replicated elsewhere; and the ranks' DTensors carry that layout."""
    model = port_state(tp_run["st"])
    mine = tp.tp_param_specs(model)
    want = jax_specs_by_port_name(tp_run["st"])
    assert {k: mine[k] for k in want} == want
    assert {v for v in mine.values()} == {"colwise", "rowwise", None}
    layout = {"colwise": "(Shard(dim=0),)", "rowwise": "(Shard(dim=1),)"}
    for rank in tp_run["out"]["step"]:
        for name, place in rank["placements"].items():
            spec = mine[name]
            if spec is None:
                assert place in ("None", "(Replicate(),)"), name
            else:
                assert place == layout[spec], name


def test_assert_tp_compatible():
    tp.assert_tp_compatible(TTEXT, 4)
    tp.assert_tp_compatible(TTEXT, 2)
    with pytest.raises(ValueError, match="num_attention_heads"):
        tp.assert_tp_compatible(TTEXT, 3)
    with pytest.raises(ValueError, match="intermediate_size"):
        tp.assert_tp_compatible(dataclasses.replace(TTEXT,
                                                    intermediate_size=66), 4)


def test_mlm_forward_tp_matches_one_process(tp_run):
    model = port_state(tp_run["st"])
    ids, mask, enc = mlm_inputs()
    with torch.no_grad():
        want = model.text_encoder(
            input_ids=ids, attention_mask=mask, encoder_hidden_states=enc,
            is_decoder=True, generator=torch.Generator().manual_seed(5))
    for rank in tp_run["out"]["mlm"]:
        torch.testing.assert_close(rank["logits"], want, atol=1e-5, rtol=0)


def test_predict_pv_dp_tp_matches_jax_single_device(tp_run):
    """dp=2 x tp=2: each dp rank's rows through the tp plan (h = 2 heads a
    rank, the kernel's plain version on the CPU) against JAX's
    single-device predict_pv: 2e-5."""
    ids, mask = s2p_inputs()
    want = np.asarray(jax_predict_pv(
        jax.tree.map(jnp.asarray, spmm_tree()), jnp.asarray(ids),
        jnp.asarray(mask), text_cfg=JTEXT, prop_cfg=JPROP, n_properties=5))
    got = np.zeros_like(want)
    for rank in tp_run["out"]["pv"]:
        got[rank["rows"].numpy()] = rank["pv"].numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    model = SPMM(TTEXT, TPROP)
    model.load_state_dict(state_dict_from_jax_tree(spmm_tree(), TTEXT,
                                                   TPROP), strict=True)
    from spmm_tpu_torch.inference.smiles2pv import predict_pv

    one = predict_pv(model.eval(), ids, mask, n_properties=5, device="cpu")
    np.testing.assert_allclose(got, one.numpy(), atol=1e-5, rtol=0)


def assert_step_bars(got: dict, want: dict, ptr: int) -> None:
    for name, val in want.items():
        if name == "queue_ptr":
            assert got[name].tolist() == val.tolist() == [ptr]
        elif name.endswith("_queue"):
            torch.testing.assert_close(got[name], val, atol=1e-5, rtol=0,
                                       msg=name)
        else:
            torch.testing.assert_close(got[name], val, atol=2e-5, rtol=0,
                                       msg=name)


def test_pretrain_step_dp_tp_matches_dp(tp_run):
    """Three steps at dp=2 x tp=2 with dropout on equal the dp=2 step (one
    process at accum 2): every rank ends with its state and losses."""
    batches, _ = tp_run["data4"]
    model = port_state(tp_run["st"])
    losses = dropout_steps(model, batches, 2, range(3))
    want = model.state_dict()
    for rank in tp_run["out"]["step"]:
        np.testing.assert_allclose(rank["losses"], losses, atol=1e-5,
                                   rtol=1e-5)
        assert_step_bars(rank["state"], want, (61 + 12) % 64)


def test_tp_checkpoint_resumes_in_one_process(tp_run):
    """The tp run's step-2 checkpoint holds whole tensors in a plain
    AdamW's layout: one process (accum 2) takes step 3 from it and ends
    where the tp ranks ended."""
    batches, _ = tp_run["data4"]
    model = port_state(tp_run["st"])
    opt, opt_step = pretrain.make_pretrain_step(model, pcfgs()[1],
                                                STEPS_PER_EPOCH, accum=2)
    path = tp_run["workdir"] / "step_step2.pt"
    assert restore_checkpoint(str(path), model, opt) == 2
    loss = dropout_steps(model, batches, 2, [2], opt_step)
    rank0 = tp_run["out"]["step"][0]
    np.testing.assert_allclose(loss, rank0["losses"][2:], atol=1e-5,
                               rtol=1e-5)
    assert_step_bars(model.state_dict(), rank0["state"], (61 + 12) % 64)


def test_zero1_with_tp_raises(tmp_path):
    """As JAX's (spmm_tpu/training/pretrain.py:494-498), on a gloo group
    of one with a (1, 1) dp x tp mesh."""
    multihost.initialize("cpu", init_method=f"file://{tmp_path}/s",
                         world_size=1, rank=0)
    try:
        tp.dp_tp_mesh(tp=1)
        assert mesh.minor_dim() == "tp" and mesh.dp_size() == 1
        with pytest.raises(ValueError, match="zero1"):
            pretrain.make_pretrain_step(port_state(jax_state(0)),
                                        pcfgs(zero1=True)[1],
                                        STEPS_PER_EPOCH)
    finally:
        torch.distributed.destroy_process_group()
    assert mesh.get_mesh() is None


def test_downstream_train_step_tp_matches_jax_single_device(tp_run):
    """Two AdamW steps of the classification fine-tune on the dp=2 x tp=2
    mesh (the truncated encoder under the tp plan, the port's AdamW on
    local shards, the gradients summed over dp) equal JAX's single-device
    step: every rank's losses and whole parameters within 1e-5."""
    tx, step = make_downstream_step("classification", JaxFcfg(**FCFG),
                                    steps_per_epoch=FT_STEPS_PER_EPOCH,
                                    cfg=JTEXT)
    params = jax.tree.map(jnp.asarray, downstream_tree())
    opt_state = tx.init(params)
    losses = []
    for gs, batch in enumerate(ft_batches()):
        params, opt_state, m = step(params, opt_state, jnp.asarray(gs),
                                    jax.tree.map(jnp.asarray, batch), None)
        losses.append(float(m["loss"]))
    want = downstream_state_dict_from_jax_tree(
        jax.tree.map(np.asarray, params), TTEXT)
    for rank in tp_run["out"]["finetune"]:
        np.testing.assert_allclose(rank["losses"], losses, atol=1e-5, rtol=0)
        assert rank["state"].keys() == want.keys()
        for name, val in want.items():
            torch.testing.assert_close(rank["state"][name], val, atol=1e-5,
                                       rtol=0, msg=name)


def test_finetune_step_refuses_an_fsdp_mesh(tmp_path):
    """The fine-tune step shards over ('dp', 'tp') only, as JAX's test
    runs it; a ('dp', 'fsdp') mesh raises instead of training unsharded."""
    from spmm_tpu_torch.configs import FinetuneConfig
    from spmm_tpu_torch.models.downstream import Downstream
    from spmm_tpu_torch.training.finetune import make_downstream_step

    multihost.initialize("cpu", init_method=f"file://{tmp_path}/s",
                         world_size=1, rank=0)
    try:
        mesh.set_mesh(1, 1, "fsdp")
        with pytest.raises(ValueError, match="'dp', 'tp'"):
            make_downstream_step(Downstream("classification", TTEXT),
                                 FinetuneConfig(**FCFG), FT_STEPS_PER_EPOCH)
    finally:
        torch.distributed.destroy_process_group()
    assert mesh.get_mesh() is None
