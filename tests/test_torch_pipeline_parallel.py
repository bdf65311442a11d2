"""Port parity: pipeline parallelism (spmm_tpu_torch.parallel.pp) against
JAX's ``spmm_tpu.parallel.pp`` (tests/test_pipeline_parallel.py), at its
tiny text stack (hidden 48, 4 heads, MLP 96, 8 self-attention layers),
a batch of 8 x 12 positions.

Four gloo ranks run once as subprocesses of tests/torch_dist_worker.py
(``blocks`` mode, module fixture): for (S, M) = (2, 4), (4, 8) and (4, 4),
the first S ranks run the pipeline forward and the backward of
sum(out ** 2).  Bars, JAX's: the forward 2e-5 against JAX's sequential
``encoder_forward`` and its ``pipeline_encoder_forward``; every layer's
gradient 2e-4 against JAX's sequential gradients, the input's too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spmm_tpu.configs import BertArchConfig as JaxCfg
from spmm_tpu.models import bert as jbert
from spmm_tpu.ops.masks import invert_encoder_mask
from spmm_tpu.parallel import pp as jpp

from spmm_tpu_torch.checkpoint.convert import _put_bert
from spmm_tpu_torch.configs import BertArchConfig
from spmm_tpu_torch.models.bert import BertEncoder
from spmm_tpu_torch.parallel import pp

from test_torch_distributed import run_ranks

TINY = dict(
    vocab_size=300, hidden_size=48, num_hidden_layers=8,
    num_attention_heads=4, intermediate_size=96, max_position_embeddings=128,
    type_vocab_size=2, fusion_layer=8, encoder_width=48,
    add_cross_attention=False)
CASES = [(2, 4), (4, 8), (4, 4)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """JAX's params, inputs and sequential output (the fixture of
    tests/test_pipeline_parallel.py), and the port's encoder state."""
    cfg = JaxCfg(**TINY)
    params = jbert.init_bert_params(jax.random.PRNGKey(0), cfg)
    b, L = 8, 12
    hidden = jax.random.normal(jax.random.PRNGKey(1), (b, L, 48))
    add_mask = jnp.broadcast_to(
        invert_encoder_mask(jnp.ones((b, L), jnp.int32)), (b, 1, 1, L))
    sequential = jbert.encoder_forward(params, cfg, hidden, add_mask,
                                       mode="text")
    return {"cfg": cfg, "params": params, "hidden": hidden,
            "mask": add_mask, "sequential": np.asarray(sequential),
            "state": encoder_state(params)}


def encoder_state(params) -> dict:
    """A JAX bert tree's layers under the names of the port's
    BertEncoder (``layer.{i}.*``)."""
    out = {}
    _put_bert(out, jax.tree.map(np.asarray, params), "bert")
    prefix = "bert.encoder."
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


def port_encoder(state: dict) -> BertEncoder:
    enc = BertEncoder(BertArchConfig(**TINY))
    enc.load_state_dict(state, strict=True)
    return enc


@pytest.fixture(scope="module")
def pp_run(setup, tmp_path_factory):
    workdir = tmp_path_factory.mktemp("pp")
    scenarios = [dict(name=f"s{s}_m{m}", kind="pp", stages=s, micro=m)
                 for s, m in CASES]
    torch.save({"pp": {"cfg": TINY, "state": setup["state"],
                       "hidden": torch.tensor(np.asarray(setup["hidden"])),
                       "mask": torch.tensor(np.asarray(setup["mask"]))},
                "scenarios": scenarios}, workdir / "input.pt")
    run_ranks(workdir, world=4, mode="blocks")
    return {sc["name"]: [torch.load(workdir / f"{sc['name']}_rank{r}.pt",
                                    weights_only=True) for r in range(4)]
            for sc in scenarios}


@pytest.fixture(scope="module")
def jax_grads(setup):
    """JAX's sequential gradients of sum(out ** 2) by the layers and the
    input, the layers' under the port's names."""
    cfg, params = setup["cfg"], setup["params"]

    def loss(layers, hidden):
        out = jbert.encoder_forward({"layers": layers}, cfg, hidden,
                                    setup["mask"], mode="text")
        return jnp.sum(out ** 2)

    g_layers, g_hidden = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        params["layers"], setup["hidden"])
    return encoder_state(dict(params, layers=g_layers)), np.asarray(g_hidden)


def test_stage_split_and_its_refusal(setup):
    """Stage s holds layers [s * L/S, (s + 1) * L/S) of the stack, the
    modules themselves (JAX's slabs are [S, L/S, ...]); 3 stages do not
    divide 8 layers."""
    enc = port_encoder(setup["state"])
    for s in range(4):
        stage = pp.stage_layers(enc.layer, 4, s)
        assert [id(m) for m in stage] == [id(m) for m in
                                          enc.layer[2 * s:2 * s + 2]]
    jax_slabs = jpp.stack_stage_params(setup["params"]["layers"], 4)
    assert jax_slabs["self_attn"]["q"]["w"].shape[:2] == (4, 2)
    with pytest.raises(ValueError, match="do not divide"):
        pp.stage_layers(enc.layer, 3, 0)


@pytest.mark.parametrize("n_stages,n_micro", CASES)
def test_pp_forward_matches_jax(setup, pp_run, n_stages, n_micro):
    """Every stage ends with the whole output, within 2e-5 of JAX's
    sequential stack and of JAX's pipeline at the same (S, M); the ranks
    past S take no part."""
    def jax_pipeline(st, h, m):
        return jpp.pipeline_encoder_forward(st, setup["cfg"], h, m,
                                            jpp.pp_mesh(n_stages),
                                            n_microbatches=n_micro)

    want_pp = np.asarray(jax.jit(jax_pipeline)(
        jpp.stack_stage_params(setup["params"]["layers"], n_stages),
        setup["hidden"], setup["mask"]))
    ranks = pp_run[f"s{n_stages}_m{n_micro}"]
    for rank in ranks[:n_stages]:
        got = rank["out"].numpy()
        np.testing.assert_allclose(got, setup["sequential"], atol=2e-5,
                                   rtol=0)
        np.testing.assert_allclose(got, want_pp, atol=2e-5, rtol=0)
    assert all(rank == {} for rank in ranks[n_stages:])


@pytest.mark.parametrize("n_stages,n_micro", CASES)
def test_pp_grads_match_jax_sequential(pp_run, jax_grads, n_stages,
                                       n_micro):
    """The backward of sum(out ** 2) of the replicated output gives each
    stage exactly its layers' gradients, JAX's sequential ones within 2e-4
    (not S times them), and every stage the input's gradient."""
    want, want_hidden = jax_grads
    seen = {}
    for rank in pp_run[f"s{n_stages}_m{n_micro}"][:n_stages]:
        assert not seen.keys() & rank["grads"].keys()
        seen.update(rank["grads"])
        np.testing.assert_allclose(rank["hidden_grad"].numpy(), want_hidden,
                                   atol=2e-4, rtol=0)
    assert seen.keys() == want.keys()
    for name, g in want.items():
        np.testing.assert_allclose(seen[name].numpy(), g.numpy(), atol=2e-4,
                                   rtol=0, err_msg=name)


def test_one_stage_is_the_sequential_stack(setup):
    """No group: one stage in this process, the whole stack, with and
    without autograd; the microbatches are cut along the batch."""
    enc = port_encoder(setup["state"])
    hidden = torch.tensor(np.asarray(setup["hidden"]))
    mask = torch.tensor(np.asarray(setup["mask"]))
    want = enc(hidden, mask, mode="text")
    got = pp.pipeline_encoder_forward(enc.layer, BertArchConfig(**TINY),
                                      hidden, mask, None, 4)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    with torch.no_grad():
        got = pp.pipeline_encoder_forward(enc.layer, BertArchConfig(**TINY),
                                          hidden, mask, None, 2)
    assert got.grad_fn is None
    torch.testing.assert_close(got, want.detach(), atol=1e-6, rtol=0)


def test_pp_rejects_indivisible_batch(setup):
    enc = port_encoder(setup["state"])
    hidden = torch.tensor(np.asarray(setup["hidden"]))
    with pytest.raises(ValueError, match="not divisible"):
        pp.pipeline_encoder_forward(
            enc.layer, BertArchConfig(**TINY), hidden,
            torch.tensor(np.asarray(setup["mask"])), None, 3)

