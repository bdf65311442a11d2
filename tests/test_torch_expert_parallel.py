"""Port parity: the GShard MoE block and expert parallelism
(spmm_tpu_torch.parallel.ep) against JAX's ``spmm_tpu.parallel.ep``
(tests/test_expert_parallel.py), at its tiny config (hidden 32, MLP 64),
8 experts, a batch of 8 x 6 tokens; JAX's weights carried over by
``checkpoint.convert.moe_state_dict_from_jax_tree``.

Four gloo ranks (ep = 4, two experts a rank) run once as subprocesses of
tests/torch_dist_worker.py (``blocks`` mode, module fixture), each on its
2 rows, for top_k 1 and 2, forward and the backward of sum(out ** 2) +
0.01 * aux_loss (aux_loss / 4 on each rank: the ranks' losses summed
count it once).  Bars: the dense block against JAX's 2e-5, its aux_loss
1e-6; ep against JAX's dense ``n_groups=ep`` 1e-5, aux_loss 1e-5,
dropped_frac 1e-6; the gradients atol 2e-4, rtol 1e-4, the router's and
LayerNorm's summed over the ranks, the expert slabs each rank's own.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spmm_tpu.configs import BertArchConfig as JaxCfg
from spmm_tpu.parallel import ep as jep

from spmm_tpu_torch.checkpoint.convert import moe_state_dict_from_jax_tree
from spmm_tpu_torch.configs import BertArchConfig
from spmm_tpu_torch.parallel import ep

from test_torch_distributed import run_ranks

TINY = dict(
    vocab_size=300, hidden_size=32, num_hidden_layers=2,
    num_attention_heads=4, intermediate_size=64, max_position_embeddings=128,
    type_vocab_size=2, fusion_layer=2, encoder_width=32,
    add_cross_attention=False)
N_EXPERTS, EP = 8, 4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """JAX's params and hidden states (tests/test_expert_parallel.py's
    fixture) and the port's block holding the same numbers."""
    cfg = JaxCfg(**TINY)
    params = jax.tree.map(np.asarray, jep.init_moe_params(
        jax.random.PRNGKey(0), cfg, N_EXPERTS))
    hidden = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 6, 32)))
    return {"cfg": cfg, "params": params, "hidden": hidden,
            "state": moe_state_dict_from_jax_tree(params)}


def port_block(state: dict) -> ep.MoEBlock:
    block = ep.MoEBlock(BertArchConfig(**TINY), N_EXPERTS)
    block.load_state_dict(state, strict=True)
    return block


@pytest.fixture(scope="module")
def ep_run(setup, tmp_path_factory):
    workdir = tmp_path_factory.mktemp("ep")
    scenarios = [dict(name=f"top{k}", kind="ep", top_k=k) for k in (1, 2)]
    torch.save({"ep": {"cfg": TINY, "state": setup["state"],
                       "n_experts": N_EXPERTS,
                       "hidden": torch.tensor(setup["hidden"])},
                "scenarios": scenarios}, workdir / "input.pt")
    run_ranks(workdir, world=EP, mode="blocks")
    return {sc["name"]: [torch.load(workdir / f"{sc['name']}_rank{r}.pt",
                                    weights_only=True) for r in range(EP)]
            for sc in scenarios}


@pytest.mark.parametrize("top_k,n_groups", [(1, 1), (2, 1), (2, 4)])
def test_moe_dense_matches_jax(setup, top_k, n_groups):
    want, want_aux = jep.moe_block(setup["params"], setup["cfg"],
                                   jnp.asarray(setup["hidden"]),
                                   top_k=top_k, capacity_factor=1.25,
                                   n_groups=n_groups)
    got, aux = ep.moe_block(port_block(setup["state"]),
                            BertArchConfig(**TINY),
                            torch.tensor(setup["hidden"]), top_k=top_k,
                            capacity_factor=1.25, n_groups=n_groups)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=0)
    for key in ("aux_loss", "dropped_frac"):
        np.testing.assert_allclose(aux[key].item(), float(want_aux[key]),
                                   atol=1e-6, rtol=0)


def test_moe_capacity_drop_passthrough(setup):
    """At one slot an expert most tokens are dropped and pass through the
    residual and LayerNorm unchanged: equal to JAX's, and each dropped
    token equals the LayerNorm of itself."""
    hidden = torch.tensor(setup["hidden"])
    cf = N_EXPERTS / 48.0                          # capacity exactly 1
    block = port_block(setup["state"])
    got, aux = ep.moe_block(block, BertArchConfig(**TINY), hidden, top_k=1,
                            capacity_factor=cf)
    want, want_aux = jep.moe_block(setup["params"], setup["cfg"],
                                   jnp.asarray(setup["hidden"]), top_k=1,
                                   capacity_factor=cf)
    assert aux["dropped_frac"].item() == float(want_aux["dropped_frac"]) > 0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=0)
    with torch.no_grad():
        alone = block.LayerNorm(hidden)
    same = torch.isclose(got, alone, atol=1e-6, rtol=0).all(-1)
    assert int(same.sum()) == round(48 * aux["dropped_frac"].item())


@pytest.mark.parametrize("top_k", [1, 2])
def test_ep_matches_jax_dense_grouped(setup, ep_run, top_k):
    """Four ranks, two experts each, each routing its 2 rows as one group:
    JAX's dense block with n_groups=4 on the whole batch."""
    want, want_aux = jep.moe_block(setup["params"], setup["cfg"],
                                   jnp.asarray(setup["hidden"]),
                                   top_k=top_k, n_groups=EP)
    want = np.asarray(want)
    for rank in ep_run[f"top{top_k}"]:
        a, b = rank["rows"]
        np.testing.assert_allclose(rank["out"].numpy(), want[a:b],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(rank["aux"]["aux_loss"].item(),
                                   float(want_aux["aux_loss"]), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(rank["aux"]["dropped_frac"].item(),
                                   float(want_aux["dropped_frac"]),
                                   atol=1e-6, rtol=0)


def test_ep_grads_match_jax(setup, ep_run):
    """The gradient of sum(out ** 2) + 0.01 * aux_loss through the two
    exchanges: the expert slabs' are each rank's own two experts', the
    router's and the LayerNorm's the sum over the ranks; all equal JAX's
    dense n_groups=4 gradient."""
    def loss(p, x):
        out, aux = jep.moe_block(p, setup["cfg"], x, top_k=2, n_groups=EP)
        return jnp.sum(out ** 2) + 0.01 * aux["aux_loss"]

    grads = jax.grad(loss)(jax.tree.map(jnp.asarray, setup["params"]),
                           jnp.asarray(setup["hidden"]))
    want = moe_state_dict_from_jax_tree(jax.tree.map(np.asarray, grads))
    ranks = ep_run["top2"]
    for name, g in want.items():
        parts = [r["grads"][name] for r in ranks]
        got = (torch.cat(parts) if name.startswith(("up_", "down_"))
               else sum(parts))
        np.testing.assert_allclose(got.numpy(), g.numpy(), atol=2e-4,
                                   rtol=1e-4, err_msg=name)


def test_routing_positions_exact_under_bf16():
    """512 bf16 tokens all routed to one expert land in 512 distinct slots:
    the positions are int32 cumsums (a bf16 one would collide past 256)."""
    probs = torch.zeros(512, 4)
    probs[:, 1] = 1.0
    dispatch, combine, aux = ep._top_k_dispatch(probs, 1, 512,
                                                dtype=torch.bfloat16)
    assert dispatch.dtype == combine.dtype == torch.bfloat16
    torch.testing.assert_close(dispatch.float().sum(0)[1], torch.ones(512),
                               atol=0, rtol=0)
    assert aux["dropped_frac"].item() == 0.0


def test_expert_capacity_matches_jax():
    for args in [(48, 8, 2, 1.25), (800, 8, 2, 1.25), (12, 8, 1, 1.0),
                 (6, 4, 1, 0.01), (100, 3, 2, 1.3)]:
        assert ep.expert_capacity(*args) == jep.expert_capacity(*args)
    assert ep.expert_capacity(800, 8, 2, 1.25) == 250


def test_top_k_exceeding_experts_raises(setup):
    with pytest.raises(ValueError, match="exceeds n_experts"):
        ep.moe_block(port_block(setup["state"]), BertArchConfig(**TINY),
                     torch.tensor(setup["hidden"]), top_k=N_EXPERTS + 1)


def test_ep_batch_not_divisible_raises():
    with pytest.raises(ValueError, match="not divisible by ep"):
        ep.ep_rows(6, 0, EP)
    assert ep.ep_rows(8, 3, EP) == slice(6, 8)


def test_experts_do_not_divide_raises():
    block = ep.init_moe_params(3, BertArchConfig(**TINY), 6, device=CPU)
    with pytest.raises(ValueError, match="experts do not divide"):
        ep.expert_shard(block, 0, EP)


def test_one_rank_exchange_is_the_dense_block(setup):
    """A group of one (None): every expert on this rank, the dense block
    of one group, values and auxiliaries."""
    block = port_block(setup["state"])
    hidden = torch.tensor(setup["hidden"])
    cfg = BertArchConfig(**TINY)
    got, aux = ep.expert_parallel_moe_block(block, cfg, hidden, None)
    want, want_aux = ep.moe_block(block, cfg, hidden, n_groups=1)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    for key in aux:
        torch.testing.assert_close(aux[key], want_aux[key], atol=0, rtol=0)
