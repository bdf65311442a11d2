"""Port parity: the fine-tune slice of spmm_tpu_torch vs spmm_tpu (MoleculeNet
models and steps, reaction training, schedules, metrics, dropout, the
drivers), on the same weights and inputs (tiny configs, numpy inputs from a
seed).

Bars (fp32; dropout rates 0 where JAX's step passes an rng, so that both
sides are deterministic):
- ``downstream_forward`` within 2e-5 for the three tasks, plain and kernel
  attention (its plain version on the CPU);
- ``downstream_loss`` / ``rxn_loss`` within 2e-5, every gradient within
  1e-5 + 1e-4 relative (the sums run in other orders);
- three AdamW steps (global steps 0, 1, 2, across the warmup and the
  cosine) of ``make_downstream_step`` / ``make_rxn_step`` against JAX's:
  every parameter within 1e-6 + 1e-5 relative, the reaction encoder's MLM
  head (which the loss does not reach) decayed as optax decays it;
- schedules: 1e-12 relative (the port computes in float64, JAX's
  ``reference_cosine_schedule`` in float32: 1e-6 there);
- metrics: 1e-12 against sklearn through the JAX functions.
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spmm_tpu.configs import BertArchConfig as JaxCfg
from spmm_tpu.configs import FinetuneConfig as JaxFcfg
from spmm_tpu.models import downstream as jdown
from spmm_tpu.models import rxn as jrxn
from spmm_tpu.training import finetune as jft
from spmm_tpu.training import schedules as jsched

from spmm_tpu_torch.checkpoint.convert import (
    downstream_state_dict_from_jax_tree, rxn_state_dict_from_jax_tree)
from spmm_tpu_torch.configs import BertArchConfig as TorchCfg
from spmm_tpu_torch.configs import FinetuneConfig
from spmm_tpu_torch.models.downstream import (
    Downstream, downstream_forward, downstream_loss, load_encoder_from_pretrain)
from spmm_tpu_torch.models.rxn import Rxn, rxn_loss
from spmm_tpu_torch.ops.attention import dropout, multi_head_attention
from spmm_tpu_torch.training import finetune, schedules

from torch_parity import TINY, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
# the text config: 3 layers, the first (fusion_layer=1) unimodal; the
# downstream encoder keeps 2 of them
TEXT = dict(TINY, fusion_layer=2, **NO_DROP)
ENC = dict(TINY, num_hidden_layers=2, fusion_layer=2, **NO_DROP)
N_OUT = {"classification": 2, "multilabel": 5, "regression": 1}
FCFG = dict(lr=1e-4, min_lr=1e-5, warmup_lr=2e-5, epochs=3, warmup_epochs=1,
            step_size=1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread is several times faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jcfg(**kw) -> JaxCfg:
    return JaxCfg(**{**TEXT, **kw}, add_cross_attention=True)


def tcfg(**kw) -> TorchCfg:
    return TorchCfg(**dataclasses.asdict(jcfg(**kw)))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def down_pair(task: str, seed: int = 0):
    tree = to_np(jdown.init_downstream_params(jax.random.PRNGKey(seed), task,
                                              jcfg(), N_OUT[task]))
    model = Downstream(task, tcfg(), N_OUT[task])
    model.load_state_dict(downstream_state_dict_from_jax_tree(tree, tcfg()),
                          strict=True)
    return tree, model


def down_batch(task: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 300, size=(6, 20)).astype(np.int32)
    ids[:, 0] = 2
    lens = np.array([20, 13, 7, 20, 4, 16])
    mask = (np.arange(20)[None] < lens[:, None]).astype(np.int32)
    ids = ids * mask
    target = {"classification": rng.integers(0, 2, size=6).astype(np.int32),
              "multilabel": rng.integers(0, 2, size=(6, 5)).astype(
                  np.float32),
              "regression": rng.normal(size=6).astype(np.float32)}[task]
    return ids, mask, target


def torch_target(task, target):
    return t(target, torch.int64 if task == "classification" else None)


def assert_grads_match(model, want_state, tol=1e-5):
    for name, p in model.named_parameters():
        want = want_state[name]
        if p.grad is None:
            assert not want.any(), name
            continue
        torch.testing.assert_close(p.grad, want, atol=tol, rtol=1e-4,
                                   msg=name)


def assert_params_match(model, want_state):
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), want_state[name], atol=1e-6,
                                   rtol=1e-5, msg=name)


def test_finetune_config_matches_jax():
    assert dataclasses.asdict(FinetuneConfig()) == dataclasses.asdict(
        JaxFcfg())


def test_bridge_checks_layer_counts():
    tree, _ = down_pair("classification")
    with pytest.raises(ValueError, match="encoder has 2 layers"):
        downstream_state_dict_from_jax_tree(tree, tcfg(fusion_layer=1))
    assert set(downstream_state_dict_from_jax_tree(tree, tcfg())) == set(
        Downstream("classification", tcfg()).state_dict())


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("task", ["classification", "multilabel",
                                  "regression"])
def test_downstream_forward_matches_jax(task, impl):
    tree, model = down_pair(task)
    ids, mask, _ = down_batch(task)
    want = jdown.downstream_forward(jax.tree.map(jnp.asarray, tree), jcfg(),
                                    jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = downstream_forward(model, t(ids), t(mask), attention_impl=impl)
    assert got.shape == (6, N_OUT[task])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("task", ["classification", "multilabel",
                                  "regression"])
def test_downstream_loss_and_grads_match_jax(task):
    tree, model = down_pair(task, seed=1)
    ids, mask, target = down_batch(task, seed=1)
    loss, grads = jax.jit(jax.value_and_grad(jdown.downstream_loss),
                          static_argnums=(1, 2))(
        jax.tree.map(jnp.asarray, tree), jcfg(), task, jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(target))
    got = downstream_loss(model, t(ids), t(mask), torch_target(task, target))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), atol=2e-5, rtol=0)
    assert_grads_match(model, downstream_state_dict_from_jax_tree(
        to_np(grads), tcfg()))


def test_multilabel_loss_saturates_as_jax():
    """The 1e-12-eps BCE, not binary_cross_entropy_with_logits: where
    sigmoid saturates the two differ, and the port follows JAX."""
    tree, model = down_pair("multilabel", seed=2)
    with torch.no_grad():
        model.l2.bias.fill_(40.0)
        tree["head"]["l2"]["b"] = np.full_like(tree["head"]["l2"]["b"], 40.0)
    ids, mask, target = down_batch("multilabel", seed=2)
    want = jdown.downstream_loss(jax.tree.map(jnp.asarray, tree), jcfg(),
                                 "multilabel", jnp.asarray(ids),
                                 jnp.asarray(mask), jnp.asarray(target))
    with torch.no_grad():
        got = downstream_loss(model, t(ids), t(mask), t(target))
        logits = downstream_forward(model, t(ids), t(mask))
        bce = torch.nn.functional.binary_cross_entropy_with_logits(
            logits, t(target))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert abs(got.item() - bce.item()) > 1.0


@pytest.mark.parametrize("task", ["classification", "multilabel",
                                  "regression"])
def test_downstream_steps_match_jax(task):
    """Global steps 0, 1, 2 (steps_per_epoch 2, step_size 1): the warmup
    lr, the cosine's base lr, then epoch 1's; AdamW equal to optax.adamw."""
    tree, model = down_pair(task, seed=3)
    fj, ft = JaxFcfg(**FCFG), FinetuneConfig(**FCFG)
    tx, jstep = jft.make_downstream_step(task, fj, 2, jcfg())
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(params)
    _, step = finetune.make_downstream_step(model, ft, 2)
    for gs in range(3):
        ids, mask, target = down_batch(task, seed=10 + gs)
        params, opt_state, jm = jstep(
            params, opt_state, jnp.int32(gs),
            {"ids": jnp.asarray(ids), "mask": jnp.asarray(mask),
             "target": jnp.asarray(target)}, jax.random.PRNGKey(gs))
        m = step(gs, {"ids": t(ids), "mask": t(mask),
                      "target": torch_target(task, target)})
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   atol=2e-5, rtol=0)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-6)
    assert_params_match(model, downstream_state_dict_from_jax_tree(
        to_np(params), tcfg()))


def rxn_configs():
    dc = JaxCfg(**{**TINY, **NO_DROP}, add_cross_attention=True)
    ec = JaxCfg(**ENC, add_cross_attention=False)
    return (dc, ec), tuple(TorchCfg(**dataclasses.asdict(c))
                           for c in (dc, ec))


def rxn_pair(seed: int = 0):
    (dc, ec), (tdc, tec) = rxn_configs()
    tree = to_np(jrxn.init_rxn_params(jax.random.PRNGKey(seed), dc, ec))
    model = Rxn(tdc, tec)
    model.load_state_dict(rxn_state_dict_from_jax_tree(tree, tdc, tec),
                          strict=True)
    return tree, model


def rxn_batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    out = {}
    for name, (n, lens) in (("src", (24, [24, 17, 9, 20])),
                            ("tgt", (16, [16, 11, 5, 13]))):
        ids = rng.integers(4, 300, size=(4, n)).astype(np.int32)
        ids[:, 0] = 2
        mask = (np.arange(n)[None] < np.array(lens)[:, None]).astype(np.int32)
        out[f"{name}_ids"], out[f"{name}_mask"] = ids * mask, mask
    return out


def test_rxn_loss_and_grads_match_jax():
    tree, model = rxn_pair(1)
    (dc, ec), (tdc, tec) = rxn_configs()
    b = rxn_batch(1)
    loss, grads = jax.jit(jax.value_and_grad(jrxn.rxn_loss),
                          static_argnums=(1, 2))(
        jax.tree.map(jnp.asarray, tree), dc, ec,
        *(jnp.asarray(b[k]) for k in ("src_ids", "src_mask", "tgt_ids",
                                      "tgt_mask")))
    got = rxn_loss(model, *(t(b[k]) for k in ("src_ids", "src_mask",
                                              "tgt_ids", "tgt_mask")))
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), atol=2e-5, rtol=0)
    want = rxn_state_dict_from_jax_tree(to_np(grads), tdc, tec)
    assert_grads_match(model, want)
    # the tied word table's gradient sums the embedding and the LM head
    assert model.text_encoder.cls.predictions.decoder.weight is \
        model.text_encoder.bert.embeddings.word_embeddings.weight
    # the encoder's MLM head is not on the loss's path
    assert model.text_encoder2.cls.predictions.transform.dense.weight.grad \
        is None


def test_rxn_steps_match_jax_and_decay_the_unused_head():
    tree, model = rxn_pair(2)
    (dc, ec), (tdc, tec) = rxn_configs()
    fj, ft = JaxFcfg(**FCFG), FinetuneConfig(**FCFG)
    tx, jstep = jft.make_rxn_step(fj, 2, dc, ec)
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(params)
    _, step = finetune.make_rxn_step(model, ft, 2)
    head = "text_encoder2.cls.predictions.transform.dense.weight"
    before = model.state_dict()[head].clone()
    lrs = []
    for gs in range(3):
        b = rxn_batch(20 + gs)
        params, opt_state, jm = jstep(
            params, opt_state, jnp.int32(gs),
            {k: jnp.asarray(v) for k, v in b.items()},
            jax.random.PRNGKey(gs))
        m = step(gs, {k: t(v) for k, v in b.items()})
        lrs.append(m["lr"])
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   atol=2e-5, rtol=0)
    want = rxn_state_dict_from_jax_tree(to_np(params), tdc, tec)
    assert_params_match(model, want)
    decay = np.prod([1.0 - lr * ft.weight_decay for lr in lrs])
    torch.testing.assert_close(model.state_dict()[head], before * decay,
                               atol=1e-7, rtol=1e-6)


def test_load_encoder_from_pretrain_matches_jax():
    from spmm_tpu.checkpoint.export import export_spmm_state_dict
    from spmm_tpu.models.spmm import init_spmm_params

    full = jcfg()
    prop = JaxCfg(**dict(TINY, vocab_size=1, num_hidden_layers=2,
                         fusion_layer=2), add_cross_attention=False)
    pretrain = to_np(init_spmm_params(jax.random.PRNGKey(7), full, prop))
    state = {k.replace("_mask", "_unk"): np.array(v, np.float32)
             for k, v in export_spmm_state_dict(pretrain, full, prop).items()}
    tree, model = down_pair("regression", seed=4)
    want = to_np(jdown.load_encoder_from_pretrain(tree, state, full))
    load_encoder_from_pretrain(model, {k: torch.from_numpy(v)
                                       for k, v in state.items()})
    want_state = downstream_state_dict_from_jax_tree(want, tcfg())
    for k, v in model.state_dict().items():
        assert torch.equal(v, want_state[k]), k
    del state["text_encoder.bert.encoder.layer.1.output.dense.bias"]
    with pytest.raises(KeyError, match="layer.1.output.dense.bias"):
        load_encoder_from_pretrain(model, {k: torch.from_numpy(v)
                                           for k, v in state.items()})


def test_random_init_is_seeded_with_torch_linear_bounds():
    a = Downstream.random_init(3, "regression", tcfg(), device="cpu")
    b = Downstream.random_init(3, "regression", tcfg(), device="cpu")
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    h = tcfg().hidden_size
    assert a.l1.weight.shape == (2 * h, h) and a.l2.weight.shape == (1, 2 * h)
    assert a.l1.weight.abs().max() <= h ** -0.5
    assert a.l2.bias.abs().max() <= (2 * h) ** -0.5
    assert not a.text_encoder.bert.embeddings.word_embeddings.weight[0].any()


# --------------------------------------------------------------------------- #
# dropout
# --------------------------------------------------------------------------- #


def test_dropout_is_reproducible_scaled_and_off_without_a_generator():
    x = torch.ones(200_000)
    a = dropout(x, 0.1, torch.Generator().manual_seed(5))
    b = dropout(x, 0.1, torch.Generator().manual_seed(5))
    c = dropout(x, 0.1, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = (a != 0).float().mean().item()
    # binomial std of the kept share: sqrt(0.9 * 0.1 / 2e5) = 6.7e-4
    assert abs(kept - 0.9) < 5 * 6.7e-4
    assert torch.allclose(a[a != 0], torch.full_like(a[a != 0], 1 / 0.9))
    assert dropout(x, 0.1, None) is x and dropout(x, 0.0, torch.Generator()) \
        is x
    # the global RNG is not drawn from
    state = torch.random.get_rng_state()
    dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert torch.equal(state, torch.random.get_rng_state())


def test_attention_dropout_and_the_kernel_refusing_it():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 5, 8, generator=g) for _ in range(3))
    plain = multi_head_attention(q, k, v)
    dropped = multi_head_attention(q, k, v, dropout_rate=0.5,
                                   generator=torch.Generator().manual_seed(1))
    assert not torch.allclose(plain, dropped)
    assert torch.equal(multi_head_attention(q, k, v, dropout_rate=0.5),
                       plain)
    with pytest.raises(ValueError, match="no dropout"):
        multi_head_attention(q, k, v, impl="kernel", dropout_rate=0.1,
                             generator=torch.Generator())


def test_model_dropout_needs_a_generator():
    """Inference is unchanged whatever train()/eval() say; a generator turns
    dropout on at the configured rates; a seed reproduces it."""
    _, model = down_pair("classification")
    ids, mask, _ = down_batch("classification")
    with torch.no_grad():
        base = downstream_forward(model, t(ids), t(mask))
        model.train()
        assert torch.equal(downstream_forward(model, t(ids), t(mask)), base)
        # rates 0 in TEXT: a generator alone changes nothing
        assert torch.equal(downstream_forward(
            model, t(ids), t(mask), generator=torch.Generator()), base)
    dmodel = Downstream("classification", tcfg(hidden_dropout_prob=0.1,
                                               attention_probs_dropout_prob=0.1))
    dmodel.load_state_dict(model.state_dict())
    with torch.no_grad():
        runs = [downstream_forward(dmodel, t(ids), t(mask),
                                   generator=torch.Generator().manual_seed(s))
                for s in (1, 1, 2)]
        assert torch.equal(downstream_forward(dmodel, t(ids), t(mask)), base)
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


# --------------------------------------------------------------------------- #
# schedules and metrics
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("warmup_epochs,step_size", [(1, 3), (2, 2), (0, 5)])
def test_reference_cosine_schedule_matches_jax(warmup_epochs, step_size):
    args = (3e-5, 5e-6, 5e-6, 4, warmup_epochs, 7)
    want = jsched.reference_cosine_schedule(*args, step_size=step_size)
    got = schedules.reference_cosine_schedule(*args, step_size=step_size)
    values = [got(s) for s in range(4 * 7 + 3)]
    np.testing.assert_allclose(values, [float(want(s)) for s in range(31)],
                               rtol=1e-6)
    assert len(set(values)) > 3


def _sched_args(sched, **kw):
    return types.SimpleNamespace(
        sched=sched, epochs=12, min_lr=1e-5, decay_rate=0.5, warmup_lr=1e-6,
        warmup_epochs=3, cooldown_epochs=2, lr=1e-3, decay_epochs=4,
        patience_epochs=1, seed=7, **kw)


@pytest.mark.parametrize("sched,kw", [
    ("cosine", {}), ("cosine", {"lr_cycle_mul": 2.0, "lr_cycle_limit": 3}),
    ("cosine", {"lr_noise": [0.25, 0.75], "lr_noise_pct": 0.5}),
    ("tanh", {}), ("tanh", {"lr_noise": 0.5}), ("step", {}),
    ("step", {"lr_noise": [0.5]}), ("plateau", {"eval_metric": "loss"}),
])
def test_timm_schedules_match_jax(sched, kw):
    got, n_got = schedules.create_scheduler(_sched_args(sched, **kw))
    want, n_want = jsched.create_scheduler(_sched_args(sched, **kw))
    assert n_got == n_want
    if sched == "plateau":
        metrics = [1.0, 0.9, 0.95, 0.97, 0.96, 0.5, 0.6, 0.7, 0.8, 0.9]
        assert [got.step(e, m) for e, m in enumerate(metrics)] == \
            [want.step(e, m) for e, m in enumerate(metrics)]
        return
    np.testing.assert_allclose([got(e) for e in range(n_got + 3)],
                               [want(e) for e in range(n_got + 3)],
                               rtol=1e-12)


def test_timm_classes_match_jax():
    for kw in ({"warmup_prefix": False}, {"warmup_prefix": True}):
        for name in ("CosineSchedule", "TanhSchedule"):
            a = getattr(schedules, name)(base_lr=1e-3, warmup_t=2,
                                         warmup_lr_init=1e-5, t_initial=5,
                                         t_mul=1.5, decay_rate=0.7,
                                         lr_min=1e-6, cycle_limit=2, **kw)
            b = getattr(jsched, name)(**dataclasses.asdict(a))
            assert [a(e) for e in range(20)] == [b(e) for e in range(20)]
            assert a.get_cycle_length(3) == b.get_cycle_length(3)
    for kind in ("normal", "uniform"):
        assert [schedules._timm_noise(e, 3, 0.6, kind) for e in range(5)] == \
            [jsched._timm_noise(e, 3, 0.6, kind) for e in range(5)]


def test_metrics_match_jax_with_ties():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, size=(60, 3))
    scores = np.round(rng.random((60, 3)), 1)          # many tied scores
    for j in range(3):
        assert abs(finetune.auroc(labels[:, j], scores[:, j])
                   - jft.auroc(labels[:, j], scores[:, j])) < 1e-12
    assert abs(finetune.macro_auroc(labels, scores)
               - jft.macro_auroc(labels, scores)) < 1e-12
    assert finetune.auroc([3, 7, 7, 3], [0.1, 0.4, 0.4, 0.4]) == \
        jft.auroc(np.array([3, 7, 7, 3]), np.array([0.1, 0.4, 0.4, 0.4]))
    with pytest.raises(ValueError):
        finetune.auroc([1, 1, 1], [0.1, 0.2, 0.3])
    preds, targets = rng.normal(size=9), rng.normal(size=9)
    assert abs(finetune.rmse(preds, targets, 2.0, 3.0)
               - jft.rmse(preds, targets, 2.0, 3.0)) < 1e-12


def test_classification_scores_match_jax():
    from spmm_tpu_torch.data.pipeline import batch_supervised
    from spmm_tpu_torch.tokenizer import SmilesTokenizer

    tree, model = down_pair("classification", seed=5)
    texts = ["[CLS]" + s for s in _smiles(9)]
    targets = np.arange(9) % 2
    batches = list(batch_supervised(SmilesTokenizer(), texts, targets, 4))
    want = jft.classification_scores(jax.tree.map(jnp.asarray, tree), jcfg(),
                                     batches)
    got = finetune.classification_scores(model, batches)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=2e-5, rtol=0)


# --------------------------------------------------------------------------- #
# the fine-tune loops end to end on the CPU
# --------------------------------------------------------------------------- #


def _smiles(n):
    with open(os.path.join(REPO, "examples", "s2p_input.txt")) as f:
        smiles = [line.strip() for line in f if line.strip()]
    return [smiles[i % len(smiles)] for i in range(n)]


def test_eval_metric_matches_jax_driver():
    """The fine-tune eval of both packages on the same weights: predictions
    through kernel 2's plain version, no truncation (one SMILES past the
    100 bucket), and each task's metric."""
    from spmm_tpu.cli import _finetune_driver as jdrv
    from spmm_tpu.data.datasets import SupervisedDataset as JDs
    from spmm_tpu.tokenizer import SmilesTokenizer as JTok

    from spmm_tpu_torch.cli import _finetune_driver as drv
    from spmm_tpu_torch.data.datasets import SupervisedDataset
    from spmm_tpu_torch.tokenizer import SmilesTokenizer

    texts = ["[CLS]" + s for s in _smiles(11)]
    texts[3] = "[CLS]" + ".".join(_smiles(6))           # past 100 tokens
    rng = np.random.default_rng(0)
    for task in ("classification", "multilabel", "regression"):
        tree, model = down_pair(task, seed=6)
        target = {"classification": np.arange(11) % 2,
                  "multilabel": (rng.random((11, 5)) > 0.5).astype(
                      np.float32),
                  "regression": rng.normal(size=11).astype(np.float32)}[task]
        target[:2] = 1 - target[2:4] if task == "multilabel" else target[:2]
        kw = dict(value_mean=1.5, value_std=2.0)
        jp, jt = jdrv.evaluate_scores(jax.tree.map(jnp.asarray, tree),
                                      jcfg(), JTok(), JDs(texts, target, **kw),
                                      task, batch_size=4)
        ds = SupervisedDataset(texts, target, **kw)
        gp, gt = drv.evaluate_scores(model, SmilesTokenizer(), ds,
                                     batch_size=4)
        np.testing.assert_allclose(gp, jp, atol=2e-5, rtol=0)
        np.testing.assert_array_equal(gt, jt)
        want = jdrv.eval_metric(jax.tree.map(jnp.asarray, tree), jcfg(),
                                JTok(), JDs(texts, target, **kw), task,
                                batch_size=4)
        got = drv.eval_metric(model, SmilesTokenizer(), ds, task,
                              batch_size=4)
        assert abs(got - want) < 1e-5


def _write_csv(path, header, rows):
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for row in rows:
            f.write(",".join(str(v) for v in row) + "\n")


@pytest.fixture
def tiny_text_config(monkeypatch):
    from spmm_tpu_torch.cli import _finetune_driver as drv

    monkeypatch.setattr(drv, "text_config", lambda: TorchCfg(
        **dict(TINY, fusion_layer=2)))


@pytest.mark.parametrize("cli_name,name,header,target", [
    ("classification", "bbbp", ["smiles", "p_np"], lambda i: i % 2),
    ("classification_multilabel", "clintox",
     ["smiles", "FDA_APPROVED", "CT_TOX"], lambda i: f"{i % 2},{(i // 2) % 2}"),
    ("regression", "esol", ["smiles",
                            "ESOL predicted log solubility in mols per litre"],
     lambda i: -2.5 + 0.3 * i),
])
def test_finetune_clis_run_on_cpu(tmp_path, tiny_text_config, cli_name, name,
                                  header, target):
    import importlib

    cli = importlib.import_module(f"spmm_tpu_torch.cli.{cli_name}")
    _, files = cli.DATASETS[name]
    rows = [[s, target(i)] for i, s in enumerate(_smiles(12))]
    for f in files:
        _write_csv(tmp_path / f, header, rows)
    out = tmp_path / "out"
    cli.main(["--name", name, "--data_dir", str(tmp_path), "--epoch", "2",
              "--batch_size", "4", "--device", "cpu", "--output_dir",
              str(out)])
    result = json.loads((out / "result.json").read_text())
    assert result["steps"] == 6 and len(result["epochs"]) == 2
    assert result["device"] == "cpu" and np.isfinite(result["best_test"])
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 6 and all(
        np.isfinite(json.loads(line)["loss"]) for line in lines)


def test_rxn_cli_trains_on_cpu(tmp_path, monkeypatch):
    """cli.rxn_prediction without --evaluate: one epoch over a tiny
    USPTO-480k directory, eval after it, the best state saved and read back
    strictly; result.json with JAX's keys."""
    from spmm_tpu_torch.cli import rxn_prediction

    (_, _), (tdc, tec) = rxn_configs()
    real = Rxn.random_init.__func__
    monkeypatch.setattr(Rxn, "random_init", classmethod(
        lambda cls, seed, device=None: real(cls, seed, tdc, tec,
                                            device=device)))
    data = tmp_path / "USPTO-480k"
    data.mkdir()
    pairs = [".".join(_smiles(i + 2)[i:]) + "\t" + _smiles(i + 1)[i]
             for i in range(10)]
    for split in ("train", "valid", "test"):
        (data / f"{split}_parsed.txt").write_text("\n".join(pairs) + "\n")
    out = tmp_path / "out"
    rxn_prediction.main(["--data_dir", str(tmp_path), "--output_dir",
                         str(out), "--epoch", "1", "--batch_size", "4",
                         "--n_beam", "1", "--seed", "3", "--device", "cpu"])
    result = json.loads((out / "result.json").read_text())
    assert set(result) >= {"best_valid_acc", "best_test_acc", "epochs",
                           "steps", "n_beam", "mode"}
    assert result["steps"] == 2 and result["n_beam"] == 1
    assert len((out / "metrics.jsonl").read_text().splitlines()) == 2
    model = Rxn(tdc, tec)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rxn_prediction.load_rxn_checkpoint(model, str(out / "checkpoint_best.pt"))
    assert any(not torch.equal(v, before[k])
               for k, v in model.state_dict().items())
