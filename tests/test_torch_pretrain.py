"""Port parity: pretraining (spmm_tpu_torch.training.pretrain) against
spmm_tpu.training.pretrain on the same weights, batch and injected noise,
with the JAX suite's tiny configs (tests/test_pretrain.py:19-28: hidden 32,
4 text and 2 property layers, embed 16, queue 64).

The JAX state comes from ``init_pretrain_state``; ``property_cls`` /
``property_mask`` (zero at init) are randomized and the EMA is moved off
the online weights, so that every piece is seen.  It is carried to the port
by ``checkpoint.convert.pretrain_state_dict_from_jax`` and
``load_state_dict(strict=True)``.

Bars (fp32, dropout off on both sides unless said):
- the four losses within atol 2e-4, rtol 1e-4 of JAX's ``pretrain_loss``
  (the bar of tests/test_pretrain_loss_parity.py:230), every gradient,
  ``temp``'s included, within the same bars of ``jax.grad``;
- three steps (accum 1 and 2, each microbatch's noise fixed) against a JAX
  oracle of ``ema_update``, ``jax.value_and_grad(pretrain_loss)``,
  ``make_optimizer(pcfg).update`` and the step's scatter: parameters within
  1e-6 + 1e-5 relative (the fine-tune steps' bar), EMA, queues, ``ptr``
  and ``temp``;
- remat within 1e-4 of no remat (tests/test_pretrain.py:138); with dropout
  on and one generator seed, gradients with remat within 1e-5 of those
  without (a recompute that drew new masks would miss by far more);
- bf16_compute within 0.2 of fp32 (tests/test_pretrain.py:121-139).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from spmm_tpu.configs import BertArchConfig as JaxCfg
from spmm_tpu.configs import PretrainConfig as JaxPcfg
from spmm_tpu.training import pretrain as jpre
from spmm_tpu.training.schedules import reference_cosine_schedule

from spmm_tpu_torch.checkpoint.convert import (
    pretrain_state_dict_from_jax, state_dict_from_jax_tree)
from spmm_tpu_torch.configs import BertArchConfig as TorchCfg
from spmm_tpu_torch.configs import PretrainConfig
from spmm_tpu_torch.training import pretrain

from torch_parity import t

TINY = dict(
    vocab_size=300, hidden_size=32, num_hidden_layers=4,
    num_attention_heads=4, intermediate_size=64, max_position_embeddings=64,
    type_vocab_size=2, fusion_layer=2, encoder_width=32,
)
JTEXT = JaxCfg(**TINY, add_cross_attention=True)
JPROP = JaxCfg(**{**TINY, "vocab_size": 1, "num_hidden_layers": 2},
               add_cross_attention=False)
TTEXT, TPROP = (TorchCfg(**dataclasses.asdict(c)) for c in (JTEXT, JPROP))
# embed 16, queue 64 as the JAX suite's; a larger lr and a grad clip of 1
# so that three steps move the weights and the clip acts
PCFG = dict(embed_dim=16, queue_size=64, batch_size=2, warmup_epochs=2,
            lr=1e-3, warmup_lr=2e-4, min_lr=1e-4, grad_clip=1.0)
STEPS_PER_EPOCH = 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread is several times faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pcfgs(**kw):
    return JaxPcfg(**PCFG, **kw), PretrainConfig(**PCFG, **kw)


def jax_state(seed: int = 0, ptr: int = 0) -> dict:
    """{"params", "ema", "queue"} of JAX's init, numpy leaves, with
    property_cls / property_mask randomized and the EMA moved off the
    online weights."""
    st = jpre.init_pretrain_state(jax.random.PRNGKey(seed), pcfgs()[0],
                                  JTEXT, JPROP)
    st = jax.tree.map(np.asarray, {k: st[k] for k in ("params", "ema",
                                                      "queue")})
    rng = np.random.default_rng(seed + 100)
    for name in ("property_cls", "property_mask"):
        st["params"][name] = rng.normal(size=(1, 1, 32)).astype(np.float32)
    st["ema"] = jax.tree.map(
        lambda x: (x + 0.02 * rng.normal(size=x.shape)).astype(np.float32),
        st["ema"])
    st["queue"]["ptr"] = np.asarray(ptr, np.int32)
    return st


def port_state(st: dict, **kw) -> pretrain.PretrainModel:
    model = pretrain.PretrainModel(TTEXT, TPROP, 16, 64)
    model.load_state_dict(pretrain_state_dict_from_jax(st, TTEXT, TPROP),
                          strict=True)
    return model


def make_batch(seed: int, bs: int = 4, length: int = 12) -> dict:
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 300, size=(bs, length)).astype(np.int32)
    ids[:, 0] = 2
    lens = rng.integers(3, length + 1, size=bs)
    lens[0] = length
    mask = (np.arange(length)[None] < lens[:, None]).astype(np.int32)
    return {"prop": rng.normal(size=(bs, 53)).astype(np.float32),
            "ids": ids * mask, "mask": mask}


def make_noise(seed: int, bs: int = 4, micro: int = None) -> dict:
    """A property mask and hard negatives that index within each
    microbatch of ``micro`` rows, never the row itself."""
    rng = np.random.default_rng(seed + 50)
    micro = micro or bs
    local = np.arange(bs) % micro
    return {"mpm_mask": (rng.random((bs, 53)) < 0.5).astype(np.float32),
            "neg_prop_idx": ((local + 1) % micro).astype(np.int32),
            "neg_text_idx": ((local + micro - 1) % micro).astype(np.int32)}


def jnp_tree(x):
    return jax.tree.map(jnp.asarray, x)


def torch_tree(x):
    return {k: t(v) for k, v in x.items()}


def jax_value_and_grad(st, batch, noise, alpha, jp):
    fn = jax.jit(jax.value_and_grad(jpre.pretrain_loss, has_aux=True),
                 static_argnums=(6, 7, 8, 9))
    return fn(jnp_tree(st["params"]), jnp_tree(st["ema"]),
              jnp_tree(st["queue"]), jnp_tree(batch), jax.random.PRNGKey(0),
              jnp.float32(alpha), JTEXT, JPROP, jp, True, jnp_tree(noise))


def grads_by_name(grads) -> dict:
    want = state_dict_from_jax_tree(jax.tree.map(np.asarray, grads),
                                    TTEXT, TPROP)
    want["temp"] = t(np.asarray(grads["temp"]))
    return want


def assert_grads_match(model, want, atol=2e-4, rtol=1e-4):
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        torch.testing.assert_close(got, want[name], atol=atol, rtol=rtol,
                                   msg=name)


def test_pretrain_config_matches_jax():
    assert dataclasses.asdict(PretrainConfig()) == dataclasses.asdict(
        JaxPcfg())


@pytest.mark.parametrize("alpha", [0.0, 0.4])
def test_losses_and_grads_match_jax(alpha):
    jp, tp = pcfgs()
    st = jax_state(1)
    batch, noise = make_batch(1), make_noise(1)
    (total, aux), grads = jax_value_and_grad(st, batch, noise, alpha, jp)
    model = port_state(st)
    got, got_aux = pretrain.pretrain_loss(model, torch_tree(batch), alpha, tp,
                                          noise_override=torch_tree(noise))
    got.backward()
    for key in pretrain.LOSS_KEYS:
        np.testing.assert_allclose(got_aux[key].item(), float(aux[key]),
                                   atol=2e-4, rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(got.item(), float(total), atol=2e-4,
                               rtol=1e-4)
    for key in ("prop_feat_m", "text_feat_m"):
        torch.testing.assert_close(got_aux[key], t(aux[key]), atol=1e-5,
                                   rtol=1e-5)
    assert_grads_match(model, grads_by_name(grads))
    assert model.temp.grad.abs().item() > 0


def jax_oracle_steps(st, batches, noises, jp, accum):
    """ema_update, value_and_grad over ``accum`` microbatches (mean),
    make_optimizer(pcfg).update with the schedule's lr, the temp clip and
    the modular queue scatter, as make_pretrain_step runs them."""
    params, ema, queue = (jnp_tree(st[k]) for k in ("params", "ema",
                                                    "queue"))
    tx = jpre.make_optimizer(jp)
    opt_state = tx.init(params)
    schedule = reference_cosine_schedule(
        jp.lr, jp.min_lr, jp.warmup_lr, jp.epochs, jp.warmup_epochs,
        STEPS_PER_EPOCH, step_size=100)
    vg = jax.jit(jax.value_and_grad(jpre.pretrain_loss, has_aux=True),
                 static_argnums=(6, 7, 8, 9))
    losses = []
    for step, (batch, noise) in enumerate(zip(batches, noises)):
        epoch, idx = divmod(step, STEPS_PER_EPOCH)
        alpha = jp.alpha if epoch else jp.alpha * min(1.0, idx /
                                                      STEPS_PER_EPOCH)
        ema = jpre.ema_update(ema, params, jp.momentum)
        gb = batch["prop"].shape[0]
        mb = gb // accum
        g_sum, l_sum, feats = None, 0.0, []
        for i in range(accum):
            rows = slice(i * mb, (i + 1) * mb)
            (loss, aux), g = vg(params, ema, queue,
                                jnp_tree({k: v[rows] for k, v in
                                          batch.items()}),
                                jax.random.PRNGKey(0), jnp.float32(alpha),
                                JTEXT, JPROP, jp, True,
                                jnp_tree({k: v[rows] for k, v in
                                          noise.items()}))
            g_sum = g if g_sum is None else jax.tree.map(jnp.add, g_sum, g)
            l_sum += float(loss)
            feats.append((aux["prop_feat_m"], aux["text_feat_m"]))
        grads = jax.tree.map(lambda x: x / accum, g_sum)
        losses.append(l_sum / accum)
        opt_state.hyperparams["learning_rate"] = schedule(step)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        params["temp"] = jnp.clip(params["temp"], 0.01, 0.5)
        cols = (queue["ptr"] + jnp.arange(gb)) % jp.queue_size
        queue = {
            "prop": queue["prop"].at[:, cols].set(
                jnp.concatenate([f[0] for f in feats]).T),
            "text": queue["text"].at[:, cols].set(
                jnp.concatenate([f[1] for f in feats]).T),
            "ptr": (queue["ptr"] + gb) % jp.queue_size}
    return jax.tree.map(np.asarray, {"params": params, "ema": ema,
                                     "queue": queue}), losses


@pytest.mark.parametrize("accum", [1, 2])
def test_three_steps_match_jax(accum):
    """Steps 0, 1, 2 at steps_per_epoch 2: alpha 0, 0.2 then 0.4; the
    warmup lr then the cosine; a queue pointer of 61 that the batch of 4
    does not divide, so the writes wrap round the queue's end."""
    jp, tp = pcfgs()
    st = jax_state(2, ptr=61)
    batches = [make_batch(10 + s) for s in range(3)]
    noises = [make_noise(10 + s, micro=4 // accum) for s in range(3)]
    want, want_losses = jax_oracle_steps(st, batches, noises, jp, accum)

    model = port_state(st)
    _, step = pretrain.make_pretrain_step(model, tp, STEPS_PER_EPOCH,
                                          accum=accum)
    norms = []
    for s in range(3):
        m = step(s, torch_tree(batches[s]), noise=torch_tree(noises[s]))
        assert not m["skipped"]
        np.testing.assert_allclose(m["loss"].item(), want_losses[s],
                                   atol=2e-4, rtol=1e-4)
        norms.append(m["grad_norm"].item())
    assert max(norms) > tp.grad_clip          # the clip acted
    got = model.state_dict()
    for name, val in pretrain_state_dict_from_jax(want, TTEXT,
                                                  TPROP).items():
        if name == "queue_ptr":
            assert got[name].tolist() == val.tolist() == [(61 + 12) % 64]
        elif name.endswith("_queue"):
            torch.testing.assert_close(got[name], val, atol=1e-5, rtol=1e-5,
                                       msg=name)
        else:
            torch.testing.assert_close(got[name], val, atol=1e-6, rtol=1e-5,
                                       msg=name)


def test_nan_loss_skips_optimizer_and_queue_but_not_ema():
    """tests/test_pretrain.py:105-118's case: a NaN property."""
    _, tp = pcfgs()
    model = port_state(jax_state(3, ptr=8))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, step = pretrain.make_pretrain_step(model, tp, STEPS_PER_EPOCH)
    batch = make_batch(5)
    batch["prop"][0, 0] = np.nan
    m = step(1, torch_tree(batch), noise=torch_tree(make_noise(5)))
    assert m["skipped"] and not np.isfinite(m["loss"].item())
    after = model.state_dict()
    for name, val in before.items():
        if name.split(".", 1)[0] in {f"{k}_m" for k in pretrain.EMA_KEYS}:
            continue
        assert torch.equal(after[name], val), name
    # the EMA still moved toward the online weights
    assert not torch.equal(after["text_proj_m.weight"],
                           before["text_proj_m.weight"])
    assert model.queue_ptr.tolist() == [8]


def test_queue_write_wraps_from_an_unaligned_pointer():
    """ptr 62, batch 4: columns 62, 63, 0, 1 take the momentum features in
    batch order, ptr becomes 2, every other column is untouched."""
    _, tp = pcfgs()
    model = port_state(jax_state(4, ptr=62))
    prop_q, text_q = model.prop_queue.clone(), model.text_queue.clone()
    batch, noise = make_batch(6), make_noise(6)
    # the step's momentum features: its EMA, the online embedding before
    # the update
    ref = copy.deepcopy(model)
    pretrain.ema_update(ref, tp.momentum)
    _, aux = pretrain.pretrain_loss(ref, torch_tree(batch), 0.0, tp,
                                    noise_override=torch_tree(noise))
    _, step = pretrain.make_pretrain_step(model, tp, STEPS_PER_EPOCH)
    step(0, torch_tree(batch), noise=torch_tree(noise))
    cols = [62, 63, 0, 1]
    assert model.queue_ptr.tolist() == [2]
    keep = [c for c in range(64) if c not in cols]
    assert torch.equal(model.prop_queue[:, keep], prop_q[:, keep])
    assert torch.equal(model.text_queue[:, keep], text_q[:, keep])
    torch.testing.assert_close(model.prop_queue[:, cols],
                               aux["prop_feat_m"].t(), atol=1e-6, rtol=0)
    torch.testing.assert_close(model.text_queue[:, cols],
                               aux["text_feat_m"].t(), atol=1e-6, rtol=0)


def loss_and_grads(model, batch, tp, generator=None, noise=None):
    model.zero_grad(set_to_none=True)
    loss, _ = pretrain.pretrain_loss(model, batch, 0.4, tp, generator,
                                     noise)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in
                         model.named_parameters() if p.grad is not None}


def test_remat_matches_no_remat_deterministic():
    _, tp = pcfgs()
    _, tr = pcfgs(remat=True)
    model = port_state(jax_state(5))
    batch, noise = torch_tree(make_batch(7)), torch_tree(make_noise(7))
    base, g0 = loss_and_grads(model, batch, tp, noise=noise)
    got, g1 = loss_and_grads(model, batch, tr, noise=noise)
    assert abs(got - base) < 1e-4
    assert g0.keys() == g1.keys()
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], atol=1e-5, rtol=1e-5,
                                   msg=name)


def test_remat_with_dropout_draws_the_same_masks():
    """Dropout on (rate 0.1) and the mask and negatives drawn from the
    generator too: one seed gives the same loss and gradients with and
    without remat, so the recompute drew the forward's masks; a second
    seed gives other ones."""
    _, tp = pcfgs()
    _, tr = pcfgs(remat=True)
    model = port_state(jax_state(6))
    batch = torch_tree(make_batch(8))

    def run(cfg, seed):
        return loss_and_grads(model, batch, cfg,
                              generator=torch.Generator().manual_seed(seed))

    base, g0 = run(tp, 11)
    got, g1 = run(tr, 11)
    other, g2 = run(tp, 12)
    assert abs(got - base) < 1e-5
    assert abs(other - base) > 1e-3
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], atol=1e-5, rtol=1e-5,
                                   msg=name)
    assert any((g2[n] - g0[n]).abs().max() > 1e-3 for n in g0)


def test_bf16_compute_within_0_2_of_fp32():
    _, tp = pcfgs()
    model = port_state(jax_state(7))
    batch, noise = torch_tree(make_batch(9)), torch_tree(make_noise(9))
    base, _ = pretrain.pretrain_loss(model, batch, 0.4, tp,
                                     noise_override=noise)
    for kw in ({"bf16_compute": True}, {"bf16_compute": True, "remat": True}):
        loss, _ = pretrain.pretrain_loss(model, batch, 0.4, pcfgs(**kw)[1],
                                         noise_override=noise)
        assert np.isfinite(loss.item())
        assert abs(loss.item() - base.item()) < 0.2, kw
        assert loss.item() != base.item(), kw


def test_one_sample_batch_samples_negatives_uniformly():
    """A microbatch of one zeroes its only softmax weight: the negative is
    drawn from equal logits (row 0) instead of raising, as JAX's
    categorical does."""
    _, tp = pcfgs()
    model = port_state(jax_state(8))
    batch = torch_tree(make_batch(10, bs=1))
    loss, _ = pretrain.pretrain_loss(model, batch, 0.4, tp,
                                     torch.Generator().manual_seed(0))
    assert np.isfinite(loss.item())
    logits = torch.log(torch.zeros(2000, 3) + 1e-30)
    draws = pretrain._categorical(logits, torch.Generator().manual_seed(1))
    counts = torch.bincount(draws, minlength=3)
    assert counts.min() > 550


def test_optimizer_takes_online_params_and_temp_never_twins():
    _, tp = pcfgs()
    model = port_state(jax_state(9))
    opt, _ = pretrain.make_pretrain_step(model, tp, STEPS_PER_EPOCH)
    ids = {id(p) for p in opt.param_groups[0]["params"]}
    assert id(model.temp) in ids
    for key in pretrain.EMA_KEYS:
        for p in getattr(model, f"{key}_m").parameters():
            assert id(p) not in ids and not p.requires_grad
    twins, online = model.ema_pairs()
    assert [p.shape for p in twins] == [p.shape for p in online]


def test_ema_update_matches_jax():
    jp, _ = pcfgs()
    st = jax_state(10)
    st["params"] = jax.tree.map(lambda x: x * 1.5, st["params"])
    want = jpre.ema_update(jnp_tree(st["ema"]), jnp_tree(st["params"]), 0.9)
    model = port_state(st)
    pretrain.ema_update(model, 0.9)
    st["ema"] = jax.tree.map(np.asarray, want)
    for name, val in pretrain_state_dict_from_jax(st, TTEXT, TPROP).items():
        if name.split(".", 1)[0].endswith("_m"):
            torch.testing.assert_close(model.state_dict()[name], val,
                                       atol=1e-7, rtol=1e-6, msg=name)
