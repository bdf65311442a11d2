"""The first pretrain steps of the JAX package and of the PyTorch port, side
by side, on the CPU.

    JAX_PLATFORMS=cpu python scripts/pretrain_first_steps.py \
        [--width 768] [--layers 2] [--batch 24] [--steps 3]

Both start from the JAX package's ``init_pretrain_state`` (seed 0; the
port's copy through ``checkpoint.convert.pretrain_state_dict_from_jax``), at
a text BERT of ``--layers`` layers (half of them fusion layers) and a
property BERT of half as many, ``--width`` wide with heads of 64, batch
``--batch`` of 40 random tokens, queue 36,864 and the default
``PretrainConfig`` (lr 5e-5 from the first step).  Dropout is off and the
property mask and hard negatives are fixed, so both sides run the same
arithmetic: JAX through ``ema_update``, ``jax.value_and_grad(
pretrain_loss)``, ``make_optimizer(pcfg).update`` and the queue scatter,
the port through ``make_pretrain_step``.  Prints each step's four losses
from both.  It needs both packages, so it runs where the tests run, not on
the GPU's machine.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spmm_tpu.configs import BertArchConfig as JaxCfg  # noqa: E402
from spmm_tpu.configs import PretrainConfig as JaxPcfg  # noqa: E402
from spmm_tpu.training import pretrain as jpre  # noqa: E402
from spmm_tpu.training.schedules import reference_cosine_schedule  # noqa: E402

from spmm_tpu_torch.checkpoint.convert import pretrain_state_dict_from_jax  # noqa: E402
from spmm_tpu_torch.configs import BertArchConfig as TorchCfg  # noqa: E402
from spmm_tpu_torch.configs import PretrainConfig  # noqa: E402
from spmm_tpu_torch.training import pretrain  # noqa: E402

KEYS = ("loss_mlm", "loss_mpm", "loss_ita", "loss_itm")
STEPS_PER_EPOCH = 1000


def batch_and_noise(seed: int, bs: int, length: int = 40):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 300, size=(bs, length)).astype(np.int32)
    ids[:, 0] = 2
    lens = rng.integers(10, length + 1, size=bs)
    mask = (np.arange(length)[None] < lens[:, None]).astype(np.int32)
    rows = np.arange(bs)
    return ({"prop": rng.normal(size=(bs, 53)).astype(np.float32),
             "ids": ids * mask, "mask": mask},
            {"mpm_mask": (rng.random((bs, 53)) < 0.5).astype(np.float32),
             "neg_prop_idx": ((rows + 1) % bs).astype(np.int32),
             "neg_text_idx": ((rows - 1) % bs).astype(np.int32)})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--width", type=int, default=768)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args(argv)

    arch = dict(vocab_size=300, hidden_size=args.width,
                num_hidden_layers=args.layers,
                num_attention_heads=args.width // 64,
                intermediate_size=4 * args.width, max_position_embeddings=128,
                fusion_layer=args.layers // 2, encoder_width=args.width)
    jtext = JaxCfg(**arch, add_cross_attention=True)
    jprop = JaxCfg(**{**arch, "vocab_size": 1,
                      "num_hidden_layers": max(args.layers // 2, 1)},
                   add_cross_attention=False)
    ttext, tprop = (TorchCfg(**dataclasses.asdict(c)) for c in (jtext, jprop))
    jp, tp = JaxPcfg(), PretrainConfig()
    st = jpre.init_pretrain_state(jax.random.PRNGKey(0), jp, jtext, jprop)
    params, ema, queue = st["params"], st["ema"], st["queue"]

    model = pretrain.PretrainModel(ttext, tprop, tp.embed_dim, tp.queue_size)
    model.load_state_dict(pretrain_state_dict_from_jax(
        jax.tree.map(np.asarray, {"params": params, "ema": ema,
                                  "queue": queue}), ttext, tprop),
        strict=True)
    _, step = pretrain.make_pretrain_step(model, tp, STEPS_PER_EPOCH)

    tx = jpre.make_optimizer(jp)
    opt_state = tx.init(params)
    schedule = reference_cosine_schedule(
        jp.lr, jp.min_lr, jp.warmup_lr, jp.epochs, jp.warmup_epochs,
        STEPS_PER_EPOCH, step_size=100)
    vg = jax.jit(jax.value_and_grad(jpre.pretrain_loss, has_aux=True),
                 static_argnums=(6, 7, 8, 9))
    for s in range(args.steps):
        batch, noise = batch_and_noise(s, args.batch)
        alpha = jp.alpha * min(1.0, s / STEPS_PER_EPOCH)
        ema = jpre.ema_update(ema, params, jp.momentum)
        (_, aux), grads = vg(params, ema, queue,
                             jax.tree.map(jnp.asarray, batch),
                             jax.random.PRNGKey(0), jnp.float32(alpha),
                             jtext, jprop, jp, True,
                             jax.tree.map(jnp.asarray, noise))
        opt_state.hyperparams["learning_rate"] = schedule(s)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        params["temp"] = jnp.clip(params["temp"], 0.01, 0.5)
        cols = (queue["ptr"] + jnp.arange(args.batch)) % jp.queue_size
        queue = {"prop": queue["prop"].at[:, cols].set(aux["prop_feat_m"].T),
                 "text": queue["text"].at[:, cols].set(aux["text_feat_m"].T),
                 "ptr": (queue["ptr"] + args.batch) % jp.queue_size}
        got = step(s, {k: torch.from_numpy(v) for k, v in batch.items()},
                   noise={k: torch.from_numpy(v) for k, v in noise.items()})
        print(f"step {s}: " + ", ".join(
            f"{k[5:]} jax {float(aux[k]):.4f} port {got[k].item():.4f}"
            for k in KEYS), flush=True)


if __name__ == "__main__":
    main()
