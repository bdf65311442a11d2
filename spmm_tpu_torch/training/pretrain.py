"""SPMM pretraining on one GPU (counterpart of ``spmm_tpu.training.pretrain``):
four objectives, momentum encoders, feature queues and the train step.

The reference forward (SPMM_models.py:79-256) and training_step (:348-380):

  ITA   4-way InfoNCE (i2t/t2i/i2i/t2t) against [in-batch + queue]
        negatives, soft targets alpha-blended with the momentum
        similarities, /temp, /2.
  ITM   structure-property matching over CLS pairs from BOTH fusion
        directions, with in-batch hard negatives sampled from the softmaxed
        similarity rows (diagonal zeroed).
  MLM   causal next-token LM over SMILES conditioned on the PV through
        cross-attention; CE over ALL positions (pads included: pad labels
        are 0, SPMM_models.py:233-234) plus alpha-weighted distillation
        against the momentum logits (pads excluded).
  MPM   causal property decoding over text; MSE on the NON-masked
        positions (SPMM_models.py:254), x5.

The state is one module, ``PretrainModel``, under the reference's
state-dict names: the SPMM with its pretraining heads, ``temp``, the
momentum twins ``<key>_m`` of ``EMA_KEYS`` (no gradient) and the buffers
``prop_queue`` / ``text_queue`` [embed, Q] and ``queue_ptr``.  A reference
pretrain ``.ckpt`` loads into it strictly, and its ``state_dict()`` goes
back.  The optimizer and the step count live beside it
(``make_pretrain_step``, ``checkpoint.io``).

Randomness: dropout, the property mask and the hard negatives draw from the
``torch.Generator`` passed to the loss (dropout is on only with one, as the
JAX loss's ``deterministic=False``), the momentum forwards included.
``noise_override`` fixes the mask and the negatives.

Data parallelism: under a ``torch.distributed`` process group (one
process per GPU, ``parallel.multihost.initialize``) the step is the JAX
step's ``shard_map`` over ``dp``: each rank computes the loss on its own
rows, the gradients, loss and metrics are reduced, the momentum features
are gathered into the replicated queues in global row order, and each
rank draws its own noise.  ``pcfg.zero1`` shards the AdamW moments over
the ranks (``ZeroRedundancyOptimizer``) and the EMA twins at rest
(``TwinShards``); ``pcfg.bf16_moments`` keeps the
first moment in bf16 (``training.optim.AdamW``).  Without a process group
it is one process on one device.

Tensor, sequence and fully-sharded parallelism: under a process-wide
('dp', 'tp') or ('dp', 'fsdp') mesh (``parallel.mesh``) the step lays the
model out with ``parallel.tp.apply_tp`` or ``parallel.fsdp.apply_fsdp``
first, as JAX's CLI places its state (spmm_tpu/cli/pretrain.py:164-195),
and is data-parallel over the mesh's ``dp`` dim only: the rows, the
generator chunks, the gradient all-reduce, the loss reduction and the
feature gather follow the dp rank, so tp and fsdp peers compute the same
rows and a dp=D x tp=T or dp=D x fsdp=F run equals a 1-D dp=D run
(spmm_tpu/training/pretrain.py:486-511).  ``sp=True`` runs the encoders
sequence-parallel over the tp group (``parallel.sp``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from spmm_tpu_torch.checkpoint.convert import pretrain_subset
from spmm_tpu_torch.configs import (
    BertArchConfig, PretrainConfig, property_config, text_config)
from spmm_tpu_torch.models.bert import BertForMaskedLM, BertModel, checkpointed
from spmm_tpu_torch.models.spmm import SPMM
from spmm_tpu_torch.parallel import mesh as _mesh
from spmm_tpu_torch.parallel.mesh import all_reduce_flat, local_tensor
from spmm_tpu_torch.parallel import sp as _sp
from spmm_tpu_torch.training.optim import AdamW
from spmm_tpu_torch.training.schedules import reference_cosine_schedule
from spmm_tpu_torch.utils.device import DeviceLike, fp32_matmuls, resolve_device

Tensor = torch.Tensor

EMA_KEYS = ("property_encoder", "property_proj", "text_encoder", "text_proj")


class PretrainModel(SPMM):
    """The reference SPMM pretraining module (SPMM_models.py:16-77).  Its
    values come from ``init_pretrain_state``, ``pretrain_state_from_
    reference`` or a checkpoint, which set every one of them."""

    def __init__(self, text_cfg: Optional[BertArchConfig] = None,
                 prop_cfg: Optional[BertArchConfig] = None,
                 embed_dim: int = 256, queue_size: int = 36864):
        super().__init__(text_cfg, prop_cfg, with_pretrain_heads=True,
                         embed_dim=embed_dim)
        h = self.text_cfg.hidden_size
        self.temp = nn.Parameter(torch.zeros(()))
        self.text_encoder_m = BertForMaskedLM(self.text_cfg)
        self.property_encoder_m = BertModel(self.prop_cfg)
        self.property_proj_m = nn.Linear(h, embed_dim)
        self.text_proj_m = nn.Linear(h, embed_dim)
        for key in EMA_KEYS:
            getattr(self, f"{key}_m").requires_grad_(False)
        self.twin_shards = None           # ZeRO-1 over the twins (TwinShards)
        self.register_buffer("prop_queue", torch.zeros(embed_dim, queue_size))
        self.register_buffer("text_queue", torch.zeros(embed_dim, queue_size))
        self.register_buffer("queue_ptr", torch.zeros(1, dtype=torch.long))

    def forward(self, batch: dict, alpha: float, pcfg: PretrainConfig,
                generator: Optional[torch.Generator] = None,
                noise_override: Optional[dict] = None
                ) -> tuple[Tensor, dict]:
        """``pretrain_loss`` of this state: the step calls the model, so that
        FSDP2's root unit gathers its parameters around the loss."""
        return pretrain_loss(self, batch, alpha, pcfg, generator,
                             noise_override)

    def online_parameters(self) -> list:
        """What the optimizer updates: every parameter but the twins'
        (each tied one once), ``temp`` included."""
        return [p for p in self.parameters() if p.requires_grad]

    def ema_pairs(self) -> tuple[list, list]:
        """(twin parameters, their online parameters), in one order."""
        twins, online = [], []
        for key in EMA_KEYS:
            twins += list(getattr(self, f"{key}_m").parameters())
            online += list(getattr(self, key).parameters())
        return twins, online


def _fresh_queues(embed_dim: int, queue_size: int,
                  generator: torch.Generator) -> tuple[Tensor, Tensor]:
    """Normal queues with unit columns (spmm_tpu/training/pretrain.py:89-93)."""
    out = []
    for _ in range(2):
        q = torch.randn(embed_dim, queue_size, generator=generator)
        out.append(q / torch.linalg.vector_norm(q, dim=0, keepdim=True))
    return out[0], out[1]


def _twin(key: str) -> str:
    top, rest = key.split(".", 1)
    return f"{top}_m.{rest}"


def _build(state: dict, pcfg: PretrainConfig, text_cfg, prop_cfg,
           device: DeviceLike) -> PretrainModel:
    dev = resolve_device(device)
    model = PretrainModel(text_cfg or text_config(),
                          prop_cfg or property_config(), pcfg.embed_dim,
                          pcfg.queue_size)
    model.load_state_dict(state, strict=True)
    return model.to(dev)


def init_pretrain_state(seed: int, pcfg: PretrainConfig,
                        text_cfg: Optional[BertArchConfig] = None,
                        prop_cfg: Optional[BertArchConfig] = None,
                        device: DeviceLike = None) -> PretrainModel:
    """Random init (``init_pretrain_state``, spmm_tpu/training/pretrain.py:
    77-103): the online weights as ``SPMM.random_init(seed)`` makes them,
    the twins copied from them, ``temp`` from the config, the queues normal
    with unit columns from a generator seeded with ``seed + 1``, ``ptr`` 0.
    Made on the CPU and moved to ``device`` (the GPU unless asked)."""
    online = SPMM.random_init(seed, text_cfg, prop_cfg, device="cpu",
                              with_pretrain_heads=True,
                              embed_dim=pcfg.embed_dim)
    state = online.state_dict()
    state.update({_twin(k): v.clone() for k, v in state.items()
                  if k.split(".", 1)[0] in EMA_KEYS})
    state["temp"] = torch.tensor(pcfg.temp)
    state["prop_queue"], state["text_queue"] = _fresh_queues(
        pcfg.embed_dim, pcfg.queue_size,
        torch.Generator().manual_seed(seed + 1))
    state["queue_ptr"] = torch.zeros(1, dtype=torch.long)
    return _build(state, pcfg, online.text_cfg, online.prop_cfg, device)


def pretrain_state_from_reference(state_dict: dict, pcfg: PretrainConfig,
                                  text_cfg: Optional[BertArchConfig] = None,
                                  prop_cfg: Optional[BertArchConfig] = None,
                                  device: DeviceLike = None
                                  ) -> PretrainModel:
    """A resumable pretrain state from a reference checkpoint's state dict
    (spmm_tpu/training/pretrain.py:106-151): weights, ``temp`` and the four
    twins from the file, loaded strictly (a missing twin raises); other
    ``*_m`` entries, ``position_ids`` and the ``_unk`` name are handled by
    ``checkpoint.convert.pretrain_subset``.  The queues and ``queue_ptr``
    come from the file when it has them (their size must be the
    config's), else fresh ones from a generator seeded with 0."""
    state = pretrain_subset(state_dict)
    state.setdefault("temp", torch.tensor(pcfg.temp))
    state["temp"] = state["temp"].reshape(())
    if "prop_queue" in state:
        if state["prop_queue"].shape[1] != pcfg.queue_size:
            raise ValueError(
                f"checkpoint queue size {state['prop_queue'].shape[1]} "
                f"differs from the config's {pcfg.queue_size}")
        state["queue_ptr"] = state["queue_ptr"].reshape(-1)[:1].long()
    else:
        state["prop_queue"], state["text_queue"] = _fresh_queues(
            pcfg.embed_dim, pcfg.queue_size, torch.Generator().manual_seed(0))
        state["queue_ptr"] = torch.zeros(1, dtype=torch.long)
    return _build(state, pcfg, text_cfg, prop_cfg, device)


# --------------------------------------------------------------------------- #
# loss
# --------------------------------------------------------------------------- #


def _normalize(x: Tensor) -> Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _categorical(logits: Tensor, generator: Optional[torch.Generator]
                 ) -> Tensor:
    """One draw per row, by the Gumbel-max rule of ``jax.random.
    categorical``: a row of equal logits (the zeroed softmax of a
    one-sample batch) picks uniformly, where ``torch.multinomial`` on the
    weights would raise."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=1)


def pretrain_loss(model: PretrainModel, batch: dict, alpha: float,
                  pcfg: PretrainConfig,
                  generator: Optional[torch.Generator] = None,
                  noise_override: Optional[dict] = None
                  ) -> tuple[Tensor, dict]:
    """(total, aux) of one batch {"prop" [B, 53], "ids" [B, L], "mask"
    [B, L]} (``pretrain_loss``, spmm_tpu/training/pretrain.py:202-434).
    The momentum twins must already hold this step's EMA.

    ``noise_override`` fixes {"mpm_mask", "neg_prop_idx", "neg_text_idx"};
    what it leaves out is drawn from ``generator`` (the global RNG without
    one).  ``pcfg.bf16_compute`` runs the encoders under bf16 autocast:
    their products in bf16 with the fp32 masters' gradients, LayerNorm,
    the attention scores and softmax, the heads and the losses in fp32.
    ``pcfg.remat`` recomputes each layer and each of ITM, MLM and MPM in
    the backward, with the generator rewound so that dropout draws the
    same masks."""
    prop_orig, ids, mask = batch["prop"], batch["ids"], batch["mask"]
    bs, dev = prop_orig.shape[0], prop_orig.device
    noise = noise_override or {}
    gen, remat = generator, pcfg.remat

    def cast():
        return torch.autocast(dev.type, dtype=torch.bfloat16,
                              enabled=pcfg.bf16_compute)

    def objective(fn, *args):
        return checkpointed(fn, gen, *args) if remat else fn(*args)

    # temperature: clamp(0.01, 0.5) with a straight-through gradient
    temp = model.temp + (model.temp.clamp(0.01, 0.5) - model.temp).detach()

    # ---- property masking: Bernoulli(mask_prob), 1 = masked ----
    mpm_mask = noise.get("mpm_mask")
    if mpm_mask is None:
        mpm_mask = (torch.rand(prop_orig.shape, generator=gen, device=dev)
                    < pcfg.mask_prob).float()
    properties = model.embed_properties(prop_orig, mpm_mask)     # [B, 54, H]
    prop_atts = torch.ones(properties.shape[:2], dtype=torch.int32,
                           device=dev)

    # ---- unimodal encoders ----
    with cast():
        prop_embeds = model.encode_properties(properties, generator=gen,
                                              remat=remat).float()
        text_embeds = model.encode_text(ids, mask, generator=gen,
                                        remat=remat).float()
    prop_feat = _normalize(model.property_proj(prop_embeds[:, 0]))
    text_feat = _normalize(model.text_proj(text_embeds[:, 0]))

    # ---- momentum features: no gradient, dropout as in the online pass,
    # the properties embedded by the ONLINE embed / mask / cls ----
    with torch.no_grad():
        with cast():
            prop_embeds_m = model.property_encoder_m(
                inputs_embeds=properties, generator=gen).float()
            text_embeds_m = model.text_encoder_m.bert(
                input_ids=ids, attention_mask=mask, mode="text",
                generator=gen).float()
        prop_feat_m = _normalize(model.property_proj_m(prop_embeds_m[:, 0]))
        text_feat_m = _normalize(model.text_proj_m(text_embeds_m[:, 0]))
        prop_feat_all = torch.cat([prop_feat_m.t(), model.prop_queue], dim=1)
        text_feat_all = torch.cat([text_feat_m.t(), model.text_queue], dim=1)
        sim_targets = torch.zeros(bs, prop_feat_all.shape[1], device=dev)
        sim_targets[:, :bs] = torch.eye(bs, device=dev)
        soft = [alpha * torch.softmax(feat_m @ feat_all / temp, dim=1)
                + (1 - alpha) * sim_targets
                for feat_m, feat_all in ((prop_feat_m, text_feat_all),
                                         (text_feat_m, prop_feat_all),
                                         (prop_feat_m, prop_feat_all),
                                         (text_feat_m, text_feat_all))]

    # ---- ITA ----
    sim_i2t = prop_feat @ text_feat_all / temp
    sim_t2i = text_feat @ prop_feat_all / temp
    sims = (sim_i2t, sim_t2i, prop_feat @ prop_feat_all / temp,
            text_feat @ text_feat_all / temp)
    loss_ita = sum(-(F.log_softmax(s, dim=1) * tgt).sum(1).mean()
                   for s, tgt in zip(sims, soft)) / 2.0

    # ---- ITM with in-batch hard negatives (gradient-free sampling) ----
    with torch.no_grad():
        diag = torch.eye(bs, dtype=torch.bool, device=dev)
        log_w_i2t, log_w_t2i = (
            torch.log(torch.softmax(s[:, :bs], dim=1).masked_fill(diag, 0.0)
                      + 1e-30) for s in (sim_i2t, sim_t2i))
    neg_prop_idx = noise.get("neg_prop_idx")
    if neg_prop_idx is None:
        neg_prop_idx = _categorical(log_w_t2i, gen)
    neg_text_idx = noise.get("neg_text_idx")
    if neg_text_idx is None:
        neg_text_idx = _categorical(log_w_i2t, gen)
    neg_prop_idx, neg_text_idx = neg_prop_idx.long(), neg_text_idx.long()
    bert = model.text_encoder.bert

    def itm(prop_embeds, text_embeds):
        # positive and both negatives in one 3B pass per direction
        prop_3 = torch.cat([prop_embeds, prop_embeds[neg_prop_idx],
                            prop_embeds])
        text_3 = torch.cat([text_embeds, text_embeds,
                            text_embeds[neg_text_idx]])
        mask_3 = torch.cat([mask, mask, mask[neg_text_idx]])
        atts_3 = prop_atts.repeat(3, 1)
        with cast():
            prop_side = bert(encoder_embeds=prop_3, attention_mask=atts_3,
                             encoder_hidden_states=text_3,
                             encoder_attention_mask=mask_3, mode="fusion",
                             generator=gen, remat=remat)[:, 0]
            text_side = bert(encoder_embeds=text_3, attention_mask=mask_3,
                             encoder_hidden_states=prop_3,
                             encoder_attention_mask=atts_3, mode="fusion",
                             generator=gen, remat=remat)[:, 0]
        logits = model.itm_head(torch.cat([prop_side.float(),
                                           text_side.float()], dim=-1))
        labels = torch.cat([torch.ones(bs, dtype=torch.long, device=dev),
                            torch.zeros(2 * bs, dtype=torch.long,
                                        device=dev)])
        return F.cross_entropy(logits, labels)

    loss_itm = objective(itm, prop_embeds, text_embeds)

    # ---- MLM: causal next token with PV conditioning + distillation ----
    with torch.no_grad(), cast():
        logits_m = model.text_encoder_m(
            input_ids=ids, attention_mask=mask,
            encoder_hidden_states=prop_embeds_m,
            encoder_attention_mask=prop_atts, is_decoder=True,
            generator=gen)[:, :-1].float()
    labels = ids[:, 1:].long()

    def mlm(prop_embeds, logits_m):
        with cast():
            logits = model.text_encoder(
                input_ids=ids, attention_mask=mask,
                encoder_hidden_states=prop_embeds,
                encoder_attention_mask=prop_atts, is_decoder=True,
                generator=gen, remat=remat)[:, :-1]
        logp = F.log_softmax(logits.float(), dim=-1)
        # plain mean CE over ALL positions, pads included
        loss_ce = -logp.gather(-1, labels[..., None]).mean()
        distill = -(logp * torch.softmax(logits_m, dim=-1)).sum(-1)
        keep = (labels != 0).float()
        loss_distill = (distill * keep).sum() / keep.sum().clamp_min(1.0)
        return (1 - alpha) * loss_ce + alpha * loss_distill

    loss_mlm = objective(mlm, prop_embeds, logits_m)

    # ---- MPM: causal property regression over text ----
    def mpm(properties, text_embeds):
        with cast():
            causal = model.encode_properties(properties, is_decoder=True,
                                             generator=gen, remat=remat)
            out = bert(encoder_embeds=causal, attention_mask=prop_atts,
                       encoder_hidden_states=text_embeds,
                       encoder_attention_mask=mask, is_decoder=True,
                       mode="fusion", generator=gen, remat=remat)[:, :-1]
        pred = model.mtr_head_forward(out.float())
        keep = 1.0 - mpm_mask
        return ((pred - prop_orig) ** 2 * keep).sum() / keep.sum().clamp_min(
            1.0)

    loss_mpm = objective(mpm, properties, text_embeds)

    total = loss_mlm + pcfg.mpm_weight * loss_mpm + loss_ita + loss_itm
    aux = {"loss_mlm": loss_mlm, "loss_mpm": pcfg.mpm_weight * loss_mpm,
           "loss_ita": loss_ita, "loss_itm": loss_itm,
           "prop_feat_m": prop_feat_m, "text_feat_m": text_feat_m}
    return total, aux


# --------------------------------------------------------------------------- #
# train step
# --------------------------------------------------------------------------- #

LOSS_KEYS = ("loss_mlm", "loss_mpm", "loss_ita", "loss_itm")


def _sharded(t: Tensor) -> bool:
    """Whether ``t`` is a DTensor whose ranks hold different parts."""
    return isinstance(t, DTensor) and any(isinstance(p, Shard)
                                          for p in t.placements)


@torch.no_grad()
def ema_update(model: PretrainModel, momentum: float) -> None:
    """twin = twin * m + online * (1 - m), in place, in that order
    (spmm_tpu/training/pretrain.py:442-445); on the local shards where tp
    or fsdp shards both alike, on this rank's share under ZeRO-1
    (``TwinShards``)."""
    if model.twin_shards is not None:
        twins, online = model.twin_shards.pairs()
    else:
        twins, online = (list(map(local_tensor, ps))
                         for ps in model.ema_pairs())
    torch._foreach_mul_(twins, momentum)
    torch._foreach_add_(twins, torch._foreach_mul(online, 1.0 - momentum))


class TwinShards:
    """ZeRO-1 over the EMA twins, as JAX's ``zero1`` shards them over dp at
    rest (``_zero1_spec``, spmm_tpu/training/pretrain.py:159-195, 563-568).

    The twins, in ``ema_pairs`` order, are one flat buffer padded to a
    multiple of the dp size; this rank keeps its contiguous ``1/world`` of
    it (``shard``), and between steps the twins themselves hold no storage.
    ``ema_update`` updates the share against the same elements of the
    online parameters (the update is elementwise, so the result is bitwise
    the replicated one); ``gather`` all-gathers the whole twins for a
    step's momentum forwards (every dp rank calls it), ``release`` frees
    them again.  ``whole_twins`` gathers them around a state-dict read, as
    ``checkpoint.io`` does, so checkpoints keep whole twins."""

    def __init__(self, model: PretrainModel, group: dist.ProcessGroup):
        self.twins, self.online = model.ema_pairs()
        self.group = group
        self.shapes = [p.shape for p in self.twins]
        self.sizes = [p.numel() for p in self.twins]
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        total = sum(self.sizes)
        per = -(-total // world)
        lo, hi = rank * per, min((rank + 1) * per, total)
        # (twin, first, last element in the twin, first in the shard)
        self.segments, off = [], 0
        for i, n in enumerate(self.sizes):
            a, b = max(lo, off), min(hi, off + n)
            if a < b:
                self.segments.append((i, a - off, b - off, a - lo))
            off += n
        ref = self.twins[0]
        self.shard = torch.zeros(per, dtype=ref.dtype, device=ref.device)
        self.padded = per * world
        self.gathered = True
        self.take()
        self.release()

    def _views(self, params: list) -> tuple[list, list]:
        mine = [self.shard[o:o + b - a] for _, a, b, o in self.segments]
        theirs = [params[i].detach().reshape(-1)[a:b]
                  for i, a, b, _ in self.segments]
        return mine, theirs

    def pairs(self) -> tuple[list, list]:
        """(this rank's share of the twins, the same elements of the online
        parameters), as views."""
        return self._views(self.online)

    @torch.no_grad()
    def take(self) -> None:
        """Copy this rank's share of the whole twins into the shard."""
        mine, twins = self._views(self.twins)
        torch._foreach_copy_(mine, twins)

    def _point(self, flat: Tensor) -> None:
        off = 0
        for p, n, shape in zip(self.twins, self.sizes, self.shapes):
            p.data = flat[off:off + n].view(shape)
            off += n
        self.gathered = True

    def materialize(self) -> None:
        """Whole twins with uninitialized storage (for a load into them)."""
        self._point(self.shard.new_empty(self.padded))

    def gather(self) -> None:
        """Whole twins from every rank's share: one all-gather over dp."""
        flat = self.shard.new_empty(self.padded)
        dist.all_gather_into_tensor(flat, self.shard, group=self.group)
        self._point(flat)

    def release(self) -> None:
        for p in self.twins:
            p.data = p.data.new_empty(0)
        self.gathered = False

    def resident_elements(self) -> int:
        """Twin elements this rank holds now: its share, plus the whole
        twins while they are gathered."""
        return self.shard.numel() + sum(p.numel() for p in self.twins)


@contextlib.contextmanager
def whole_twins(model: PretrainModel):
    """Inside the block the model's twins are whole: under ZeRO-1 they are
    gathered (a collective that every dp rank enters) and released after;
    otherwise nothing happens.  State-dict reads that must hold the twins
    (``checkpoint.io``) run inside it."""
    shards = getattr(model, "twin_shards", None)
    if shards is None or shards.gathered:
        yield
        return
    shards.gather()
    try:
        yield
    finally:
        shards.release()


def _shard_twins(model: PretrainModel,
                 group: Optional[dist.ProcessGroup]) -> None:
    """Make ``model``'s twins ZeRO-1 shards over ``group``, or whole again
    with None (the twins of an earlier zero1 step gathered)."""
    old = model.twin_shards
    if old is not None and not old.gathered:
        old.gather()
    model.twin_shards = None if group is None else TwinShards(model, group)


def clip_by_global_norm_(grads: list,
                         max_norm: float,
                         group: Optional[dist.ProcessGroup] = None) -> Tensor:
    """``optax.clip_by_global_norm``: every gradient becomes g / norm *
    max_norm where the global norm is >= max_norm (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``).  Returns the norm; no host sync.

    ``group`` holds the shards of the sharded DTensor gradients among
    ``grads`` (the tp or fsdp peers): their squares are summed over it, and
    each replicated gradient is counted once, so the norm is one
    process's."""
    parts = [local_tensor(g) for g in grads]
    norms = torch._foreach_norm(parts)
    if group is None:
        norm = torch.linalg.vector_norm(torch.stack(norms))
    else:
        shard = torch.tensor([_sharded(g) for g in grads],
                             device=parts[0].device)
        sq = torch.stack(norms) ** 2
        sharded = torch.where(shard, sq, 0.0).sum()
        dist.all_reduce(sharded, group=group)
        norm = torch.sqrt(torch.where(shard, 0.0, sq).sum() + sharded)
    clip = norm >= max_norm
    torch._foreach_div_(parts, torch.where(clip, norm, 1.0))
    torch._foreach_mul_(parts, torch.where(clip, max_norm, 1.0))
    return norm


def make_pretrain_optimizer(model: PretrainModel, pcfg: PretrainConfig,
                            group: Optional[dist.ProcessGroup] = None
                            ) -> torch.optim.Optimizer:
    """AdamW over the online parameters and ``temp``, never the twins: with
    zero gradients AdamW would decay them.  The lr is set per step.

    ``torch.optim.AdamW`` (optax.adamw's arithmetic, finetune.py's note),
    or the port's ``training.optim.AdamW``: with ``pcfg.bf16_moments`` (a
    bf16 first moment, optax's ``mu_dtype``), and over DTensor parameters
    (tp or fsdp), whose local parts it updates.  ``pcfg.zero1`` wraps it in a
    ``ZeroRedundancyOptimizer`` over ``group``: each rank keeps the moments
    of its share of the parameters, steps them, and broadcasts them back;
    the parameters stay replicated."""
    params = model.online_parameters()
    cls = torch.optim.AdamW
    if pcfg.bf16_moments or any(isinstance(p, DTensor) for p in params):
        cls = functools.partial(
            AdamW, mu_dtype=torch.bfloat16 if pcfg.bf16_moments else None)
    hyper = dict(lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=pcfg.weight_decay)
    if not pcfg.zero1:
        return cls(params, **hyper)
    if group is None:
        raise ValueError("zero1 shards the optimizer state over a process "
                         "group: start one first (parallel.multihost."
                         "initialize)")
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return ZeroRedundancyOptimizer(params, optimizer_class=cls,
                                   process_group=group, **hyper)


Generators = Union[torch.Generator, Callable[[int], torch.Generator], None]


def make_pretrain_step(model: PretrainModel, pcfg: PretrainConfig,
                       steps_per_epoch: int, accum: int = 1,
                       data_parallel: Optional[bool] = None,
                       sp: bool = False):
    """(optimizer, step) of pretraining (``make_pretrain_step``,
    spmm_tpu/training/pretrain.py:549-653).

    ``step(global_step, batch, generator=None, noise=None)`` trains on this
    rank's rows of one global batch (tensors on the model's device) and
    returns the losses (0-dim tensors, averaged over the global batch), the
    lr, the gradients' global norm before the clip (None on a skipped step)
    and whether the step was skipped.  In order:

      - the EMA update, before the forward (under ``pcfg.zero1`` on this
        rank's share of the twins, which are then gathered whole for the
        step and released after it: ``TwinShards``);
      - alpha ramps over epoch 0;
      - ``accum`` microbatches of this rank's rows: each backpropagates its
        loss over ``world * accum`` (``world`` the dp extent), and the
        queue takes every microbatch's momentum features;
      - with a process group (``data_parallel`` None and one initialized,
        or True): one all-reduce (sum) over the dp group of this rank's
        gradients (of its shards under tp or fsdp) as one flat buffer, one
        of the loss and metrics, and one all-gather of the momentum
        features, so that the queue is written in global row order on
        every rank.  Summing pre-scaled gradients makes two ranks' step
        the arithmetic of one process at twice the ``accum``;
      - a non-finite loss skips everything below (the EMA and the caller's
        step count still advance); it is the reduced loss, so every rank
        skips together;
      - clip by global norm ``pcfg.grad_clip`` over the whole reduced
        gradients (the shards' squares summed over the tp or fsdp group),
        then AdamW at ``reference_cosine_schedule(step_size=100)`` of the
        step (under ``pcfg.zero1`` each rank steps its share and
        broadcasts it);
      - ``temp`` clipped to [0.01, 0.5];
      - the queue written at columns (ptr + arange(B_global)) % Q.

    Rows: the global batch is cut into ``accum`` microbatches and each is
    split over the dp ranks, as JAX does, so this rank holds
    ``parallel.multihost.local_rows`` of its dp rank; microbatch ``i`` of
    dp rank ``r`` is chunk ``c = i * world + r`` of the global batch.
    ``generator`` is one ``torch.Generator`` that every microbatch draws
    from, or a function of the chunk (``functools.partial(step_generator,
    seed, step, device)``): then the draws depend on the chunk alone, not
    on how the chunks are spread over ranks and microbatches.  ``noise``
    fixes the loss's draws (``pretrain_loss``'s ``noise_override``), as
    tensors over this rank's rows that are split with them; ``neg_*_idx``
    index within their microbatch.  ``data_parallel=False`` is the
    one-process step even under a process group.

    Under a ('dp', 'tp') mesh the model is laid out by ``parallel.tp.
    apply_tp`` here (unless it already is), under ('dp', 'fsdp') by
    ``parallel.fsdp.apply_fsdp``; ``sp=True`` needs the tp dim and runs
    the microbatches' forwards and backwards inside ``parallel.sp.
    sequence_parallel``.  ``pcfg.zero1`` with either dim raises, as in
    JAX (spmm_tpu/training/pretrain.py:494-498)."""
    minor = None if data_parallel is False else _mesh.minor_dim()
    if pcfg.zero1 and minor is not None:
        raise ValueError(
            f"zero1 and a {minor!r} mesh dim are not composed: ZeRO-1 "
            f"shards the optimizer state over dp while {minor} shards it "
            "with the parameters; pick one")
    if sp and minor != _mesh.TP_AXIS:
        raise ValueError("sp=True needs a mesh with a 'tp' dim: sequence "
                         "parallelism shards over the tensor-parallel group")
    group = None if data_parallel is False else _mesh.dp_group()
    if data_parallel and group is None:
        raise ValueError("data_parallel=True needs a process group "
                         "(parallel.multihost.initialize)")
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    minor_group = None
    if minor is not None:
        if not any(isinstance(p, DTensor) for p in model.parameters()):
            from spmm_tpu_torch.parallel import fsdp, tp

            (tp.apply_tp if minor == _mesh.TP_AXIS else fsdp.apply_fsdp)(
                model)
        minor_group = _mesh.minor_mesh().get_group()
    fp32_matmuls()
    opt = make_pretrain_optimizer(model, pcfg, group)
    _shard_twins(model, group if pcfg.zero1 else None)
    params = model.online_parameters()
    seq_partial = _sp.partial_parameters(model) if sp else []
    sp_mesh = _mesh.minor_mesh() if sp else None
    schedule = reference_cosine_schedule(
        pcfg.lr, pcfg.min_lr, pcfg.warmup_lr, pcfg.epochs,
        pcfg.warmup_epochs, steps_per_epoch, step_size=100)

    def context():
        if not sp:
            return contextlib.nullcontext()
        return _sp.sequence_parallel(sp_mesh)

    def step(global_step: int, batch: dict, generator: Generators = None,
             noise: Optional[dict] = None) -> dict:
        lb = batch["prop"].shape[0]
        gb = lb * world
        if pcfg.queue_size % gb or lb % accum:
            raise ValueError(f"global batch {gb} ({world} x {lb}) must "
                             f"divide the queue {pcfg.queue_size}, and "
                             f"{lb} divide by accum {accum}")
        epoch, batch_idx = divmod(int(global_step), steps_per_epoch)
        alpha = (pcfg.alpha if epoch > 0 else
                 pcfg.alpha * min(1.0, batch_idx / steps_per_epoch))
        ema_update(model, pcfg.momentum)
        if model.twin_shards is not None:
            model.twin_shards.gather()      # whole for the momentum forwards
        for p in params:
            p.grad = None
        mb, scale = lb // accum, world * accum
        loss = 0.0
        parts = dict.fromkeys(LOSS_KEYS, 0.0)
        feats = []
        with context():
            for i in range(accum):
                rows = slice(i * mb, (i + 1) * mb)
                total, aux = model(
                    {k: v[rows] for k, v in batch.items()}, alpha, pcfg,
                    generator(i * world + rank) if callable(generator)
                    else generator,
                    None if noise is None else {k: v[rows]
                                                for k, v in noise.items()})
                (total / scale).backward()
                loss = loss + total.detach() / scale
                for k in LOSS_KEYS:
                    parts[k] = parts[k] + aux[k].detach() / scale
                feats.append(torch.stack([aux["prop_feat_m"],
                                          aux["text_feat_m"]]))
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if seq_partial:
            all_reduce_flat([p.grad for p in seq_partial], minor_group)
        feats = torch.stack(feats)                  # [accum, 2, mb, E]
        if group is None:
            feats = feats[:, None]
        else:
            all_reduce_flat([local_tensor(g) for g in grads], group)
            stats = torch.stack([loss, *(parts[k] for k in LOSS_KEYS)])
            dist.all_reduce(stats, group=group)
            loss, parts = stats[0], dict(zip(LOSS_KEYS, stats[1:]))
            gathered = [torch.empty_like(feats) for _ in range(world)]
            dist.all_gather(gathered, feats, group=group)
            feats = torch.stack(gathered, 1)        # [accum, world, 2, mb, E]
        # chunk order (microbatch, then rank) is global row order
        feats = feats.permute(2, 0, 1, 3, 4).reshape(2, gb, -1)
        lr = schedule(global_step)
        finite = bool(torch.isfinite(loss))
        norm = None
        if finite:
            norm = clip_by_global_norm_(grads, pcfg.grad_clip, minor_group)
            for g in opt.param_groups:
                g["lr"] = lr
            opt.step()
            with torch.no_grad():
                model.temp.clamp_(0.01, 0.5)
                cols = (model.queue_ptr + torch.arange(
                    gb, device=model.queue_ptr.device)) % pcfg.queue_size
                model.prop_queue.index_copy_(1, cols, feats[0].t())
                model.text_queue.index_copy_(1, cols, feats[1].t())
                model.queue_ptr.copy_((model.queue_ptr + gb)
                                      % pcfg.queue_size)
        if model.twin_shards is not None:
            model.twin_shards.release()
        return {"loss": loss, **parts, "lr": lr, "grad_norm": norm,
                "skipped": not finite}

    return opt, step


def step_generator(seed: int, global_step: int, device: torch.device,
                   chunk: int = 0) -> torch.Generator:
    """The generator of one chunk of one step's global batch, seeded from
    the run's seed, the step (as the JAX CLI folds the step into its key)
    and the chunk (``make_pretrain_step``: microbatch ``i`` of rank ``r``
    is chunk ``i * world + r``, as JAX folds in the dp index): a resumed
    run draws what an uninterrupted one draws, and two ranks draw what one
    process at twice the ``accum`` draws.  Chunk 0 is the one-process,
    one-microbatch generator.  The seed is the splitmix64 mix of the run's
    seed, the step and (past chunk 0) the chunk, which reaches the low 32
    bits, the only ones the CPU's Mersenne Twister reads: so two seeds draw
    differently on the CPU too, as on the card's Philox generator."""
    value = ((seed + 1) << 32) + int(global_step)
    if chunk:
        value ^= _splitmix64(chunk)
    return torch.Generator(device=device).manual_seed(_splitmix64(value))


def _splitmix64(x: int) -> int:
    mask = 2 ** 64 - 1
    x = (x + 0x9E3779B97F4A7C15) & mask
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
    return x ^ (x >> 31)
