"""Expert parallelism: a GShard mixture-of-experts FFN block over an 'ep'
process group (counterpart of ``spmm_tpu.parallel.ep``).

The reference has no mixture of experts, and this dense model family does
not need one; JAX's module is the building block anyway, and this is its
port, step for step:

- a static-shape, capacity-factored top-k router: fp32 softmax; top-k by
  repeated argmax, each pick zeroing its probability (``torch.argmax``
  returns the first maximum, as ``jnp.argmax`` does); the Switch
  load-balancing loss from the pre-capacity first choices; slot positions
  from int32 cumsums, choice ranks in priority order and each rank in
  token order, offsets capped at the capacity; gates renormalised over the
  selected experts; dispatch and combine tensors [T, E, C] built in fp32
  and cast to the compute dtype at the end (``_top_k_dispatch``,
  spmm_tpu/parallel/ep.py:112-171);
- :func:`moe_block`, the dense block with ``mlp_block``'s residual and
  LayerNorm tail (a token that no expert keeps passes through them
  unchanged), routing within ``n_groups`` groups along the batch (:195);
- :func:`expert_parallel_moe_block`, the same block with the experts
  spread over the ranks of a group (:240): each rank routes its own rows
  as one group, sends each expert's slots to the rank that holds it and
  gets the results back, by two ``all_to_all_single``, and equals
  ``moe_block(n_groups=ep)`` on the gathered batch.

The parameters are one ``nn.Module``, :class:`MoEBlock`: the router in
JAX's [H, E] layout, the experts' up [E, H, F] + [E, F] and down
[E, F, H] + [E, H] slabs, and the block's LayerNorm
(``checkpoint.convert.moe_state_dict_from_jax_tree`` carries JAX's tree
over).  Under expert parallelism a rank's block holds its E / ep experts'
slabs and the whole router and LayerNorm (:func:`expert_shard`).

Gradients under expert parallelism (the exchange is differentiated
through ``torch.distributed.nn.functional.all_to_all_single``): the expert
slabs' gradients are the rank's own; the router's and the LayerNorm's are
partial, and equal JAX's once summed over the group; ``aux_loss`` and
``dropped_frac`` are replicated means over the group, so a loss that sums
the ranks' losses counts the auxiliary loss once (add it on one rank, or
``aux_loss / ep`` on each).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from spmm_tpu_torch.configs import BertArchConfig
from spmm_tpu_torch.models.bert import LayerNorm
from spmm_tpu_torch.ops.attention import dropout
from spmm_tpu_torch.utils.device import DeviceLike, resolve_device

EP_AXIS = "ep"

Tensor = torch.Tensor


def ep_mesh(ep: int) -> dist.ProcessGroup:
    """The 1-D expert-parallel group over the first ``ep`` ranks of the
    default group; every rank calls it (a group is made collectively)."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < ep:
        raise ValueError(f"need {ep} ranks for ep={ep}, have {world}")
    return dist.new_group(ranks=list(range(ep)))


class MoEBlock(nn.Module):
    """Router, expert slabs and LayerNorm of one MoE FFN block
    (``init_moe_params``, spmm_tpu/parallel/ep.py:66-90).  ``n_local``
    experts' slabs (all ``n_experts`` by default) beside the whole
    router."""

    def __init__(self, cfg: BertArchConfig, n_experts: int,
                 n_local: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        h, f = cfg.hidden_size, cfg.intermediate_size
        n_local = n_experts if n_local is None else n_local
        self.router = nn.Parameter(torch.zeros(h, n_experts))
        self.up_weight = nn.Parameter(torch.zeros(n_local, h, f))
        self.up_bias = nn.Parameter(torch.zeros(n_local, f))
        self.down_weight = nn.Parameter(torch.zeros(n_local, f, h))
        self.down_bias = nn.Parameter(torch.zeros(n_local, h))
        self.LayerNorm = LayerNorm(h, cfg.layer_norm_eps)

    @property
    def n_experts(self) -> int:
        return self.router.shape[1]


def init_moe_params(seed: int, cfg: BertArchConfig, n_experts: int,
                    std: float = 0.02, device: DeviceLike = None) -> MoEBlock:
    """A block with the router and the expert weights normal(0, ``std``),
    zero biases and a unit LayerNorm, as JAX's ``init_moe_params`` lays
    them out (its random stream is JAX's, this one a ``torch.Generator``
    seeded with ``seed``).  Made on the CPU, moved to ``device`` (the GPU
    unless asked)."""
    dev = resolve_device(device)
    block = MoEBlock(cfg, n_experts)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for w in (block.router, block.up_weight, block.down_weight):
            w.normal_(0.0, std, generator=gen)
    return block.to(dev)


def expert_shard(block: MoEBlock, rank: int, ep: int) -> MoEBlock:
    """Rank ``rank``'s block under ``ep``-way expert parallelism: experts
    ``[rank * E / ep, (rank + 1) * E / ep)`` and copies of the router and
    the LayerNorm (JAX's ``moe_shardings``, :93-101)."""
    if block.n_experts % ep:
        raise ValueError(f"{block.n_experts} experts do not divide over "
                         f"ep={ep} ranks")
    per = block.n_experts // ep
    local = MoEBlock(block.cfg, block.n_experts, per).to(block.router.device)
    rows = slice(rank * per, (rank + 1) * per)
    with torch.no_grad():
        for name, p in local.named_parameters():
            whole = block.get_parameter(name)
            p.copy_(whole[rows] if name.startswith(("up_", "down_"))
                    else whole)
    return local


def ep_rows(batch: int, rank: int, ep: int) -> slice:
    """Rank ``rank``'s contiguous rows of a global batch of ``batch``, as
    JAX's ``P('ep')`` batch split."""
    if batch % ep:
        raise ValueError(f"batch {batch} not divisible by ep={ep}")
    per = batch // ep
    return slice(rank * per, (rank + 1) * per)


def expert_capacity(tokens_per_group: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Per-group, per-expert slots (GShard): the ceiling of the even share
    of (token, choice) slots times ``capacity_factor``, at least 1
    (spmm_tpu/parallel/ep.py:104-109)."""
    return max(1, int(math.ceil(
        tokens_per_group * top_k * capacity_factor / n_experts)))


def _top_k_dispatch(probs: Tensor, top_k: int, capacity: int,
                    dtype: Optional[torch.dtype] = None):
    """GShard dispatch and combine tensors of token groups.

    ``probs`` [..., T, E], the router's softmax.  Returns (dispatch
    [..., T, E, C], the 0/1 routing; combine [..., T, E, C], the
    renormalised gates; both in ``dtype``) and {"aux_loss",
    "dropped_frac"} per group in fp32.  Slot positions are int32 cumsums
    whatever ``dtype`` is: a bf16 cumsum stops counting exactly past 256
    and would put two tokens in one slot."""
    dtype = dtype or probs.dtype
    probs = probs.float()
    e = probs.shape[-1]
    p = probs
    masks, gates = [], []
    for _ in range(top_k):
        onehot = F.one_hot(p.argmax(-1), e).to(torch.int32)     # [..., T, E]
        masks.append(onehot)
        gates.append((probs * onehot).sum(-1))                   # raw prob
        p = p * (1.0 - onehot)
    # the Switch load-balancing loss from the pre-capacity first choices:
    # E * sum_e fraction_e * mean_prob_e
    frac = masks[0].float().mean(-2)
    aux_loss = e * (frac * probs.mean(-2)).sum(-1)

    # choices of rank r take the slots after those of ranks < r
    offset = torch.zeros_like(masks[0][..., 0, :])
    kept, positions = [], []
    n_slots = 0
    for m in masks:
        pos = torch.cumsum(m, -2, dtype=torch.int32) - m + offset[..., None, :]
        keep = m * (pos < capacity)
        kept.append(keep)
        positions.append(pos)
        offset = offset + keep.sum(-2, dtype=torch.int32)      # capped
        n_slots = n_slots + m.sum((-2, -1), dtype=torch.int32)
    n_kept = sum(k.sum((-2, -1), dtype=torch.int32) for k in kept)
    dropped_frac = 1.0 - n_kept.float() / n_slots.clamp_min(1).float()

    # the gates renormalised over the selected (pre-capacity) experts
    denom = sum(gates)
    denom = torch.where(denom > 0, denom, 1.0)
    slot_ids = torch.arange(capacity, device=probs.device)
    dispatch = combine = 0.0
    for m, g, pos in zip(kept, gates, positions):
        slot = (pos[..., None] == slot_ids).float()        # [..., T, E, C]
        routed = m.float()[..., None] * slot
        dispatch = dispatch + routed
        combine = combine + (g / denom)[..., None, None] * routed
    return (dispatch.to(dtype), combine.to(dtype),
            {"aux_loss": aux_loss, "dropped_frac": dropped_frac})


def _expert_ffn(block: MoEBlock, x: Tensor) -> Tensor:
    """Each expert's erf-GELU FFN over its slots ``x`` [..., E, C, H]."""
    h = F.gelu(torch.einsum("...ech,ehf->...ecf", x, block.up_weight)
               + block.up_bias[:, None, :])
    return (torch.einsum("...ecf,efh->...ech", h, block.down_weight)
            + block.down_bias[:, None, :])


def _route(router: Tensor, tokens: Tensor, top_k: int, capacity: int):
    """fp32-softmax routing of ``tokens`` [..., T, H] (:180-192)."""
    n_experts = router.shape[1]
    if top_k > n_experts:
        raise ValueError(f"top_k={top_k} exceeds n_experts={n_experts}")
    probs = torch.softmax(tokens.float() @ router.float(), dim=-1)
    return _top_k_dispatch(probs, top_k, capacity, tokens.dtype)


def _finish_block(block: MoEBlock, cfg: BertArchConfig, hidden: Tensor,
                  down: Tensor, generator: Optional[torch.Generator]
                  ) -> Tensor:
    """``mlp_block``'s tail (:230-237): dropout (on with a generator),
    residual, LayerNorm."""
    down = dropout(down, cfg.hidden_dropout_prob, generator)
    return block.LayerNorm(down + hidden)


def moe_block(
    p: MoEBlock,
    cfg: BertArchConfig,
    hidden: Tensor,
    top_k: int = 2,
    capacity_factor: float = 1.25,
    n_groups: int = 1,
    deterministic: bool = True,
    generator: Optional[torch.Generator] = None,
) -> tuple[Tensor, dict[str, Tensor]]:
    """The dense MoE FFN block, a drop-in for ``BertLayer.mlp``
    (spmm_tpu/parallel/ep.py:195-227).  ``hidden`` [B, S, H] is routed
    within ``n_groups`` groups along the batch (capacity is per group).
    Returns (the block's output [B, S, H], {"aux_loss", "dropped_frac"},
    each the mean over the groups).  Dropout is on when
    ``deterministic=False`` and draws from ``generator``, the port's stream
    (JAX's ``rng``)."""
    b, s, h = hidden.shape
    if b % n_groups:
        raise ValueError(f"batch {b} not divisible by n_groups={n_groups}")
    tg = (b // n_groups) * s
    capacity = expert_capacity(tg, p.n_experts, top_k, capacity_factor)
    tokens = hidden.reshape(n_groups, tg, h)
    dispatch, combine, aux = _route(p.router, tokens, top_k, capacity)
    slots = torch.einsum("gtec,gth->gech", dispatch, tokens)
    slots = _expert_ffn(p, slots)
    down = torch.einsum("gtec,gech->gth", combine, slots).reshape(b, s, h)
    aux = {k: v.mean() for k, v in aux.items()}
    out = _finish_block(p, cfg, hidden, down,
                        None if deterministic else generator)
    return out, aux


def _exchange(x: Tensor, group: dist.ProcessGroup) -> Tensor:
    """Dim 0 of ``x`` [ep, ...] scattered over the group, one block a rank;
    returns the blocks received, [ep (source rank), ...]."""
    from torch.distributed.nn.functional import all_to_all_single

    x = x.contiguous()
    return all_to_all_single(torch.empty_like(x), x, group=group)


def expert_parallel_moe_block(
    p_local: MoEBlock,
    cfg: BertArchConfig,
    hidden_local: Tensor,
    group: Optional[dist.ProcessGroup],
    top_k: int = 2,
    capacity_factor: float = 1.25,
) -> tuple[Tensor, dict[str, Tensor]]:
    """The MoE FFN block with the experts spread over ``group``
    (``expert_parallel_moe_block``, spmm_tpu/parallel/ep.py:240-294).

    ``p_local``: this rank's block (:func:`expert_shard`); ``hidden_local``
    [b, S, H]: this rank's rows (:func:`ep_rows`), as many on every rank.
    The rank routes its rows as one group, sends each expert's slots [E, C,
    H] to the rank holding it, which runs its E / ep experts over the slots
    of every rank [E / ep, ep * C, H], and gets its slots back.  Returns
    (this rank's output [b, S, H], {"aux_loss", "dropped_frac"} as means
    over the group); equal to :func:`moe_block` with ``n_groups=ep`` on the
    gathered batch.  Deterministic, as JAX's.  A group of one (or None)
    is the dense block of one group."""
    ep = 1 if group is None else dist.get_world_size(group)
    n_experts = p_local.n_experts
    if n_experts % ep:
        raise ValueError(
            f"{n_experts} experts do not divide over ep={ep} ranks")
    per = n_experts // ep
    if p_local.up_weight.shape[0] != per:
        raise ValueError(f"this rank holds {p_local.up_weight.shape[0]} "
                         f"experts; {n_experts} experts over ep={ep} ranks "
                         f"are {per} a rank")
    b, s, h = hidden_local.shape
    capacity = expert_capacity(b * s, n_experts, top_k, capacity_factor)
    tokens = hidden_local.reshape(b * s, h)
    dispatch, combine, aux = _route(p_local.router, tokens, top_k, capacity)
    slots = torch.einsum("tec,th->ech", dispatch, tokens)        # [E, C, H]
    if group is not None:
        # to the experts' ranks: [ep, E/ep, C, H] -> [E/ep, ep * C, H]
        slots = _exchange(slots.reshape(ep, per, capacity, h), group)
        slots = slots.transpose(0, 1).reshape(per, ep * capacity, h)
    slots = _expert_ffn(p_local, slots)
    if group is not None:
        # and back to the tokens' ranks: [E/ep, ep, C, H] -> [E, C, H]
        slots = slots.reshape(per, ep, capacity, h).transpose(0, 1)
        slots = _exchange(slots, group).reshape(n_experts, capacity, h)
    down = torch.einsum("tec,ech->th", combine, slots).reshape(b, s, h)
    out = _finish_block(p_local, cfg, hidden_local, down, None)
    if group is not None:
        from torch.distributed.nn.functional import all_reduce

        aux = {k: all_reduce(v, group=group) / ep for k, v in aux.items()}
    return out, aux
