"""Pipeline parallelism (GPipe) over a 'pp' process group (counterpart of
``spmm_tpu.parallel.pp``).

The reference has no pipeline parallelism, and this model family does not
need it (12 layers of a 110 M-parameter model fit one card); JAX's module
is the building block anyway, and this is its port: a microbatch-pipelined
forward of a homogeneous stack of self-attention layers, the truncated
text section ``layers[:fusion_layer]`` that every MoleculeNet fine-tune
runs (spmm_tpu/parallel/pp.py:13-18).

- :func:`pp_mesh` is a 1-D process group over the first ``pp`` ranks, apart
  from the ('dp', 'tp' | 'fsdp') mesh of ``parallel.mesh``, as JAX's
  ``pp_mesh`` is a mesh of its own;
- :func:`stage_layers` is JAX's ``stack_stage_params`` (:61): a rank's own
  contiguous slice of the layers, the modules themselves;
- :func:`pipeline_encoder_forward` runs JAX's schedule (:115-157): S
  stages, M microbatches, stage s runs microbatch m at tick m + s.  Bubble
  ticks are skipped rather than computed and thrown away.  Activations go
  to stage s + 1 by point-to-point send and receive, and the last stage's
  output is broadcast to every rank of the group, which is what JAX's
  final ``psum`` of zeros and the last stage's outputs gives.

The forward is deterministic (no dropout), as JAX's (:27-30).  It is
differentiable: the gradient of a loss of the replicated output reaches
each stage's layers equal to the sequential stack's gradient of those
layers.  The backward is one explicit reverse schedule, microbatches in
reverse order on every rank, inside a single ``torch.autograd.Function``:
NCCL's point-to-point calls carry no tags (gloo's default tag is 0), so
transfers that autograd ordered on its own could pair the wrong
microbatches.  Every rank computes the same loss of the replicated output,
so the backward of the replication takes the last stage's own cotangent:
summing the ranks' cotangents, as an all-reduce's backward does, would
scale every stage's gradient by S.  Every rank of the group runs the
backward (the transfers need them all); the input's gradient is broadcast
from stage 0, so it is replicated too.

``attention_impl`` passes through to the layers: under ``torch.no_grad()``
on the card ``"kernel"`` runs every stage's attention through kernel 2
(``ops.fused_attention``), the fine-tune evaluation's path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from spmm_tpu_torch.configs import BertArchConfig

PP_AXIS = "pp"

Tensor = torch.Tensor


def pp_mesh(pp: int) -> dist.ProcessGroup:
    """The 1-D pipeline group over the first ``pp`` ranks of the default
    group.  Every rank calls it (a group is made collectively); a rank past
    ``pp`` gets a handle it cannot run a pipeline with."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < pp:
        raise ValueError(f"need {pp} ranks for pp={pp}, have {world}")
    return dist.new_group(ranks=list(range(pp)))


def stage_layers(layers: Sequence[nn.Module], n_stages: int,
                 stage: int) -> nn.ModuleList:
    """Stage ``stage``'s contiguous slice of ``layers`` (JAX's stage slab,
    ``stack_stage_params``, spmm_tpu/parallel/pp.py:61-78): the modules
    themselves, so the stage trains the model's own layers."""
    n_layers = len(layers)
    if n_layers % n_stages:
        raise ValueError(
            f"{n_layers} layers do not divide into {n_stages} stages")
    per = n_layers // n_stages
    return nn.ModuleList(layers[stage * per:(stage + 1) * per])


class _Schedule:
    """One pipeline call: the stage, its place in the group and the
    microbatches."""

    def __init__(self, stage: Sequence[nn.Module], group, n_micro: int,
                 attention_impl: str):
        self.stage, self.group, self.n_micro = stage, group, n_micro
        self.impl = attention_impl
        self.s, self.n_stages = 0, 1
        if group is not None:
            self.s = dist.get_rank(group)
            self.n_stages = dist.get_world_size(group)
            if self.s < 0:
                raise ValueError("this rank is not in the pipeline group")
        self.first = self.s == 0
        self.last = self.s == self.n_stages - 1

    def peer(self, s: int) -> int:
        return dist.get_global_rank(self.group, s)

    def run(self, x: Tensor, mask: Tensor) -> Tensor:
        for layer in self.stage:
            x = layer(x, mask, attention_impl=self.impl)
        return x

    def forward(self, micro: Tensor, masks: Tensor, keep: bool):
        """Every microbatch through this stage, in order: received from
        the stage before (stage 0 takes it from ``micro``), run, sent to the
        stage after.  Returns the last stage's outputs [M, mb, L, H]
        broadcast to the group, and with ``keep`` each microbatch's (input,
        output) with their graph for the backward."""
        sends, saved, outs = [], [], []
        for m in range(self.n_micro):
            if self.first:
                x = micro[m]
            else:
                x = torch.empty_like(micro[m])
                dist.recv(x, src=self.peer(self.s - 1), group=self.group)
            if keep:
                x = x.detach().requires_grad_(
                    not self.first or micro.requires_grad)
                with torch.enable_grad():
                    y = self.run(x, masks[m])
                saved.append((x, y))
                y = y.detach()
            else:
                y = self.run(x, masks[m])
            if self.last:
                outs.append(y)
            else:
                sends.append(dist.isend(y.contiguous(),
                                        dst=self.peer(self.s + 1),
                                        group=self.group))
        for work in sends:
            work.wait()
        out = (torch.stack(outs) if self.last
               else torch.empty_like(micro))
        if self.n_stages > 1:
            dist.broadcast(out, src=self.peer(self.n_stages - 1),
                           group=self.group)
        return out, saved

    def backward(self, saved: list, grad_out: Tensor, params: list,
                 input_grad: bool):
        """The reverse schedule: microbatches M-1 .. 0 on every rank, each
        output's cotangent from the stage after (the last stage: its own
        cotangent of the replicated output), its input's sent to the stage
        before.  Returns (the input's gradient [M, mb, L, H] broadcast from
        stage 0, or None; the parameters' gradients)."""
        sends = []
        grads = [None] * len(params)
        grad_in = torch.zeros_like(grad_out) if input_grad else None
        for m in reversed(range(self.n_micro)):
            x, y = saved[m]
            if self.last:
                g = grad_out[m]
            else:
                g = torch.empty_like(y)
                dist.recv(g, src=self.peer(self.s + 1), group=self.group)
            wants = [x] if x.requires_grad else []
            got = torch.autograd.grad(y, wants + params, g,
                                      allow_unused=True)
            for i, gp in enumerate(got[len(wants):]):
                if gp is not None:
                    grads[i] = gp if grads[i] is None else grads[i] + gp
            if not self.first:
                sends.append(dist.isend(got[0].contiguous(),
                                        dst=self.peer(self.s - 1),
                                        group=self.group))
            elif input_grad:
                grad_in[m] = got[0]
        for work in sends:
            work.wait()
        if input_grad and self.n_stages > 1:
            dist.broadcast(grad_in, src=self.peer(0), group=self.group)
        return grad_in, grads


class _Pipeline(torch.autograd.Function):
    """The forward ticks in ``forward``, the reverse ticks in ``backward``:
    the transfers run in one fixed order on every rank."""

    @staticmethod
    def forward(ctx, sched: _Schedule, micro: Tensor, masks: Tensor,
                *params: Tensor) -> Tensor:
        out, saved = sched.forward(micro, masks, keep=True)
        ctx.sched, ctx.saved, ctx.params = sched, saved, params
        return out

    @staticmethod
    def backward(ctx, grad_out: Tensor):
        grad_in, grads = ctx.sched.backward(
            ctx.saved, grad_out.contiguous(), list(ctx.params),
            ctx.needs_input_grad[1])
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, ctx.params)]
        return (None, grad_in, None, *grads)


def pipeline_encoder_forward(
    stage: Sequence[nn.Module],
    cfg: BertArchConfig,
    hidden: Tensor,
    additive_self_mask: Tensor,
    group: Optional[dist.ProcessGroup],
    n_microbatches: int,
    attention_impl: str = "plain",
) -> Tensor:
    """GPipe forward of a homogeneous self-attention stack
    (``pipeline_encoder_forward``, spmm_tpu/parallel/pp.py:93-159).

    ``stage``: this rank's layers (:func:`stage_layers`); ``group``: the
    pipeline group (:func:`pp_mesh`; None is one stage in this process).
    ``hidden`` [B, L, H] and ``additive_self_mask`` [B, 1, 1|L, L], the
    same on every rank, are split into ``n_microbatches`` along the batch.
    Returns, on every rank, the [B, L, H] that the sequential stack
    (``BertEncoder`` over those layers) returns.  ``cfg`` is the stack's
    config, as JAX's signature has it; the layers carry their own."""
    batch = hidden.shape[0]
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} not divisible by "
                         f"n_microbatches={n_microbatches}")
    sched = _Schedule(stage, group, n_microbatches, attention_impl)
    micro = hidden.reshape((n_microbatches, -1) + hidden.shape[1:])
    masks = additive_self_mask.reshape(
        (n_microbatches, -1) + additive_self_mask.shape[1:])
    params = [p for layer in stage for p in layer.parameters()
              if p.requires_grad]
    if torch.is_grad_enabled() and (hidden.requires_grad or params):
        out = _Pipeline.apply(sched, micro, masks, *params)
    else:
        out, _ = sched.forward(micro, masks, keep=False)
    return out.reshape(hidden.shape)
