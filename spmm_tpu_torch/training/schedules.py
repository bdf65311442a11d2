"""LR schedules (copy of ``spmm_tpu.training.schedules``): the reference's
timm-cosine with warmup chunks, and the timm scheduler family.

The reference drives a timm ``CosineLRScheduler`` (reference
scheduler/cosine_lr.py:69-96) with an unusual cadence (SURVEY §3.1):

  - during epoch 0, ``scheduler.step(batch_idx // step_size)`` every
    ``step_size`` batches while ``batch_idx <= warmup_epochs * step_size``
    (step_size is 100 for pretrain/regression/rxn, 50 for classification);
  - from epoch 1 on, one ``scheduler.step(epoch + warmup_epochs)`` per epoch
    (pretrain steps at epoch start — SPMM_models.py:374-378; fine-tunes step
    ``epoch + warmup_epochs + 1`` at epoch END — d_classification.py:177 —
    which lands on the same t during the epoch).

Net effect, expressed directly as a function of the global step:

  t(step) = min(batch_idx // step_size, warmup_epochs)   if epoch == 0
          = epoch + warmup_epochs                        otherwise
  lr(t)   = warmup_lr + t * (base_lr - warmup_lr) / warmup_epochs   (t < warmup)
          = min_lr + 0.5*(base_lr - min_lr)*(1 + cos(pi * (t - warmup)/epochs))

Everything here is host-side Python: the train steps write the value into
the optimizer's param group before each step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Union


def reference_cosine_schedule(
    base_lr: float,
    min_lr: float,
    warmup_lr: float,
    epochs: int,
    warmup_epochs: int,
    steps_per_epoch: int,
    step_size: int = 100,
) -> Callable[[int], float]:
    """Returns lr(global_step) implementing the cadence above
    (spmm_tpu/training/schedules.py:31-58, there traced by JAX)."""

    def schedule(global_step: int) -> float:
        epoch, batch_idx = divmod(int(global_step), steps_per_epoch)
        t = (min(batch_idx // step_size, warmup_epochs) if epoch == 0
             else epoch + warmup_epochs)
        if t < warmup_epochs:
            return warmup_lr + t * (base_lr - warmup_lr) / warmup_epochs
        t_cos = max(t - warmup_epochs, 0)
        return min_lr + 0.5 * (base_lr - min_lr) * (
            1.0 + math.cos(math.pi * t_cos / epochs))

    return schedule


def _timm_noise(t: int, seed: int, pct: float, noise_type: str = "normal",
                ) -> float:
    """LR noise sample at epoch t (reference scheduler/scheduler.py:88-105):
    torch.randn seeded with (seed + t), resampled until |n| < pct ('normal'),
    or uniform in (-pct, pct)."""
    import torch

    g = torch.Generator()
    g.manual_seed(seed + t)
    if noise_type == "normal":
        while True:
            noise = torch.randn(1, generator=g).item()
            if abs(noise) < pct:
                return noise
    return 2 * (torch.rand(1, generator=g).item() - 0.5) * pct


@dataclasses.dataclass
class _TimmSchedule:
    """Common warmup + noise behavior (reference scheduler/scheduler.py:6-105).

    ``__call__(t)`` returns lr at epoch-index t, noise included — equivalent
    to the reference's ``step(t)`` followed by reading the param group lr.
    """

    base_lr: float
    warmup_t: int = 0
    warmup_lr_init: float = 0.0
    noise_range_t: Union[None, float, Sequence[float]] = None
    noise_pct: float = 0.67
    noise_std: float = 1.0
    noise_seed: int = 42

    def _warmup_target(self) -> float:
        # cosine/step warm up toward base_lr (cosine_lr.py:63-64,
        # step_lr.py:40-41); tanh overrides with _get_lr(warmup_t)
        # (tanh_lr.py:64-65)
        return self.base_lr

    def _warmup_lr(self, t: int) -> float:
        step = (self._warmup_target() - self.warmup_lr_init) / self.warmup_t
        return self.warmup_lr_init + t * step

    def _decay_lr(self, t: int) -> float:  # pragma: no cover - abstract
        raise NotImplementedError

    def _apply_noise(self, lr: float, t: int) -> float:
        if self.noise_range_t is None:
            return lr
        if isinstance(self.noise_range_t, (list, tuple)):
            apply = self.noise_range_t[0] <= t < self.noise_range_t[1]
        else:
            apply = t >= self.noise_range_t
        if not apply:
            return lr
        return lr + lr * _timm_noise(t, self.noise_seed, self.noise_pct)

    def __call__(self, t: int) -> float:
        if self.warmup_t and t < self.warmup_t:
            lr = self._warmup_lr(t)
        else:
            lr = self._decay_lr(t)
        return self._apply_noise(lr, t)


def _cycle(t: int, t_initial: int, t_mul: float) -> tuple[int, float, float]:
    """(cycle index i, cycle length t_i, position in cycle t_curr)
    (reference cosine_lr.py:76-84 / tanh_lr.py:79-87)."""
    if t_mul != 1:
        i = math.floor(math.log(1 - t / t_initial * (1 - t_mul), t_mul))
        t_i = t_mul ** i * t_initial
        t_curr = t - (1 - t_mul ** i) / (1 - t_mul) * t_initial
    else:
        i = t // t_initial
        t_i = t_initial
        t_curr = t - t_initial * i
    return i, t_i, t_curr


def _cycle_length(t_initial: int, t_mul: float, cycle_limit: int,
                  cycles: int = 0) -> int:
    """reference cosine_lr.py:110-117."""
    cycles = max(1, cycles or cycle_limit)
    if t_mul == 1.0:
        return t_initial * cycles
    return int(math.floor(-t_initial * (t_mul ** cycles - 1) / (1 - t_mul)))


@dataclasses.dataclass
class CosineSchedule(_TimmSchedule):
    """timm cosine with restarts (reference scheduler/cosine_lr.py:19-117)."""

    t_initial: int = 1
    t_mul: float = 1.0
    lr_min: float = 0.0
    decay_rate: float = 1.0
    cycle_limit: int = 0
    warmup_prefix: bool = False

    def _decay_lr(self, t: int) -> float:
        if self.warmup_prefix:
            t = t - self.warmup_t
        i, t_i, t_curr = _cycle(t, self.t_initial, self.t_mul)
        gamma = self.decay_rate ** i
        if self.cycle_limit == 0 or i < self.cycle_limit:
            lr_min, lr_max = self.lr_min * gamma, self.base_lr * gamma
            return lr_min + 0.5 * (lr_max - lr_min) * (
                1 + math.cos(math.pi * t_curr / t_i))
        return self.lr_min

    def get_cycle_length(self, cycles: int = 0) -> int:
        return _cycle_length(self.t_initial, self.t_mul, self.cycle_limit,
                             cycles)


@dataclasses.dataclass
class TanhSchedule(_TimmSchedule):
    """timm hyperbolic-tangent decay (reference scheduler/tanh_lr.py:18-120)."""

    def _warmup_target(self) -> float:
        # reference tanh_lr.py:64-65: t_v = base_values when warmup_prefix
        # else the decayed value at warmup_t
        if self.warmup_prefix:
            return self.base_lr
        return self._decay_lr(self.warmup_t)

    t_initial: int = 1
    lb: float = -6.0
    ub: float = 4.0
    t_mul: float = 1.0
    lr_min: float = 0.0
    decay_rate: float = 1.0
    cycle_limit: int = 0
    warmup_prefix: bool = False

    def _decay_lr(self, t: int) -> float:
        if self.warmup_prefix:
            t = t - self.warmup_t
        i, t_i, t_curr = _cycle(t, self.t_initial, self.t_mul)
        if self.cycle_limit == 0 or i < self.cycle_limit:
            gamma = self.decay_rate ** i
            lr_min, lr_max = self.lr_min * gamma, self.base_lr * gamma
            tr = t_curr / t_i
            return lr_min + 0.5 * (lr_max - lr_min) * (
                1 - math.tanh(self.lb * (1.0 - tr) + self.ub * tr))
        return self.lr_min * (self.decay_rate ** self.cycle_limit)

    def get_cycle_length(self, cycles: int = 0) -> int:
        return _cycle_length(self.t_initial, self.t_mul, self.cycle_limit,
                             cycles)


@dataclasses.dataclass
class StepSchedule(_TimmSchedule):
    """timm step decay (reference scheduler/step_lr.py:13-63)."""

    decay_t: float = 1.0
    decay_rate: float = 1.0

    def _warmup_target(self) -> float:
        return self.base_lr  # step warmup targets base lr (step_lr.py:41)

    def _decay_lr(self, t: int) -> float:
        return self.base_lr * (self.decay_rate ** (t // self.decay_t))


class PlateauSchedule:
    """Plateau decay (reference scheduler/plateau_lr.py:12-113, wrapping
    torch ReduceLROnPlateau semantics: rel threshold, patience, cooldown).

    Stateful: call ``step(epoch, metric)`` each epoch, read ``.lr``.
    """

    def __init__(self, base_lr, decay_rate=0.1, patience_t=10,
                 threshold=1e-4, cooldown_t=0, warmup_t=0, warmup_lr_init=0,
                 lr_min=0.0, mode="max", noise_range_t=None, noise_pct=0.67,
                 noise_std=1.0, noise_seed=42):
        self.base_lr = base_lr
        self.decay_rate = decay_rate
        self.patience_t = patience_t
        self.threshold = threshold
        self.cooldown_t = cooldown_t
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init
        self.lr_min = lr_min
        self.mode = mode
        self.noise_range_t = noise_range_t
        self.noise_pct = noise_pct
        self.noise_seed = noise_seed
        self.lr = warmup_lr_init if warmup_t else base_lr
        self._best = -math.inf if mode == "max" else math.inf
        self._num_bad = 0
        self._cooldown = 0

    def _is_better(self, metric: float) -> bool:
        # torch ReduceLROnPlateau rel-threshold comparison
        if self.mode == "max":
            return metric > self._best * (1.0 + self.threshold)
        return metric < self._best * (1.0 - self.threshold)

    def step(self, epoch: int, metric: Optional[float] = None) -> float:
        if epoch <= self.warmup_t and self.warmup_t:
            step = (self.base_lr - self.warmup_lr_init) / self.warmup_t
            self.lr = self.warmup_lr_init + epoch * step
            return self.lr
        if metric is not None:
            if self._is_better(metric):
                self._best = metric
                self._num_bad = 0
            else:
                self._num_bad += 1
            if self._cooldown > 0:
                self._cooldown -= 1
                self._num_bad = 0
            if self._num_bad > self.patience_t:
                self.lr = max(self.lr * self.decay_rate, self.lr_min)
                self._cooldown = self.cooldown_t
                self._num_bad = 0
        lr = self.lr
        if self.noise_range_t is not None:
            if isinstance(self.noise_range_t, (list, tuple)):
                apply = self.noise_range_t[0] <= epoch < self.noise_range_t[1]
            else:
                apply = epoch >= self.noise_range_t
            if apply:
                lr = lr + lr * _timm_noise(epoch, self.noise_seed,
                                           self.noise_pct)
        return lr


def create_scheduler(args):
    """Factory dispatch on ``args.sched`` (reference
    scheduler/scheduler_factory.py:10-87).  ``args`` is any object with the
    reference's attribute surface (sched, epochs, min_lr, decay_rate,
    warmup_lr, warmup_epochs, cooldown_epochs, lr, and the optional lr_noise
    family).  Returns (schedule, num_epochs) where ``schedule(t)`` gives the
    epoch-t lr (PlateauSchedule additionally exposes step(epoch, metric)).
    """
    num_epochs = args.epochs

    lr_noise = getattr(args, "lr_noise", None)
    if lr_noise is not None:
        if isinstance(lr_noise, (list, tuple)):
            noise_range = [n * num_epochs for n in lr_noise]
            if len(noise_range) == 1:
                noise_range = noise_range[0]
        else:
            noise_range = lr_noise * num_epochs
    else:
        noise_range = None
    noise_kw = dict(
        noise_range_t=noise_range,
        noise_pct=getattr(args, "lr_noise_pct", 0.67),
        noise_std=getattr(args, "lr_noise_std", 1.0),
        noise_seed=getattr(args, "seed", 42),
    )

    schedule = None
    if args.sched == "cosine":
        schedule = CosineSchedule(
            base_lr=args.lr, t_initial=num_epochs,
            t_mul=getattr(args, "lr_cycle_mul", 1.0), lr_min=args.min_lr,
            decay_rate=args.decay_rate, warmup_lr_init=args.warmup_lr,
            warmup_t=args.warmup_epochs,
            # the reference's cosine copy flips timm's warmup_prefix default
            # to True (cosine_lr.py:36); tanh keeps False (tanh_lr.py:34)
            warmup_prefix=True,
            cycle_limit=getattr(args, "lr_cycle_limit", 1), **noise_kw)
        num_epochs = schedule.get_cycle_length() + args.cooldown_epochs
    elif args.sched == "tanh":
        schedule = TanhSchedule(
            base_lr=args.lr, t_initial=num_epochs,
            t_mul=getattr(args, "lr_cycle_mul", 1.0), lr_min=args.min_lr,
            warmup_lr_init=args.warmup_lr, warmup_t=args.warmup_epochs,
            cycle_limit=getattr(args, "lr_cycle_limit", 1), **noise_kw)
        num_epochs = schedule.get_cycle_length() + args.cooldown_epochs
    elif args.sched == "step":
        schedule = StepSchedule(
            base_lr=args.lr, decay_t=args.decay_epochs,
            decay_rate=args.decay_rate, warmup_lr_init=args.warmup_lr,
            warmup_t=args.warmup_epochs, **noise_kw)
    elif args.sched == "plateau":
        mode = "min" if "loss" in getattr(args, "eval_metric", "") else "max"
        schedule = PlateauSchedule(
            base_lr=args.lr, decay_rate=args.decay_rate,
            patience_t=args.patience_epochs, lr_min=args.min_lr, mode=mode,
            warmup_lr_init=args.warmup_lr, warmup_t=args.warmup_epochs,
            cooldown_t=0, **noise_kw)

    return schedule, num_epochs
