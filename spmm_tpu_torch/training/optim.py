"""AdamW with optax's arithmetic and an optional low-precision first moment
(``optax.adamw(mu_dtype=...)``, which ``spmm_tpu.training.pretrain.
make_optimizer`` uses for ``bf16_moments``).

``torch.optim.AdamW`` keeps both moments in the parameter's dtype, so a
bf16 first moment needs an optimizer of its own.  Per element, as optax's
``scale_by_adam`` then ``add_decayed_weights`` then the learning rate:

    mu     = (1 - b1) * g + float32(mu_dtype(b1) * mu_stored)
    nu     = (1 - b2) * g * g + b2 * nu
    u      = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps) + wd * p
    p      = p - lr * u
    mu_stored = mu_dtype(mu)

The new first moment and its bias-corrected value stay float32 for this
step's update; only the stored moment is rounded, after the update.  The
decay of the stored moment runs in the moment's dtype: optax multiplies
the bf16 moment by the Python float ``b1``, which JAX's weak typing makes
a bf16 product (``b1`` itself rounded to 0.8984375).  The
state has ``torch.optim.AdamW``'s layout (``step``, ``exp_avg``,
``exp_avg_sq`` per parameter), ``exp_avg`` in ``mu_dtype``.  The standard
``(params, **defaults)`` constructor lets
``torch.distributed.optim.ZeroRedundancyOptimizer`` build one per rank
(``functools.partial(AdamW, mu_dtype=torch.bfloat16)``).

The update is elementwise, so on DTensor parameters (``parallel.tp``,
``parallel.fsdp``) it runs on each rank's local parts: the moments are
DTensors laid out as their parameters, and no list ever mixes DTensors
with plain tensors (which PyTorch's own foreach AdamW refuses).
"""

from __future__ import annotations

from typing import Optional

import torch

from spmm_tpu_torch.parallel.mesh import local_tensor


class AdamW(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 mu_dtype: Optional[torch.dtype] = None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                self._update(group, params)
        return loss

    def _update(self, group: dict, params: list) -> None:
        b1, b2 = group["betas"]
        grads = [local_tensor(p.grad) for p in params]
        mus, nus = [], []
        for p in params:
            state = self.state[p]
            mu_dtype = self.mu_dtype or p.dtype
            if not state:
                state["step"] = torch.tensor(0.0)
                state["exp_avg"] = torch.zeros_like(p, dtype=mu_dtype)
                state["exp_avg_sq"] = torch.zeros_like(p)
            elif state["exp_avg"].dtype != mu_dtype:
                # a loaded state is cast to the parameter's dtype
                # (Optimizer.load_state_dict); bf16 -> f32 -> bf16 is exact
                state["exp_avg"] = state["exp_avg"].to(mu_dtype)
            state["step"] += 1
            mus.append(local_tensor(state["exp_avg"]))
            nus.append(local_tensor(state["exp_avg_sq"]))
        # one count for the group, in float32 as optax's bias correction
        count = self.state[params[0]]["step"].to(torch.float32)
        params = [local_tensor(p) for p in params]
        bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** count).item()
        bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** count).item()
        # b1 * mu in the moment's dtype, b1 rounded to it too (JAX's weak
        # typing), then float32
        decay = torch.tensor(b1, dtype=mus[0].dtype).item()
        mu = [m.float() for m in torch._foreach_mul(mus, decay)]
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
        torch._foreach_add_(denom, group["eps"])
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_add_(upd, torch._foreach_mul(params,
                                                    group["weight_decay"]))
        torch._foreach_mul_(upd, -group["lr"])
        torch._foreach_add_(params, upd)
        torch._foreach_copy_(mus, mu)
