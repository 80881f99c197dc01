"""The optimizers of MoCo-v3 that PyTorch has no exact counterpart for: LARS
(the ResNet-50 recipe) and AdamW (the ViT recipe), the port's own
counterparts of `optax.lars` and `optax.adamw`.

LARS. One step follows optax's chain in its order, per parameter:

    u = g + wd * p                   add_decayed_weights  (ndim > 1 only)
    u = u * tc * |p| / |u|           scale_by_trust_ratio (ndim > 1 only;
                                     ratio 1 where |p| or |u| is 0)
    u = -lr * u                      scale_by_learning_rate
    buf = u + momentum * buf         trace
    p = p + buf

The momentum accumulates the lr-scaled update (not the raw gradient, as
the usual PyTorch LARS does), so a change of lr acts through the buffer.
Both masks are `ndim > 1`: biases and BatchNorm parameters take plain
momentum SGD at the schedule's lr.

AdamW. `optax.adamw`'s chain (scale_by_adam, add_decayed_weights on every
parameter, scale_by_learning_rate), with its bias corrections
`1 - beta**count` computed in f32 as optax computes them:
`torch.optim.AdamW` computes them in f64, and f32's 0.999 is 1.3e-5 off,
which moves the first steps' updates by about 6e-6 of their size. Its 16
foreach calls cost more than torch's one fused kernel: 5.57 against 0.55
ms a step over ViT-S/16's 42.8M parameters on an H100 (`chip_smoke.py`
phase 8).

    mu = (1 - b1) * g + b1 * mu;   nu = (1 - b2) * g * g + b2 * nu
    u = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd * p;   p = p - lr * u

Both take the lr from their param groups, which the step sets from the
schedule before each update; a parameter without a gradient is skipped.
Their `state_dict()` is `torch.optim.Optimizer`'s: LARS's
`momentum_buffer`, AdamW's `exp_avg` (mu), `exp_avg_sq` (nu) and `step`.
The update functions (`lars_trust_ratio`, `lars_momentum_`,
`adamw_foreach_`) are shared with their ZeRO-1 versions
(`parallel/zero.py`), which apply them to each process's slices.
"""

from __future__ import annotations

import torch


def lars_trust_ratio(p_norm: torch.Tensor, u_norm: torch.Tensor, tc: float,
                     eps: float) -> torch.Tensor:
    """optax's `scale_by_trust_ratio`: tc * |p| / (|u| + eps), and 1 where
    |p| or |u| is 0."""
    ratio = tc * p_norm / (u_norm + eps)
    return torch.where((p_norm == 0) | (u_norm == 0), 1.0, ratio)


def lars_momentum_(state: dict, u: torch.Tensor, lr: float, momentum: float) -> torch.Tensor:
    """`scale_by_learning_rate` then `trace`: buf = -lr * u + momentum * buf
    (buf = -lr * u on the first step); returns buf, the step to add."""
    u = u * -lr
    buf = state.get("momentum_buffer")
    if buf is None:
        buf = state["momentum_buffer"] = u.clone()
    else:
        buf.mul_(momentum).add_(u)
    return buf


class LARS(torch.optim.Optimizer):
    def __init__(self, params, lr: float, weight_decay: float = 0.0, momentum: float = 0.9,
                 trust_coefficient: float = 0.001, eps: float = 0.0):
        defaults = dict(lr=lr, weight_decay=weight_decay, momentum=momentum,
                        trust_coefficient=trust_coefficient, eps=eps)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("LARS takes no closure")
        for group in self.param_groups:
            wd, tc, eps = group["weight_decay"], group["trust_coefficient"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad
                if p.ndim > 1:
                    u = u + wd * p
                    u = u * lars_trust_ratio(torch.linalg.vector_norm(p),
                                             torch.linalg.vector_norm(u), tc, eps)
                p.add_(lars_momentum_(self.state[p], u, group["lr"], group["momentum"]))


def adamw_foreach_(params: list, grads: list, states: list, group: dict) -> None:
    """One AdamW update of `params` (in place) from `grads`, with each
    parameter's state dict in `states` (`exp_avg`, `exp_avg_sq` and `step`,
    made on the first call): the foreach chain of the module docstring,
    one step count for all of them."""
    b1, b2 = group["betas"]
    for p, s in zip(params, states):
        if not s:
            s.update(step=0, exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
    mus = [s["exp_avg"] for s in states]
    nus = [s["exp_avg_sq"] for s in states]
    torch._foreach_mul_(mus, b1)
    torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(nus, b2)
    torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
    # one count per group: every parameter of it steps together
    count = states[0]["step"] + 1
    for s in states:
        s["step"] = count
    f32 = torch.float32
    bc1 = float(1 - torch.tensor(b1, dtype=f32) ** torch.tensor(count, dtype=f32))
    bc2 = float(1 - torch.tensor(b2, dtype=f32) ** torch.tensor(count, dtype=f32))
    denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
    torch._foreach_add_(denom, group["eps"])
    updates = torch._foreach_div(torch._foreach_div(mus, bc1), denom)
    if group["weight_decay"]:
        torch._foreach_add_(updates, torch._foreach_mul(params, group["weight_decay"]))
    torch._foreach_mul_(updates, -group["lr"])
    torch._foreach_add_(params, updates)


class AdamW(torch.optim.Optimizer):
    def __init__(self, params, lr: float, betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                adamw_foreach_(params, [p.grad for p in params],
                               [self.state[p] for p in params], group)
