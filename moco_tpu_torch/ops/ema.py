"""Momentum (EMA) update of the key encoder and the MoCo-v3 momentum ramp
(port of `moco_tpu/ops/ema.py`).

Parameters only: the key encoder's BatchNorm running statistics evolve
through its own forward passes and are never averaged. The key encoder's
parameters are matched to the query encoder's by name, so a key encoder that
is a part of the query one (v3: backbone and projector, without the
predictor) is covered exactly.
"""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def ema_update(model_k: nn.Module, model_q: nn.Module, momentum: float,
               local=None) -> None:
    """In place over the key encoder's parameters: `p_k <- m * p_k + (1 - m)
    * p_q`, with `p_q` the query parameter of the same name. `local(p)`
    names the tensor that holds `p` (`parallel/fsdp.py`: a process's shard
    of a split parameter); the update is elementwise, so on shards it is the
    update of the whole parameters, bit for bit."""
    q = dict(model_q.named_parameters())
    names = [n for n, _ in model_k.named_parameters()]
    missing = [n for n in names if n not in q]
    if missing:
        raise ValueError(f"the query encoder has no parameters {missing[:5]} of the key "
                         "encoder")
    pk = [p for _, p in model_k.named_parameters()]
    pq = [q[n] for n in names]
    if local is not None:
        pk, pq = [local(p) for p in pk], [local(p) for p in pq]
    torch._foreach_mul_(pk, momentum)
    torch._foreach_add_(pk, torch._foreach_mul(pq, 1.0 - momentum))


def momentum_schedule(base_m: float, step: int, total_steps: int) -> float:
    """MoCo-v3's ramp: m rises from `base_m` to 1 on a cosine over
    training, computed in f32 as the JAX package computes it."""
    frac = torch.tensor(step, dtype=torch.float32) / max(total_steps, 1)
    return float(1.0 - (1.0 - base_m) * 0.5 * (1.0 + torch.cos(math.pi * frac)))
