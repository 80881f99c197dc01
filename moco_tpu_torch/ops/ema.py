"""Momentum (EMA) update of the key encoder (port of `moco_tpu/ops/ema.py`).

Parameters only: the key encoder's BatchNorm running statistics evolve
through its own forward passes and are never averaged.
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def ema_update(model_k: nn.Module, model_q: nn.Module, momentum: float) -> None:
    """In place over the parameters: `p_k <- m * p_k + (1 - m) * p_q`."""
    pk = list(model_k.parameters())
    pq = list(model_q.parameters())
    if len(pk) != len(pq):
        raise ValueError(f"encoders differ: {len(pk)} vs {len(pq)} parameters")
    torch._foreach_mul_(pk, momentum)
    torch._foreach_add_(pk, torch._foreach_mul(pq, 1.0 - momentum))
