"""Learning-rate schedules (port of `moco_tpu/ops/schedules.py`), on Python
floats: the lr is set on the optimizer from the host each step."""

from __future__ import annotations

import math


def cosine_lr(base_lr: float, epoch: float, total_epochs: int) -> float:
    """`base * 0.5 * (1 + cos(pi * epoch / total))` (the `--cos` branch)."""
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / total_epochs))


def step_lr(base_lr: float, epoch: float, milestones: tuple[int, ...]) -> float:
    """x0.1 at each milestone of `--schedule`."""
    return base_lr * 0.1 ** sum(epoch >= m for m in milestones)


def warmup_cosine_lr(base_lr: float, epoch: float, total_epochs: int,
                     warmup_epochs: int) -> float:
    """Linear warmup to `base_lr`, then cosine."""
    if epoch < warmup_epochs:
        return base_lr * epoch / max(warmup_epochs, 1e-8)
    frac = (epoch - warmup_epochs) / max(total_epochs - warmup_epochs, 1e-8)
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * frac))
