"""The negative-key queue (port of `moco_tpu/ops/queue.py`).

`[K, dim]` f32 rows, each unit-norm, updated in place under `no_grad`: the
queue is a plain buffer of the train state, so overwriting its oldest rows
saves a second 32 MB copy at K=65536 that a functional update would need.
The pointer is a Python int, so the enqueue never waits on the device.
"""

from __future__ import annotations

import torch

from moco_tpu_torch.ops.losses import l2_normalize


def init_queue(num_negatives: int, dim: int, generator: torch.Generator) -> torch.Tensor:
    """Random unit rows on the generator's device, f32 `[K, dim]`."""
    noise = torch.randn((num_negatives, dim), generator=generator,
                        device=generator.device, dtype=torch.float32)
    return l2_normalize(noise)


@torch.no_grad()
def dequeue_and_enqueue(queue: torch.Tensor, ptr: int, keys: torch.Tensor) -> int:
    """FIFO enqueue: `queue[ptr:ptr+B] = keys`; returns `(ptr + B) % K`.
    K must be a multiple of B, so a batch never wraps."""
    k_slots, b = queue.shape[0], keys.shape[0]
    if k_slots % b != 0:
        raise ValueError(
            f"queue size {k_slots} must be divisible by global batch {b} "
            "(reference asserts K % batch_size == 0)"
        )
    queue[ptr:ptr + b].copy_(keys)
    return (ptr + b) % k_slots
