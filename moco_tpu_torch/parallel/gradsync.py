"""The gradient mean across processes (port of `moco_tpu/parallel/gradsync.py`'s
`fused` mode, `GradSync._reduce_fused`, with its wire dtype
`grad_allreduce_dtype`, `leaf_wire_dtype`).

Every gradient is copied into one flat buffer per wire dtype, reduced by
one all-reduce, divided by the world size in the wire dtype (`pmean`) and
copied back into each parameter's `.grad` in its own dtype. Under the
`bfloat16` policy the float gradients travel in bf16 (half the bytes, no
error feedback: the lossy form); the update still runs in f32.

Not `DistributedDataParallel`: its `broadcast_buffers` copies rank 0's
BatchNorm statistics, where the reference takes their mean over devices
(the step does that with `mean_buffers`), and the later sync modes
(bucketed, quantized, DeMo; ROADMAP queue A item 3) need to own the reduce.
Gloo has no `ReduceOp.AVG`, so every mean here is a sum, then a division.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from moco_tpu_torch.parallel.mesh import world_size


def leaf_wire_dtype(dtype: torch.dtype, allreduce_dtype: str) -> torch.dtype:
    """The dtype one gradient travels in: bf16 for a float leaf under the
    `bfloat16` policy, else its own."""
    if allreduce_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown grad_allreduce_dtype {allreduce_dtype!r}")
    if dtype.is_floating_point and allreduce_dtype == "bfloat16":
        return torch.bfloat16
    return dtype


def mean_tensors_(tensors: list[torch.Tensor], group, wire=None) -> int:
    """Replace each float tensor by its mean over `group`'s processes, in
    place: one all-reduce per wire dtype over a flat copy (`wire(dtype)`
    gives it; default the tensor's own), then the division by the world
    size in that dtype. Returns the bytes put on the wire."""
    n = world_size(group)
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(wire(t.dtype) if wire else t.dtype, []).append(t)
    nbytes = 0
    for dtype, ts in by_dtype.items():
        flat = torch.cat([t.reshape(-1).to(dtype) for t in ts])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        nbytes += flat.numel() * flat.element_size()
        torch._foreach_copy_(ts, [v.view(t.shape) for v, t in
                                  zip(flat.split([t.numel() for t in ts]), ts)])
    return nbytes


class GradSync:
    """The fused gradient mean of a model's parameters over `group`."""

    def __init__(self, config, group):
        # `config` validated `grad_sync` ("fused") and the wire dtype
        self.allreduce_dtype = config.grad_allreduce_dtype
        self.group = group
        self.last_bytes = 0  # wire bytes of the last reduce

    def reduce_(self, params) -> None:
        """Mean every present `.grad` of `params` over the group, in place."""
        grads = [p.grad for p in params if p.grad is not None]
        self.last_bytes = mean_tensors_(
            grads, self.group, lambda dt: leaf_wire_dtype(dt, self.allreduce_dtype))
