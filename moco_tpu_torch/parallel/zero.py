"""ZeRO-1 over the data-parallel group (port of `moco_tpu/parallel/zero.py`).

The SGD momentum, one f32 copy of every parameter, is split over the
processes instead of replicated, so each holds 1/n of it. The layout is the
JAX package's `opt_state_shardings` rule: each momentum buffer is split on
its LARGEST axis that the world size divides, and stays whole on every
process when no axis divides (`shard_axis`).

`ShardedSGD` is `torch.optim.SGD` with that state. A step applies SGD's own
update (`torch.optim.sgd.sgd`, the function `SGD.step` calls, with the
same foreach choice) to this process's slice of each split parameter, its
gradient slice and its momentum slice, and to the whole of each parameter
that is not split; then one flat all-gather of the updated slices gives
every process the full parameters again, before the next step's EMA reads
them. The update is elementwise, so each element goes through the same
arithmetic as under the plain SGD, and the two runs are equal.

Not `torch.distributed.optim.ZeroRedundancyOptimizer`: that class hands
whole parameters to ranks greedily, not 1/n of every parameter, and its
state dict needs a consolidating collective of its own. Here
`state_dict()` gathers the full momentum in the plain SGD's layout (a
collective: every process calls it), so a ZeRO checkpoint restores at any
world size and with ZeRO off, and `load_state_dict` takes a full state dict
and keeps this process's slices.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.optim.sgd import sgd

from moco_tpu_torch.parallel.mesh import rank, world_size


def shard_axis(shape, n: int) -> int | None:
    """The axis a buffer of `shape` is split on over `n` processes: the
    largest one `n` divides (the first of equal ones); None when none does."""
    best = None
    for ax, s in enumerate(shape):
        if s > 0 and s % n == 0 and (best is None or s > shape[best]):
            best = ax
    return best


class ShardedSGD(torch.optim.SGD):
    """SGD with momentum whose momentum buffers are split over `group`
    (see the module docstring). Only the momentum is split: parameters and
    gradients stay whole on every process."""

    def __init__(self, params, group, **kw):
        super().__init__(params, **kw)
        if len(self.param_groups) != 1:
            raise ValueError("ShardedSGD takes one parameter group")
        self.group = group
        self.n, self.rank = world_size(group), rank(group)
        self.axes = {p: shard_axis(p.shape, self.n) for p in self.param_groups[0]["params"]}

    def _slice(self, t: torch.Tensor, p, r: int) -> torch.Tensor:
        ax = self.axes[p]
        size = p.shape[ax] // self.n
        return t.narrow(ax, r * size, size)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ShardedSGD.step takes no closure")
        group = self.param_groups[0]
        params, grads, bufs, split = [], [], [], []
        for p in group["params"]:
            if p.grad is None:
                continue
            if self.axes[p] is None:
                params.append(p)
                grads.append(p.grad)
            else:
                params.append(self._slice(p, p, self.rank).contiguous())
                grads.append(self._slice(p.grad, p, self.rank).contiguous())
                split.append((p, params[-1]))
            bufs.append(self.state[p].get("momentum_buffer"))
        sgd(params, grads, bufs, weight_decay=group["weight_decay"],
            momentum=group["momentum"], lr=group["lr"], dampening=group["dampening"],
            nesterov=group["nesterov"], maximize=group["maximize"],
            foreach=group["foreach"], fused=group["fused"], has_sparse_grad=False)
        if group["momentum"] != 0:
            live = [p for p in group["params"] if p.grad is not None]
            for p, buf in zip(live, bufs):
                self.state[p]["momentum_buffer"] = buf
        self._gather([p for p, _ in split], [p for p, _ in split], [s for _, s in split])

    def _gather(self, targets: list, params: list, slices: list) -> None:
        """Write every process's `slices` into the whole `targets`
        (`targets[i]` is split as `params[i]` is, and receives slice `r` from
        process `r`): one flat all-gather per dtype."""
        by_dtype: dict[torch.dtype, list[int]] = {}
        for i, s in enumerate(slices):
            by_dtype.setdefault(s.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([slices[i].reshape(-1) for i in idx])
            if self.group is None:
                out = flat
            else:
                out = flat.new_empty(self.n * flat.numel())
                dist.all_gather_into_tensor(out, flat, group=self.group)
            sizes = [slices[i].numel() for i in idx]
            for r, part in enumerate(out.view(self.n, -1)):
                for i, piece in zip(idx, part.split(sizes)):
                    dst = self._slice(targets[i], params[i], r)
                    dst.copy_(piece.view(dst.shape))

    def momentum_bytes(self) -> int:
        """Bytes of momentum this process holds."""
        return sum(s["momentum_buffer"].numel() * s["momentum_buffer"].element_size()
                   for s in self.state.values() if s.get("momentum_buffer") is not None)

    def state_dict(self) -> dict:
        """The plain SGD's state dict with the FULL momentum buffers,
        gathered from every process: a collective, every process calls it."""
        sd = super().state_dict()
        params = self.param_groups[0]["params"]
        split = [i for i in sd["state"] if self.axes[params[i]] is not None]
        fulls = [torch.empty_like(params[i]) for i in split]
        self._gather(fulls, [params[i] for i in split],
                     [sd["state"][i]["momentum_buffer"] for i in split])
        sd["state"] = {i: dict(s) for i, s in sd["state"].items()}
        for i, full in zip(split, fulls):
            sd["state"][i]["momentum_buffer"] = full
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        """Load a plain SGD state dict (full momentum buffers, from a run
        with or without ZeRO at any world size) and keep this process's
        slices."""
        super().load_state_dict(state_dict)
        for p, s in self.state.items():
            buf = s.get("momentum_buffer")
            if buf is not None and self.axes[p] is not None:
                s["momentum_buffer"] = self._slice(buf, p, self.rank).contiguous().clone()
