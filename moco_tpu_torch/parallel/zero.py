"""ZeRO-1 over the data-parallel group (port of `moco_tpu/parallel/zero.py`).

The optimizer's state (SGD's and LARS's momentum, AdamW's two moments: one
or two f32 copies of every parameter) is split over the processes instead
of replicated, so each holds 1/n of it. The layout is the JAX package's
`opt_state_shardings` rule: each state tensor is split on its parameter's
LARGEST axis that the world size divides, and stays whole on every process
when no axis divides (`shard_axis`); AdamW's step count is a number and
stays whole.

A step applies the plain optimizer's own update to this process's slice of
each split parameter, its gradient slice and its state slices, and to the
whole of each parameter that is not split; then one flat all-gather per
dtype of the updated slices gives every process the full parameters again,
before the next step's EMA reads them.

- `ShardedSGD`: `torch.optim.SGD` with its update function
  (`torch.optim.sgd.sgd`, the function `SGD.step` calls, with the same
  foreach choice).
- `ShardedAdamW`: `ops/optim.py::AdamW`'s foreach chain
  (`adamw_foreach_`), its f32 bias corrections, one step count for the
  group.
- `ShardedLARS`: `ops/optim.py::LARS`. Its trust ratio needs each
  parameter's WHOLE |p| and |u| (u = g + wd*p): each process sums the
  squares of its slices of every split parameter with ndim > 1, one
  all-reduce (SUM) of one flat f32 [2, n_split] buffer a step gives the
  global sums, and their square roots enter the same ratio rule. A
  parameter that is not split takes the plain norm.

SGD's and AdamW's updates are elementwise, so each element goes through the
same arithmetic as under the plain optimizer and the two runs are equal bit
for bit. LARS's norms add in another order than `torch.linalg.vector_norm`
of the whole tensor, so it agrees to float rounding, not bit for bit.

Not `torch.distributed.optim.ZeroRedundancyOptimizer`: that class hands
whole parameters to ranks greedily, not 1/n of every parameter, and its
state dict needs a consolidating collective of its own. Here
`state_dict()` gathers the full state in the plain optimizer's layout (a
collective: every process calls it), so a ZeRO checkpoint restores at any
world size and with ZeRO off, and `load_state_dict` takes a full state dict
and keeps this process's slices.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.optim.sgd import sgd

from moco_tpu_torch.ops.optim import LARS, AdamW, adamw_foreach_, lars_momentum_, \
    lars_trust_ratio
from moco_tpu_torch.parallel.mesh import rank, world_size


def shard_axis(shape, n: int) -> int | None:
    """The axis a buffer of `shape` is split on over `n` processes: the
    largest one `n` divides (the first of equal ones); None when none does."""
    best = None
    for ax, s in enumerate(shape):
        if s > 0 and s % n == 0 and (best is None or s > shape[best]):
            best = ax
    return best


class _Sharded:
    """What the three sharded optimizers share: the split of each
    parameter over the group, the flat all-gather, the state's bytes, and
    the full-state `state_dict` / `load_state_dict`. `SPLIT_KEYS` names the
    state tensors that are split like their parameter."""

    SPLIT_KEYS: tuple[str, ...] = ()

    def _init_sharding(self, group) -> None:
        if len(self.param_groups) != 1:
            raise ValueError(f"{type(self).__name__} takes one parameter group")
        self.group = group
        self.n, self.rank = world_size(group), rank(group)
        self.axes = {p: shard_axis(p.shape, self.n) for p in self.param_groups[0]["params"]}

    def _slice(self, t: torch.Tensor, p, r: int) -> torch.Tensor:
        ax = self.axes[p]
        size = p.shape[ax] // self.n
        return t.narrow(ax, r * size, size)

    def _local(self, p) -> tuple[torch.Tensor, torch.Tensor]:
        """(parameter, gradient) this process updates: its slices (copies),
        or the whole parameter in place when it is not split."""
        if self.axes[p] is None:
            return p, p.grad
        return (self._slice(p, p, self.rank).contiguous(),
                self._slice(p.grad, p, self.rank).contiguous())

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

    def _write_back(self, live: list, locals_: list) -> None:
        """Every process's updated slices into the whole split parameters."""
        split = [(p, lp) for p, lp in zip(live, locals_) if self.axes[p] is not None]
        self._gather([p for p, _ in split], [p for p, _ in split], [s for _, s in split])

    def state_bytes(self) -> int:
        """Bytes of optimizer state this process holds."""
        return sum(v.numel() * v.element_size() for s in self.state.values()
                   for v in s.values() if isinstance(v, torch.Tensor))

    def state_dict(self) -> dict:
        """The plain optimizer's state dict with the FULL state tensors,
        gathered from every process: a collective, every process calls it."""
        sd = super().state_dict()
        params = self.param_groups[0]["params"]
        sd["state"] = {i: dict(s) for i, s in sd["state"].items()}
        for key in self.SPLIT_KEYS:
            split = [i for i, s in sd["state"].items()
                     if self.axes[params[i]] is not None and s.get(key) is not None]
            fulls = [torch.empty_like(params[i]) for i in split]
            self._gather(fulls, [params[i] for i in split],
                         [sd["state"][i][key] for i in split])
            for i, full in zip(split, fulls):
                sd["state"][i][key] = full
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        """Load a plain optimizer's state dict (full state tensors, from a
        run with or without ZeRO at any world size) and keep this process's
        slices."""
        super().load_state_dict(state_dict)
        for p, s in self.state.items():
            if self.axes[p] is None:
                continue
            for key in self.SPLIT_KEYS:
                if s.get(key) is not None:
                    s[key] = self._slice(s[key], p, self.rank).contiguous().clone()


class ShardedSGD(_Sharded, torch.optim.SGD):
    """SGD with momentum whose momentum buffers are split over `group`
    (see the module docstring). Only the momentum is split: parameters and
    gradients stay whole on every process."""

    SPLIT_KEYS = ("momentum_buffer",)

    def __init__(self, params, group, **kw):
        super().__init__(params, **kw)
        self._init_sharding(group)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ShardedSGD.step takes no closure")
        group = self.param_groups[0]
        live = [p for p in group["params"] if p.grad is not None]
        params, grads = zip(*map(self._local, live)) if live else ((), ())
        params, grads = list(params), list(grads)
        bufs = [self.state[p].get("momentum_buffer") for p in live]
        sgd(params, grads, bufs, weight_decay=group["weight_decay"],
            momentum=group["momentum"], lr=group["lr"], dampening=group["dampening"],
            nesterov=group["nesterov"], maximize=group["maximize"],
            foreach=group["foreach"], fused=group["fused"], has_sparse_grad=False)
        if group["momentum"] != 0:
            for p, buf in zip(live, bufs):
                self.state[p]["momentum_buffer"] = buf
        self._write_back(live, params)


class ShardedAdamW(_Sharded, AdamW):
    """`ops/optim.py::AdamW` whose `exp_avg` and `exp_avg_sq` are split over
    `group` (see the module docstring)."""

    SPLIT_KEYS = ("exp_avg", "exp_avg_sq")

    def __init__(self, params, group, **kw):
        super().__init__(params, **kw)
        self._init_sharding(group)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ShardedAdamW.step takes no closure")
        group = self.param_groups[0]
        live = [p for p in group["params"] if p.grad is not None]
        if not live:
            return
        params, grads = map(list, zip(*map(self._local, live)))
        adamw_foreach_(params, grads, [self.state[p] for p in live], group)
        self._write_back(live, params)


class ShardedLARS(_Sharded, LARS):
    """`ops/optim.py::LARS` whose momentum buffers are split over `group`,
    with the norms of split parameters summed over the group (see the
    module docstring)."""

    SPLIT_KEYS = ("momentum_buffer",)

    def __init__(self, params, group, **kw):
        super().__init__(params, **kw)
        self._init_sharding(group)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ShardedLARS.step takes no closure")
        group = self.param_groups[0]
        wd, tc, eps = group["weight_decay"], group["trust_coefficient"], group["eps"]
        live = [p for p in group["params"] if p.grad is not None]
        params, us = [], []
        for p in live:
            lp, u = self._local(p)
            if p.ndim > 1:
                u = u + wd * lp
            params.append(lp)
            us.append(u)
        # the squares of the split slices, summed over the group in one call
        split = [i for i, p in enumerate(live) if p.ndim > 1 and self.axes[p] is not None]
        norms = {}
        if split:
            sums = torch.stack([torch.stack([params[i].float().square().sum(),
                                             us[i].float().square().sum()])
                                for i in split], dim=1)
            if self.group is not None:
                dist.all_reduce(sums, group=self.group)
            norms = dict(zip(split, sums.sqrt().unbind(1)))
        for i, p in enumerate(live):
            u = us[i]
            if p.ndim > 1:
                if i in norms:
                    p_norm, u_norm = norms[i]
                else:
                    p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
                u = u * lars_trust_ratio(p_norm, u_norm, tc, eps)
            params[i].add_(lars_momentum_(self.state[p], u, group["lr"], group["momentum"]))
        self._write_back(live, params)
