"""FSDP for the MoCo-v3 pretrain step (port of `moco_tpu/parallel/fsdp.py`).

Behind `PretrainConfig.sharding`:

  dp       every process holds every parameter and the whole optimizer
           state (the step of `v3_step.py` as it was).
  fsdp     every process holds 1/n of each parameter and of its optimizer
           state; the step gathers the full parameters on use and slices
           the synced gradient back to the process's shard.
  fsdp_tp  the same over an inner group of K processes (`sharding_axis_size`),
           the M = n / K groups replicas of each other: the gathers stay
           inside a group, the gradient's mean spans all n, and
           `grad_sync="quantized"` becomes the two-hop reduce
           (`collectives.multihop_quantized_mean`).

The layout is the JAX package's per-leaf rule: a parameter keeps its
logical shape and is split on its LARGEST axis that K divides
(`zero.shard_axis` with n = K; the first of equal ones); a parameter with
no such axis stays whole on every process. Every parameter of both
encoders is split, the frozen patch embedding too, so the bytes a process
holds agree with a JAX device's. Each process keeps its slices as tensors
of their own (`ShardingPlan.shards`); the optimizer updates them.

The modules keep their `nn.Parameter` objects, so the gradient sync's
hooks, `named_parameters`, the health diagnostics and remat see the model
as under dp. Between steps a split parameter's storage is released
(`untyped_storage().resize_(0)`: its shape stays, its bytes go); the step
refills it from one all-gather per dtype over the fsdp group
(`ShardingPlan.gather`), runs the forwards and the backward on the full
weights, and `release()`s it after the update. The step, in the JAX step's
order (`v3_step.py`):

1. the EMA on the shards (elementwise: a query shard and its key shard are
   split alike);
2. gather both encoders;
3. the key forward, the query forward and backward;
4. `GradSync.finish` on the full gradients, over every process, as dp;
5. the optimizer takes this process's slice of each synced gradient: the
   JAX step's "psum + slice", so the adds run in the dp order;
6. the health drift, read before the storage is released;
7. the optimizer on the shards;
8. release.

SGD's and AdamW's updates are elementwise and each shard element goes
through the dp arithmetic, so fsdp and fsdp_tp under the fused and
bucketed syncs equal dp bit for bit. LARS's norms sum its shards' squares
over the fsdp group (`ShardedLARS`'s route), equal to float rounding.

Not `torch.distributed.fsdp`: its reduce-scatter adds in another order than
the dp all-reduce (no bit-for-bit gate), it splits flat or on dim 0 (other
bytes a process, another checkpoint tree), it would bypass the four
`grad_sync` modes, and its state dict needs a consolidation of its own.
Here a checkpoint is the dp state's logical tree: a save gathers (every
process calls it, as ZeRO's `state_dict` does), and a restore keeps this
process's slices, at any world size and from any mode.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

from moco_tpu_torch.parallel.zero import ShardedAdamW, ShardedLARS, ShardedSGD, shard_axis


class ShardingPlan:
    """The split of both encoders' parameters over the fsdp group of one
    `parallel/mesh.py::Layout`, and this process's shards of them."""

    def __init__(self, layout):
        self.layout = layout
        self.n_shard = layout.fsdp
        self.group = layout.fsdp_group
        self.rank = layout.fsdp_rank
        self.axes: dict = {}    # split parameter -> the axis it is split on
        self.shards: dict = {}  # split parameter -> this process's slice of it

    def leaf_axis(self, shape) -> int | None:
        """The axis a parameter of `shape` is split on: its largest one the
        fsdp group's size divides; None (whole) when none does."""
        return shard_axis(tuple(shape), self.n_shard)

    def _slice(self, t: torch.Tensor, p) -> torch.Tensor:
        ax = self.axes[p]
        size = p.shape[ax] // self.n_shard
        return t.narrow(ax, self.rank * size, size)

    @torch.no_grad()
    def shard(self, *models) -> None:
        """Split every parameter of `models` that has an axis to split on:
        keep this process's slice, release the full storage."""
        for model in models:
            for name, p in model.named_parameters():
                ax = self.leaf_axis(p.shape)
                if ax is None:
                    continue
                if (p.storage_offset() or not p.is_contiguous()
                        or p.untyped_storage().nbytes() != p.numel() * p.element_size()):
                    raise ValueError(f"fsdp needs each parameter to own its storage; {name} "
                                     "shares one")
                self.axes[p] = ax
                self.shards[p] = self._slice(p.detach(), p).clone()
        self.release()

    def local(self, p: torch.Tensor) -> torch.Tensor:
        """What this process holds of parameter `p`: its shard, or `p`
        itself when it is whole."""
        return self.shards.get(p, p)

    def is_full(self) -> bool:
        """Whether the split parameters hold their full values."""
        return all(p.untyped_storage().nbytes() for p in self.shards)

    def materialize(self) -> None:
        """Give every split parameter its full storage back (uninitialized)."""
        for p in self.shards:
            storage = p.data.untyped_storage()
            need = p.numel() * p.element_size()
            if storage.nbytes() != need:
                storage.resize_(need)

    @torch.no_grad()
    def gather(self) -> None:
        """Refill every split parameter from the fsdp group's shards: one
        all-gather per dtype, a collective every process of the group calls."""
        self.materialize()
        by_dtype: dict[torch.dtype, list] = {}
        for p in self.shards:
            by_dtype.setdefault(p.dtype, []).append(p)
        k = self.n_shard
        for ps in by_dtype.values():
            flat = torch.cat([self.shards[p].reshape(-1) for p in ps])
            if self.group is None:
                out = flat
            else:
                out = flat.new_empty(k * flat.numel())
                dist.all_gather_into_tensor(out, flat, group=self.group)
            out = out.view(k, -1)
            off = 0
            for p in ps:
                n = self.shards[p].numel()
                pre = math.prod(p.shape[:self.axes[p]])
                # rank r's slice is rows [r*s, (r+1)*s) of the split axis
                p.data.view(pre, k, n // pre).copy_(
                    out[:, off:off + n].view(k, pre, n // pre).transpose(0, 1))
                off += n

    def release(self) -> None:
        """Free the split parameters' full storage and gradients (their
        shapes stay); the shards are what this process holds."""
        for p in self.shards:
            p.grad = None
            p.data.untyped_storage().resize_(0)

    @torch.no_grad()
    def reshard(self) -> None:
        """Copy this process's slices of the (full) split parameters into
        its shards: after a restore loaded the full values."""
        for p, s in self.shards.items():
            s.copy_(self._slice(p.detach(), p))

    @contextlib.contextmanager
    def gathered(self):
        """The full parameters for the body (a save, the kNN monitor, an
        export): gathered unless they already are, released after if this
        gathered them. Every process of the group enters it."""
        if self.is_full():
            yield
            return
        self.gather()
        try:
            yield
        finally:
            self.release()


def plan_for(config, layout) -> ShardingPlan | None:
    """The config's plan over `layout`, or None for dp (and for no layout:
    the one-process step)."""
    if config.sharding == "dp" or layout is None:
        return None
    return ShardingPlan(layout)


class _OnShards:
    """What makes a ZeRO-1 optimizer of `parallel/zero.py` an fsdp one: it
    updates the plan's shards with this process's slice of each synced
    gradient, and gathers nothing after (the next step does)."""

    def _bind_plan(self, plan: ShardingPlan) -> None:
        self.plan = plan
        # the plan's own split: the two can never disagree
        self.axes = {p: plan.axes.get(p) for p in self.param_groups[0]["params"]}

    def _local(self, p):
        if self.axes[p] is None:
            return p, p.grad
        return self.plan.shards[p], self._slice(p.grad, p, self.rank).contiguous()

    def _write_back(self, live: list, locals_: list) -> None:
        return None


class FSDPSGD(_OnShards, ShardedSGD):
    """SGD with momentum on the shards (`ShardedSGD`'s update)."""

    def __init__(self, params, plan: ShardingPlan, **kw):
        super().__init__(params, plan.group, **kw)
        self._bind_plan(plan)


class FSDPAdamW(_OnShards, ShardedAdamW):
    """`ops/optim.py::AdamW` on the shards."""

    def __init__(self, params, plan: ShardingPlan, **kw):
        super().__init__(params, plan.group, **kw)
        self._bind_plan(plan)


class FSDPLARS(_OnShards, ShardedLARS):
    """`ops/optim.py::LARS` on the shards, the split parameters' norms
    summed over the fsdp group."""

    def __init__(self, params, plan: ShardingPlan, **kw):
        super().__init__(params, plan.group, **kw)
        self._bind_plan(plan)


def state_shardings(state) -> dict:
    """The split of a state's parameters: `{"model_q": {name: axis}, "model_k":
    {...}}`, None for a whole parameter (every one under dp). An optimizer
    state tensor is split as its parameter is; the gradient-sync
    accumulators stay whole on each process (its own, `[world, ...]` on
    disk)."""
    plan = getattr(state, "fsdp", None)
    axes = {} if plan is None else plan.axes
    return {name: {n: axes.get(p) for n, p in getattr(state, name).named_parameters()}
            for name in ("model_q", "model_k")}


def place_state(state, config, layout):
    """Split `state` as `config.sharding` asks over `layout` (a no-op for dp
    and with no layout): shard both encoders and put the optimizer on the
    shards (its state, if it has one, kept as this process's slices).
    After the state is built and before any restore; returns it."""
    from moco_tpu_torch.train_state import build_optimizer

    plan = plan_for(config, layout)
    if plan is None:
        return state
    saved = state.optimizer.state_dict() if state.optimizer.state else None
    plan.shard(state.model_q, state.model_k)
    state.optimizer = build_optimizer(config, state.model_q, plan=plan)
    if saved is not None:
        state.optimizer.load_state_dict(saved)
    state.fsdp = plan
    return state


def state_bytes_per_device(state) -> dict:
    """Bytes this process holds of both encoders' parameters (the shards of
    split ones) and of the optimizer's state, under the JAX package's keys;
    under fsdp about 1/K of the dp figure."""
    plan = getattr(state, "fsdp", None)

    def nbytes(tensors) -> int:
        return sum(t.numel() * t.element_size() for t in tensors)

    def held(model):
        return (p if plan is None else plan.local(p) for p in model.parameters())

    params_b = nbytes(held(state.model_q)) + nbytes(held(state.model_k))
    opt_b = nbytes(v for s in state.optimizer.state.values() for v in s.values()
                   if isinstance(v, torch.Tensor))
    return {"param_bytes_per_device": params_b, "opt_bytes_per_device": opt_b,
            "state_bytes_per_device": params_b + opt_b}
