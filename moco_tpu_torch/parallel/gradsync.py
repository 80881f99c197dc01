"""The gradient sync across processes (port of `moco_tpu/parallel/gradsync.py`).

Four modes behind `PretrainConfig.grad_sync`, each a mean of the query
encoder's gradients over the process group:

- `fused`: every gradient is copied into one flat buffer per wire dtype,
  reduced by one all-reduce, divided by the world size in the wire dtype
  (`pmean`) and copied back into each `.grad` in its own dtype. Under the
  `grad_allreduce_dtype="bfloat16"` policy float gradients travel in bf16
  (half the bytes, no error feedback); the update still runs in f32.
- `bucketed`: the gradients are packed into buckets of about
  `grad_sync_bucket_mb` MiB of wire bytes, and each bucket's all-reduce is
  launched from the backward itself, by a `register_post_accumulate_grad_hook`
  on every parameter, as soon as the bucket's last gradient is final: the
  overlap with the backward that the JAX package's `chained_psum` can only
  hint to XLA. The same adds on the same values: equal to `fused`.
- `quantized`: the same buckets, each sent as int8 with one shared scale per
  leaf on an int32 carrier, or as bf16 (`grad_sync_quant_dtype`), through
  `collectives.quantized_mean`. A per-process error-feedback accumulator
  (`TrainState.gradsync`) is added to the gradient before quantizing and
  replaced by the new quantization error after.
- `demo`: DeMo's decoupled momentum. Each process keeps a local momentum
  `m = beta * acc + g`; every `grad_sync_cadence` steps it sends the top
  `grad_sync_topk` fraction of each leaf's `m` by magnitude, as (value,
  int32 index) pairs of all leaves in one buffer, through one all-gather;
  the merge (`index_add_` into zeros, `/ n`) is the gradient the optimizer
  sees, and the sent entries leave the local momentum. Off-steps hand the
  optimizer zero gradients, so SGD's momentum and weight decay still move
  the parameters, as in the JAX step.

Under the fsdp_tp layout (`parallel/mesh.py::Layout`, both sizes above 1)
`quantized` is the two-hop reduce of the JAX package's
`GradSync.for_mesh`: each bucket is summed exactly in f32 over the fsdp
group, then sent compressed over the data group
(`collectives.multihop_quantized_mean`); `describe()` then carries the
`multihop` block and `sync_bytes_per_step` counts both hops. The other
modes reduce over the whole group, in the same order as without a layout.

Buckets follow the reverse of the parameters' registration order, the order
the backward makes their gradients final (DDP's order), not flax's
alphabetical leaf order; they are launched strictly in that order, so every
process issues the same collectives in the same sequence. Membership
changes no number in any mode (scales are per leaf, the int32 sum is exact,
DeMo is per leaf): only `describe()["buckets"]` may differ from the JAX
count. Reduced f32 gradients are views of their flat bucket (no copy back).

Only the parameters that train are synced: a frozen ViT patch embedding
(`requires_grad=False`) has no gradient and fires no hook, where the JAX
step reduces its zero gradients (`describe` counts the bytes the port
sends). Every parameter with a gradient is a float leaf: the JAX package's exact
sums of integer leaves have no PyTorch counterpart. Not
`DistributedDataParallel`: its `broadcast_buffers` copies rank 0's BatchNorm
statistics, where the reference takes their mean (the step does that with
`mean_tensors_`), and the modes above need to own the reduce. Gloo has no
`ReduceOp.AVG`, so every mean here is a sum, then a division.
"""

from __future__ import annotations

import functools
import math
import weakref

import torch
import torch.distributed as dist

from moco_tpu_torch.parallel.collectives import all_reduce_buckets, \
    multihop_quantized_mean, quantized_mean
from moco_tpu_torch.parallel.mesh import world_size

GRAD_SYNC_MODES = ("fused", "bucketed", "quantized", "demo")


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


class _LeafPlan:
    __slots__ = ("index", "name", "param", "shape", "size", "dtype", "k")

    def __init__(self, index: int, name: str, param: torch.Tensor, topk: float):
        self.index, self.name, self.param = index, name, param
        self.shape = tuple(param.shape)
        self.size = param.numel()
        self.dtype = param.dtype
        self.k = max(1, math.ceil(self.size * topk))  # DeMo's entries a sync


class _Bucket:
    __slots__ = ("plans", "wire", "ready", "pending")

    def __init__(self, plans: list[_LeafPlan], wire):
        self.plans, self.wire = plans, wire
        self.ready = 0
        self.pending = None


class GradSync:
    """One gradient-sync strategy over `group` (None: one process, for
    `attach` and `describe`), told the fsdp_tp `layout` of that group where
    there is one. The step calls `start(state)` before the backward and
    `finish(state)` after it; then every gradient of the query encoder is
    the synced one."""

    def __init__(self, config, group, layout=None):
        self.mode = config.grad_sync
        if self.mode not in GRAD_SYNC_MODES:
            raise ValueError(f"unknown grad_sync {self.mode!r}; choose from {GRAD_SYNC_MODES}")
        self.group = group
        self.n = world_size(group)
        self.layout = layout
        # the two-hop reduce: quantized with both axes of the layout above 1
        self.multihop = (self.mode == "quantized" and layout is not None
                         and layout.data > 1 and layout.fsdp > 1)
        self.allreduce_dtype = config.grad_allreduce_dtype
        leaf_wire_dtype(torch.float32, self.allreduce_dtype)  # checked at build
        self.bucket_bytes = int(float(config.grad_sync_bucket_mb) * 2**20)
        self.quant_dtype = config.grad_sync_quant_dtype
        self.cadence = int(config.grad_sync_cadence)
        self.topk = float(config.grad_sync_topk)
        self.demo_beta = float(config.grad_sync_demo_beta)
        self.last_bytes = 0  # bytes this process put on the wire in the last finish
        self._plans: list[_LeafPlan] | None = None
        self._model = None
        self._buckets: list[_Bucket] = []
        self._hooks: list = []
        self._armed = False
        self._next = 0
        self._acc = None

    # -- planning (shapes only) -------------------------------------------
    @property
    def needs_state(self) -> bool:
        return self.mode in ("quantized", "demo")

    def plan(self, named_params) -> None:
        """Record each parameter's name, shape and dtype (and DeMo's top-k
        size), in registration order."""
        self._plans = [_LeafPlan(i, name, p, self.topk)
                       for i, (name, p) in enumerate(named_params)]

    def _bucket_plan(self) -> list[list[_LeafPlan]]:
        """Buckets of about `bucket_bytes` of WIRE bytes, one wire dtype
        each, over the leaves in reverse registration order: a quantized
        int8 bucket holds 4x the elements of an f32 one."""
        buckets: list[list[_LeafPlan]] = []
        cur: list[_LeafPlan] = []
        cur_bytes, cur_key = 0, None
        for p in reversed(self._plans):
            if self.mode == "quantized":
                key = self.quant_dtype
                nbytes = p.size * (1 if self.quant_dtype == "int8" else 2)
            else:
                key = (leaf_wire_dtype(p.dtype, self.allreduce_dtype)
                       if self.mode == "bucketed" else p.dtype)
                nbytes = p.size * key.itemsize
            if cur and (key != cur_key or cur_bytes + nbytes > self.bucket_bytes):
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(p)
            cur_bytes += nbytes
            cur_key = key
        if cur:
            buckets.append(cur)
        return buckets

    def describe(self, named_params) -> dict:
        """Static facts: mode, knobs, the JAX package's analytic bytes each
        process contributes to the wire a step (`sync_bytes_per_step`,
        averaged over DeMo's cadence), and the bytes the port's collectives
        carry (`carried_bytes_per_step`: int8 rides an int32 carrier, 4x
        its counted payload); over the parameters that train."""
        self.plan([(n, p) for n, p in named_params if p.requires_grad])
        info = {"mode": self.mode, "sync_bytes_per_step": self.sync_bytes_per_step(),
                "carried_bytes_per_step": self.carried_bytes_per_step()}
        if self.mode in ("bucketed", "quantized"):
            info["bucket_mb"] = round(self.bucket_bytes / 2**20, 3)
            info["buckets"] = len(self._bucket_plan())
        if self.mode == "quantized":
            info["quant_dtype"] = self.quant_dtype
        if self.multihop:
            # the exact hop rides the fsdp (inner) group, the compressed hop
            # the data (outer) one
            info["multihop"] = {
                "intra_axis": "fsdp", "intra_size": self.layout.fsdp,
                "inter_axis": "data", "inter_size": self.layout.data,
                "intra_bytes_per_step": self._hop_bytes("intra"),
                "inter_bytes_per_step": self._hop_bytes("inter"),
            }
        if self.mode == "demo":
            info["cadence"] = self.cadence
            info["topk"] = self.topk
        return info

    def _hop_bytes(self, hop: str) -> int:
        """One process's wire bytes of one hop of the two-hop reduce:
        `intra`, the exact f32 sum; `inter`, the compressed payload and the
        int8 scales."""
        size = sum(p.size for p in self._plans)
        if hop == "intra":
            return 4 * size
        inter = size * (1 if self.quant_dtype == "int8" else 2)
        return inter + (4 * len(self._plans) if self.quant_dtype == "int8" else 0)

    def sync_bytes_per_step(self) -> int:
        """The JAX package's analytic wire payload of one process a step:
        one f32 scale per leaf for int8, `k * 8 / cadence` per leaf for
        DeMo."""
        total = 0
        for p in self._plans:
            if self.mode == "quantized":
                total += p.size * (1 if self.quant_dtype == "int8" else 2)
            elif self.mode == "demo":
                total += int(p.k * 8 / self.cadence)
            else:
                total += p.size * leaf_wire_dtype(p.dtype, self.allreduce_dtype).itemsize
        if self.mode == "quantized" and self.quant_dtype == "int8":
            total += 4 * len(self._plans)
        if self.multihop:
            total += self._hop_bytes("intra")  # the exact hop is wire traffic too
        return total

    def carried_bytes_per_step(self) -> float:
        """What this process hands its collectives a step: the int8
        payload on its int32 carrier (plus the f32 absmaxes of the MAX, and
        the exact f32 hop of the two-hop reduce), the DeMo buffer averaged
        over the cadence; else the analytic bytes."""
        intra = self._hop_bytes("intra") if self.multihop else 0
        if self.mode == "quantized" and self.quant_dtype == "int8":
            return 4 * sum(p.size for p in self._plans) + 4 * len(self._plans) + intra
        if self.mode == "demo":
            return 8 * sum(p.k for p in self._plans) / self.cadence
        return self.sync_bytes_per_step()

    # -- state (error feedback / local momentum) --------------------------
    def attach(self, state) -> None:
        """Give `state` fresh zero accumulators, one f32 tensor per query
        parameter that trains (empty for the stateless modes), and record
        the mode they belong to."""
        state.gradsync = ({name: torch.zeros_like(p, dtype=torch.float32)
                           for name, p in state.model_q.named_parameters() if p.requires_grad}
                          if self.needs_state else {})
        state.gradsync_mode = self.mode

    def _accumulators(self, state) -> dict:
        if not self.needs_state:
            return {}
        acc = state.gradsync
        if getattr(state, "gradsync_mode", None) != self.mode or acc.keys() != {
                p.name for p in self._plans}:
            raise ValueError(f"grad_sync mode {self.mode!r} needs per-process accumulator "
                             "state: call GradSync.attach(state) after creating the "
                             "TrainState (the train driver does this)")
        return acc

    # -- the step's side ---------------------------------------------------
    def _bind(self, model) -> None:
        """Plan `model`'s parameters and, for the bucketed and quantized
        modes, hook each one; once per model."""
        if self._model is model:
            return
        for h in self._hooks:
            h.remove()
        self._hooks = []
        self.plan([(n, p) for n, p in model.named_parameters() if p.requires_grad])
        self._model = model
        if self.mode not in ("bucketed", "quantized"):
            return
        self._buckets = []
        # the hooks hold this object weakly: a model outliving its step
        # keeps no GradSync (and its accumulators) alive through them
        ref = weakref.ref(self)
        for plans in self._bucket_plan():
            wire = (None if self.mode == "quantized"
                    else leaf_wire_dtype(plans[0].dtype, self.allreduce_dtype))
            self._buckets.append(_Bucket(plans, wire))
            for p in plans:
                self._hooks.append(p.param.register_post_accumulate_grad_hook(
                    functools.partial(_hook, ref, len(self._buckets) - 1)))

    def start(self, state) -> None:
        """Before the backward: arm the hooks of the bucketed and quantized
        modes, which launch each bucket's reduce as its gradients become
        final."""
        self._bind(state.model_q)
        if self.mode in ("bucketed", "quantized"):
            self._acc = self._accumulators(state)
            for b in self._buckets:
                b.ready, b.pending = 0, None
            self._next = 0
            self.last_bytes = 0
            self._armed = True

    def _ready(self, bucket: int, _param) -> None:
        if not self._armed:
            return  # a backward outside the step launches nothing
        self._buckets[bucket].ready += 1
        # in bucket order only, so every process issues the same sequence
        while (self._next < len(self._buckets)
               and self._buckets[self._next].ready == len(self._buckets[self._next].plans)):
            self._launch(self._buckets[self._next])
            self._next += 1

    def _launch(self, b: _Bucket) -> None:
        grads = [p.param.grad for p in b.plans]
        if self.mode == "bucketed":
            flat = torch.cat([g.reshape(-1).to(b.wire) for g in grads])
            b.pending = (flat, all_reduce_buckets([flat], self.group)[0])
            self.last_bytes += flat.numel() * flat.element_size()
            return
        segs = [g.reshape(-1).float() + self._acc[p.name].reshape(-1)
                for p, g in zip(b.plans, grads)]
        size = sum(p.size for p in b.plans)
        if self.multihop:
            b.pending = multihop_quantized_mean(segs, self.layout.data_group,
                                                self.layout.fsdp_group, self.quant_dtype,
                                                async_op=True)
            self.last_bytes += 4 * size
        else:
            b.pending = quantized_mean(segs, self.group, self.quant_dtype, async_op=True)
        self.last_bytes += (4 * size + 4 * len(segs) if self.quant_dtype == "int8"
                            else 2 * size)

    def finish(self, state) -> None:
        """After the backward: wait for every reduce and leave each query
        parameter's `.grad` the synced gradient (and the accumulators their
        new values)."""
        self._bind(state.model_q)
        if self.mode == "fused":
            grads = [p.param.grad for p in self._plans if p.param.grad is not None]
            self.last_bytes = mean_tensors_(
                grads, self.group, lambda dt: leaf_wire_dtype(dt, self.allreduce_dtype))
        elif self.mode == "demo":
            self._finish_demo(state)
        else:
            self._finish_buckets()

    def _finish_buckets(self) -> None:
        self._armed = False
        missing = [p.name for b in self._buckets[self._next:] for p in b.plans
                   if p.param.grad is None]
        if missing:
            raise RuntimeError(f"grad_sync={self.mode!r}: no gradient reached {missing[:5]}: "
                               "every query parameter must take part in the loss")
        if self._next < len(self._buckets):
            raise RuntimeError(f"grad_sync={self.mode!r}: {len(self._buckets) - self._next} "
                               "buckets were never launched: call start() before the backward")
        for b in self._buckets:
            if self.mode == "bucketed":
                flat, work = b.pending
                if work is not None:
                    work.wait()
                flat.div_(self.n)
                for p, v in zip(b.plans, flat.split([p.size for p in b.plans])):
                    _set_grad(p, v)
            else:
                means, errs = b.pending.wait()
                for p, mean, err in zip(b.plans, means, errs):
                    _set_grad(p, mean)
                    self._acc[p.name] = err.view(p.shape)
            b.pending = None

    def _finish_demo(self, state) -> None:
        acc = self._accumulators(state)
        plans = self._plans
        ms = [self.demo_beta * acc[p.name].reshape(-1) + p.param.grad.reshape(-1).float()
              for p in plans]
        sizes = [p.size for p in plans]
        delta = ms[0].new_zeros(sum(sizes))
        self.last_bytes = 0
        if self.cadence <= 1 or state.step % self.cadence == 0:
            vals, idxs = [], []
            for p, m in zip(plans, ms):
                _, i = torch.topk(m.abs(), p.k)
                v = m[i]
                vals.append(v)
                idxs.append(i.to(torch.int32))
                m.index_add_(0, i, -v)  # the sent part leaves the local momentum
            kk = sum(p.k for p in plans)
            buf = torch.cat(vals + [i.view(torch.float32) for i in idxs])
            if self.group is None:
                out = buf
            else:
                out = buf.new_empty(self.n * buf.numel())
                dist.all_gather_into_tensor(out, buf, group=self.group)
            self.last_bytes = buf.numel() * buf.element_size()
            starts = torch.tensor([0] + sizes[:-1], device=buf.device).cumsum(0)
            offsets = starts.repeat_interleave(
                torch.tensor([p.k for p in plans], device=buf.device))
            # rank by rank, in rank order: within one rank every index is
            # unique, so the merge is the same on every process and device
            for part in out.view(self.n, -1):
                delta.index_add_(0, part[kk:].view(torch.int32).long() + offsets, part[:kk])
            delta.div_(self.n)
        for p, m, d in zip(plans, ms, delta.split(sizes)):
            acc[p.name] = m.view(p.shape)
            _set_grad(p, d)


def _hook(ref, bucket: int, param) -> None:
    gradsync = ref()
    if gradsync is not None:
        gradsync._ready(bucket, param)


def _set_grad(plan: _LeafPlan, flat: torch.Tensor) -> None:
    """`flat` as the parameter's gradient: a view when the dtypes agree,
    else a copy in the parameter's dtype."""
    param = plan.param
    if flat.dtype == param.dtype:
        param.grad = flat.view(plan.shape)
    else:
        param.grad = flat.view(plan.shape).to(param.dtype)
