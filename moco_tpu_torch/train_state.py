"""The MoCo training state (port of `moco_tpu/train_state.py` and of the v3
state of `moco_tpu/v3_step.py`).

One object holds what the step updates: the query encoder and its
optimizer (SGD; AdamW or LARS for v3), the key encoder (an EMA of the
query's parameters, never trained by gradients), the negative queue and its
pointer (v1/v2; v3 has no queue, and its key encoder is a copy of the
query's backbone and projector without the predictor), the step count, the
generators of ShuffleBN's permutations and of the two-crop draws, and the
gradient sync's per-process accumulators. The step mutates it in place.
Every process of a data-parallel run builds the same state from the same
seed, so the replicas, and the draws of both generators, start and stay
equal; only the accumulators (the quantized mode's error feedback, DeMo's
local momentum) and, under ZeRO-1, the optimizer-state slices differ between
processes.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import torch
from torch import nn

from moco_tpu_torch.ops.optim import LARS, AdamW
from moco_tpu_torch.ops.queue import init_queue
from moco_tpu_torch.parallel.fsdp import FSDPAdamW, FSDPLARS, FSDPSGD
from moco_tpu_torch.parallel.zero import ShardedAdamW, ShardedLARS, ShardedSGD


@dataclass
class TrainState:
    step: int                       # completed steps
    model_q: nn.Module              # query encoder (trained)
    model_k: nn.Module              # key encoder (EMA of model_q's parameters)
    optimizer: torch.optim.Optimizer  # over model_q's trainable parameters only
    queue: torch.Tensor | None      # [K, dim] f32 negative keys, unit rows (v3: None)
    queue_ptr: int                  # ring pointer into the queue
    generator: torch.Generator      # ShuffleBN permutations, on the device
    data_generator: torch.Generator | None = None  # train()'s two-crop draws
    # parallel/gradsync.py: {parameter name: f32 accumulator} of this process
    # (quantized, demo; empty otherwise) and the mode they belong to
    gradsync: dict = field(default_factory=dict)
    gradsync_mode: str = "fused"
    # parallel/fsdp.py: the ShardingPlan whose shards this process holds
    # (None: every parameter whole)
    fsdp: object | None = None


def build_optimizer(config, model_q: nn.Module, group=None,
                    plan=None) -> torch.optim.Optimizer:
    """The optimizer of `config.optimizer` over the query encoder's
    trainable parameters (a frozen patch embedding stays out: the JAX
    package's `optax.masked`); the lr is set each step from the schedule.

    - `sgd`: momentum and weight decay on every parameter (BN included):
      `d = g + wd*p; buf = m*buf + d; p -= lr*buf`, the JAX package's
      `add_decayed_weights` -> `sgd(momentum)` chain.
    - `adamw`: `ops/optim.py::AdamW` (betas 0.9/0.999, eps 1e-8),
      `optax.adamw`'s update with its decay on every parameter.
    - `lars`: `ops/optim.py::LARS`, `optax.lars` with both masks
      `ndim > 1`.

    With `zero_sharding` and a process group, each is the same update with
    its state split over the group (`parallel/zero.py`); a restore into it
    keeps this process's slices. With an fsdp `plan` (`parallel/fsdp.py`)
    each updates the plan's shards."""
    params = [p for p in model_q.parameters() if p.requires_grad]
    sharded = config.zero_sharding and group is not None
    if config.optimizer == "adamw":
        kw = dict(lr=config.effective_lr, betas=(0.9, 0.999), eps=1e-8,
                  weight_decay=config.weight_decay)
        if plan is not None:
            return FSDPAdamW(params, plan, **kw)
        return ShardedAdamW(params, group, **kw) if sharded else AdamW(params, **kw)
    if config.optimizer == "lars":
        kw = dict(lr=config.effective_lr, weight_decay=config.weight_decay,
                  momentum=config.sgd_momentum)
        if plan is not None:
            return FSDPLARS(params, plan, **kw)
        return ShardedLARS(params, group, **kw) if sharded else LARS(params, **kw)
    kw = dict(lr=config.effective_lr, momentum=config.sgd_momentum,
              weight_decay=config.weight_decay)
    if plan is not None:
        return FSDPSGD(params, plan, **kw)
    return ShardedSGD(params, group, **kw) if sharded else torch.optim.SGD(params, **kw)


def create_train_state(config, model: nn.Module, device, seed: int = 0,
                       group=None) -> TrainState:
    """Move `model` (the query encoder) to `device`, copy it into the key
    encoder, and draw the queue from a CPU generator seeded with `seed`, so
    the state is the same on every device. v3: the key encoder is the copy
    without the predictor, and there is no queue. `group` is the
    data-parallel process group ZeRO-1 splits the optimizer state over."""
    device = torch.device(device)
    model_q = model.to(device).train()
    model_k = copy.deepcopy(model_q)
    queue = None
    if config.variant == "v3":
        model_k.predictor = None
    else:
        queue_gen = torch.Generator().manual_seed(seed)
        queue = init_queue(config.num_negatives, config.embed_dim, queue_gen).to(device)
    for p in model_k.parameters():
        p.requires_grad_(False)
    shuffle_gen = torch.Generator(device=device).manual_seed(seed + 2)
    data_gen = torch.Generator(device=device).manual_seed(seed + 1)
    return TrainState(step=0, model_q=model_q, model_k=model_k,
                      optimizer=build_optimizer(config, model_q, group), queue=queue,
                      queue_ptr=0, generator=shuffle_gen, data_generator=data_gen)
