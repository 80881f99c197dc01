"""The MoCo training state (port of `moco_tpu/train_state.py`).

One object holds what the step updates: the query encoder and its SGD
optimizer, the key encoder (an EMA of the query's parameters, never trained
by gradients), the negative queue and its pointer, the step count, the
generators of ShuffleBN's permutations and of the two-crop draws, and the
gradient sync's per-process accumulators. The step mutates it in place.
Every process of a data-parallel run builds the same state from the same
seed, so the replicas, and the draws of both generators, start and stay
equal; only the accumulators (the quantized mode's error feedback, DeMo's
local momentum) and, under ZeRO-1, the momentum slices differ between
processes.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import torch
from torch import nn

from moco_tpu_torch.ops.queue import init_queue
from moco_tpu_torch.parallel.zero import ShardedSGD


@dataclass
class TrainState:
    step: int                       # completed steps
    model_q: nn.Module              # query encoder (trained)
    model_k: nn.Module              # key encoder (EMA of model_q's parameters)
    optimizer: torch.optim.Optimizer  # over model_q's parameters only
    queue: torch.Tensor             # [K, dim] f32 negative keys, unit rows
    queue_ptr: int                  # ring pointer into the queue
    generator: torch.Generator      # ShuffleBN permutations, on the device
    data_generator: torch.Generator | None = None  # train()'s two-crop draws
    # parallel/gradsync.py: {parameter name: f32 accumulator} of this process
    # (quantized, demo; empty otherwise) and the mode they belong to
    gradsync: dict = field(default_factory=dict)
    gradsync_mode: str = "fused"


def build_optimizer(config, model_q: nn.Module, group=None) -> torch.optim.SGD:
    """SGD with momentum and weight decay on EVERY parameter (BN included):
    `d = g + wd*p; buf = m*buf + d; p -= lr*buf`, the same update as the
    JAX package's `add_decayed_weights` -> `sgd(momentum)` chain. The lr is
    set each step from the schedule. With `zero_sharding` and a process
    group, the same update with the momentum split over the group
    (`parallel/zero.py`); a restore into it keeps this process's slices."""
    kw = dict(lr=config.effective_lr, momentum=config.sgd_momentum,
              weight_decay=config.weight_decay)
    if config.zero_sharding and group is not None:
        return ShardedSGD(model_q.parameters(), group, **kw)
    return torch.optim.SGD(model_q.parameters(), **kw)


def create_train_state(config, model: nn.Module, device, seed: int = 0,
                       group=None) -> TrainState:
    """Move `model` (the query encoder) to `device`, copy it into the key
    encoder, and draw the queue from a CPU generator seeded with `seed`, so
    the state is the same on every device. `group` is the data-parallel
    process group ZeRO-1 splits the momentum over."""
    device = torch.device(device)
    model_q = model.to(device).train()
    model_k = copy.deepcopy(model_q)
    for p in model_k.parameters():
        p.requires_grad_(False)
    queue_gen = torch.Generator().manual_seed(seed)
    queue = init_queue(config.num_negatives, config.embed_dim, queue_gen).to(device)
    shuffle_gen = torch.Generator(device=device).manual_seed(seed + 2)
    data_gen = torch.Generator(device=device).manual_seed(seed + 1)
    return TrainState(step=0, model_q=model_q, model_k=model_k,
                      optimizer=build_optimizer(config, model_q, group), queue=queue,
                      queue_ptr=0, generator=shuffle_gen, data_generator=data_gen)
