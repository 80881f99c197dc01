"""The MoCo v1/v2 pretrain step on one card (port of
`moco_tpu/train_step.py`).

One step, in the reference's order:

1. EMA of the key encoder's parameters, BEFORE the key forward;
2. ShuffleBN: permute the key batch, key forward with train-mode (batch
   statistics) BN, L2-normalize, unpermute, all under `no_grad`;
3. query forward, InfoNCE logits against the keys and the queue, loss;
4. backward and SGD with the lr of the schedule at the pre-increment step;
5. enqueue the keys AFTER the logits (a batch is never its own negatives).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from moco_tpu_torch.models.resnet import build_resnet
from moco_tpu_torch.ops.ema import ema_update
from moco_tpu_torch.ops.losses import (
    contrastive_accuracy,
    infonce_logits,
    l2_normalize,
    neg_sim_mean,
    softmax_cross_entropy,
)
from moco_tpu_torch.ops.queue import dequeue_and_enqueue
from moco_tpu_torch.ops.schedules import cosine_lr, step_lr, warmup_cosine_lr
from moco_tpu_torch.parallel.collectives import batch_shuffle, batch_unshuffle
from moco_tpu_torch.train_state import TrainState

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_encoder(config, generator: torch.Generator | None = None):
    """The ResNet encoder of `config` (v2: MLP head), weights drawn from
    `generator` (default: seeded with `config.seed`)."""
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    return build_resnet(
        config.arch, num_classes=config.embed_dim, mlp_head=config.mlp_head,
        cifar_stem=config.cifar_stem, dtype=DTYPES[config.compute_dtype],
        generator=generator, fused_bn_conv=config.fused_bn_conv,
    )


def lr_schedule(config, steps_per_epoch: int) -> Callable[[int], float]:
    """step -> lr, evaluated at the integer epoch `floor(step / spe)` like
    the reference's per-epoch `adjust_learning_rate`."""
    lr = config.effective_lr

    def sched(step: int) -> float:
        epoch = math.floor(step / steps_per_epoch)
        if config.warmup_epochs > 0:
            return warmup_cosine_lr(lr, epoch, config.epochs, config.warmup_epochs)
        if config.cos:
            return cosine_lr(lr, epoch, config.epochs)
        return step_lr(lr, epoch, config.schedule)

    return sched


def build_train_step(config, steps_per_epoch: int):
    """Return `step(state, im_q, im_k) -> metrics`, updating `state` in
    place. `im_q`/`im_k` are NHWC `[B, H, W, 3]` batches on the state's
    device. Metric values stay on the device until the caller reads them,
    except `lr` and `queue_ptr`, which are host numbers."""
    sched = lr_schedule(config, steps_per_epoch)
    temperature = config.temperature

    def step(state: TrainState, im_q: torch.Tensor, im_k: torch.Tensor) -> dict:
        lr = sched(state.step)
        ema_update(state.model_k, state.model_q, config.momentum_ema)
        with torch.no_grad():
            im_k_shuf, perm = batch_shuffle(im_k, state.generator)
            k = batch_unshuffle(l2_normalize(state.model_k(im_k_shuf)), perm)
        q = l2_normalize(state.model_q(im_q))
        logits, labels = infonce_logits(q, k, state.queue, temperature)
        loss = softmax_cross_entropy(logits, labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        with torch.no_grad():
            logits = logits.detach()
            acc1, acc5 = contrastive_accuracy(logits, labels)
            pos_sim = logits[:, 0].mean() * temperature
            neg_sim = neg_sim_mean(logits, labels, temperature)
            state.queue_ptr = dequeue_and_enqueue(state.queue, state.queue_ptr, k)
        state.step += 1
        return {"loss": loss.detach(), "acc1": acc1, "acc5": acc5, "pos_sim": pos_sim,
                "neg_sim": neg_sim, "logit_margin": pos_sim - neg_sim, "lr": lr,
                "queue_ptr": state.queue_ptr}

    return step
