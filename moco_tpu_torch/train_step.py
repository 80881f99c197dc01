"""The MoCo v1/v2 pretrain step (port of `moco_tpu/train_step.py`), on one
card or as one process of a data-parallel group.

One step, in the reference's order:

1. EMA of the key encoder's parameters, BEFORE the key forward;
2. ShuffleBN: shuffle the key batch (across processes: gather the global
   batch and keep this process's slice of one shared permutation, or the
   half-shard ring), key forward with train-mode (batch statistics) BN on
   the local slice, L2-normalize, unshuffle, all under `no_grad`;
3. the local query forward, InfoNCE logits against the local keys and the
   queue, loss;
4. backward; across processes the gradient sync of `config.grad_sync`
   (`parallel/gradsync.py`: the bucketed and quantized modes launch their
   reduces from the backward itself; the step waits on every one before
   the optimizer), the mean of both encoders' BN running statistics and of
   the metrics; then SGD with the lr of the schedule at the pre-increment
   step (under ZeRO-1 each process updates its slices and one all-gather
   makes the parameters whole again, before the enqueue and the next
   step's EMA);
5. enqueue the GLOBAL batch's keys AFTER the logits (a batch is never its
   own negatives), so the queue stays the same on every process.

With no process group the step is the one-card step, and a one-process
group computes the same bits. `variant="v3"` builds the queue-free v3 step
of `v3_step.py` instead.
"""

from __future__ import annotations

import math
import time
from typing import Callable

import torch

from moco_tpu_torch.models.resnet import build_resnet
from moco_tpu_torch.models.vit import build_vit
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
from moco_tpu_torch.parallel.collectives import all_gather_batch, batch_shuffle, \
    batch_unshuffle, local_rows, ring_shuffle
from moco_tpu_torch.parallel.gradsync import GradSync, mean_tensors_
from moco_tpu_torch.parallel.mesh import world_size
from moco_tpu_torch.telemetry import health
from moco_tpu_torch.train_state import TrainState

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_encoder(config, generator: torch.Generator | None = None, group=None):
    """The encoder of `config`, weights drawn from `generator` (default:
    seeded with `config.seed`): v1/v2, a ResNet (v2: MLP head) or a ViT
    with a Dense head of `embed_dim`; v3, `v3_step.V3Model` (a backbone of
    pooled ResNet or class-token ViT features, the projector and the
    predictor). With `config.sync_bn` the ResNet's BNs (v3: the backbone's;
    its heads keep per-process BN, as the JAX package's do) take their
    statistics over `group`, the data-parallel process group, and the fused
    tail stays off, as the JAX package ignores it under SyncBN."""
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    dtype = DTYPES[config.compute_dtype]
    bn_group = group if config.sync_bn else None
    fused_bn_conv = config.fused_bn_conv and not config.sync_bn
    vit = config.arch.startswith("vit")
    if config.remat and not vit:
        raise ValueError(f"remat is ported for the ViT only, not for arch {config.arch!r}")
    if config.variant == "v3":
        from moco_tpu_torch.v3_step import V3Model

        if vit:
            backbone = build_vit(config.arch, num_classes=None, dtype=dtype,
                                 remat=config.remat, image_size=config.image_size,
                                 generator=generator)
        else:
            backbone = build_resnet(config.arch, num_classes=None, cifar_stem=config.cifar_stem,
                                    dtype=dtype, generator=generator,
                                    fused_bn_conv=fused_bn_conv, bn_group=bn_group)
        return V3Model(backbone, embed_dim=config.embed_dim, generator=generator)
    if vit:
        return build_vit(config.arch, num_classes=config.embed_dim, dtype=dtype,
                         remat=config.remat, image_size=config.image_size, generator=generator)
    return build_resnet(
        config.arch, num_classes=config.embed_dim, mlp_head=config.mlp_head,
        cifar_stem=config.cifar_stem, dtype=dtype,
        generator=generator, fused_bn_conv=fused_bn_conv, bn_group=bn_group,
    )


def lr_schedule(config, steps_per_epoch: int) -> Callable[[int], float]:
    """step -> lr. v1/v2: evaluated at the integer epoch `floor(step / spe)`
    like the reference's per-epoch `adjust_learning_rate`; v3: at the
    fractional epoch `step / spe`, as moco-v3 adjusts every iteration (a
    floored warmup would run its whole first epoch at lr 0)."""
    lr = config.effective_lr

    def sched(step: int) -> float:
        epoch = step / steps_per_epoch
        if config.variant != "v3":
            epoch = math.floor(epoch)
        if config.warmup_epochs > 0:
            return warmup_cosine_lr(lr, epoch, config.epochs, config.warmup_epochs)
        if config.cos:
            return cosine_lr(lr, epoch, config.epochs)
        return step_lr(lr, epoch, config.schedule)

    return sched


def comm_stamp(device: torch.device):
    """A gradient-sync timestamp on `device`'s compute stream: a recorded
    timing CUDA event, or the host clock on the CPU (gloo blocks the host).
    `telemetry/timing.py::comm_seconds` turns a pair into seconds."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
        return event
    return time.perf_counter()


def build_train_step(config, steps_per_epoch: int, group=None,
                     perm_fn: Callable[[int, int], torch.Tensor] | None = None):
    """Return `step(state, im_q, im_k) -> metrics`, updating `state` in
    place. `im_q`/`im_k` are this process's NHWC `[b, H, W, 3]` batches on
    the state's device; `group` is the data-parallel process group (None:
    one process). `perm_fn(step, global_batch)` replaces ShuffleBN's drawn
    permutation (a test hands in the JAX package's). Metric values stay on
    the device until the caller reads them, except `lr` and `queue_ptr`,
    which are host numbers. `variant="v3"`: the v3 step
    (`v3_step.build_v3_train_step`).

    With `health_stride > 0` the metrics of a stride step (`state.step %
    health_stride == 0`, before the increment) also hold the `h_*`
    diagnostics of `telemetry/health.py`, on the device: the embeddings'
    std and participation ratio and the gradient norms by layer group from
    this process's slice and local gradients (averaged over the group with
    the other metrics), the queue's norms and age, the query-key drift.
    With telemetry on and a process group, `gs_comm_pre` / `gs_comm_post`
    stamp the gradient sync (`comm_stamp`) for the driver's phase timer."""
    if config.variant == "v3":
        from moco_tpu_torch.v3_step import build_v3_train_step

        return build_v3_train_step(config, steps_per_epoch, group)
    sched = lr_schedule(config, steps_per_epoch)
    temperature = config.temperature
    chunks = config.collective_chunks
    gradsync = None if group is None else GradSync(config, group)
    stride = config.health_stride
    time_comm = group is not None and bool(config.telemetry_dir)

    def key_path(state: TrainState, im_k: torch.Tensor):
        """(this process's keys, the global batch's keys in rank order)."""
        if config.shuffle_mode == "ring":
            k = l2_normalize(state.model_k(ring_shuffle(im_k, group)))
            k = ring_shuffle(k, group, inverse=True)
            return k, all_gather_batch(k, group, chunks)
        perm = None if perm_fn is None else perm_fn(state.step,
                                                    im_k.shape[0] * world_size(group))
        im_k_shuf, perm = batch_shuffle(im_k, state.generator, group, chunks, perm)
        k_global = batch_unshuffle(l2_normalize(state.model_k(im_k_shuf)), perm, group,
                                   chunks)
        return local_rows(k_global, group), k_global

    def step(state: TrainState, im_q: torch.Tensor, im_k: torch.Tensor) -> dict:
        lr = sched(state.step)
        on_stride = stride > 0 and state.step % stride == 0
        ema_update(state.model_k, state.model_q, config.momentum_ema)
        with torch.no_grad():
            k, k_global = key_path(state, im_k)
        q = l2_normalize(state.model_q(im_q))
        logits, labels = infonce_logits(q, k, state.queue, temperature)
        loss = softmax_cross_entropy(logits, labels)
        state.optimizer.zero_grad(set_to_none=True)
        if group is not None:
            gradsync.start(state)
        loss.backward()
        with torch.no_grad():
            logits = logits.detach()
            acc1, acc5 = contrastive_accuracy(logits, labels)
            pos_sim = logits[:, 0].mean() * temperature
            neg_sim = neg_sim_mean(logits, labels, temperature)
            metrics = {"loss": loss.detach(), "acc1": acc1, "acc5": acc5,
                       "pos_sim": pos_sim, "neg_sim": neg_sim,
                       "logit_margin": pos_sim - neg_sim}
            if on_stride:  # the local gradients, before the sync replaces them
                metrics.update(health.region_health(
                    q.detach(), k, health.param_grads(state.model_q), state.step, stride))
            if group is not None:
                comm_pre = comm_stamp(loss.device) if time_comm else None
                gradsync.finish(state)
                comm_post = comm_stamp(loss.device) if time_comm else None
                # BN running statistics: their mean over processes keeps the
                # replicas equal (in place of DDP's broadcast of rank 0's)
                mean_tensors_([b for m in (state.model_q, state.model_k)
                               for b in m.buffers()], group)
                values = torch.stack([v.float() for v in metrics.values()])
                mean_tensors_([values], group)
                metrics = dict(zip(metrics, values.unbind()))
        # the replicated state before the update: the queue before the
        # enqueue, the query encoder before the optimizer, the key encoder
        # after the EMA
        if on_stride:
            metrics.update(health.queue_health(state.queue, state.step, config.batch_size,
                                               stride))
            metrics.update(health.param_drift(state.model_q.parameters(),
                                              state.model_k.parameters(), state.step, stride))
        for g in state.optimizer.param_groups:
            g["lr"] = lr
        state.optimizer.step()
        with torch.no_grad():
            state.queue_ptr = dequeue_and_enqueue(state.queue, state.queue_ptr, k_global)
        state.step += 1
        out = {**metrics, "lr": lr, "queue_ptr": state.queue_ptr}
        if time_comm:
            out.update(gs_comm_pre=comm_pre, gs_comm_post=comm_post)
        return out

    return step
