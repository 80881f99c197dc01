"""The MoCo-v3 pretrain step (port of `moco_tpu/v3_step.py`): queue-free,
symmetric, large-batch, on one card or as one process of a data-parallel
group.

Against the v1/v2 step (`train_step.py`):

- no queue and no ShuffleBN: the negatives of a query are the other samples
  of the GLOBAL batch, the keys gathered from every process
  (`all_gather_batch`, `collective_chunks` as there); the positive of local
  row i is global row `rank * b + i`;
- both crops go through both encoders, and the loss is symmetric,
  `ctr(q1, k2) + ctr(q2, k1)`, each scaled by 2T;
- the query model is backbone -> projector -> predictor; the key model is
  the backbone and projector alone, and the EMA covers the query's
  parameters of the same names (the predictor stays out);
- the EMA momentum ramps from `momentum_ema` to 1 on a cosine over
  training when `momentum_ramp` is set;
- a ViT's patch embedding is frozen (`requires_grad=False`): no gradient,
  no optimizer update, and the gradient sync leaves it out (the JAX step
  syncs its zero gradients).

One step, in the JAX step's order:

1. m from the ramp; the EMA of the key model's parameters;
2. under `no_grad`, k1 and k2 through the key model in train mode (its BN
   running statistics chained over the two forwards), L2-normalized, and
   the global batch's keys gathered;
3. q1 and q2 through the query model with the predictor (its statistics
   chained the same way), L2-normalized; the loss;
4. backward; across processes the gradient sync of `config.grad_sync`, the
   mean of both models' BN running statistics and of the metrics; then the
   optimizer with the lr of the schedule at the pre-increment step.

The metrics: `loss`, `acc1` (q1 against the gathered k2, raw cosines),
`pos_sim` (q1 . k2 of the local positives), `neg_sim` (at T = 1),
`logit_margin`, `lr`, `momentum`; on a `health_stride` step also the `h_*`
diagnostics of the v1/v2 step (q1 and the local k2, the local gradients,
the drift over the EMA-covered parameters: the predictor stays out) but no
queue's. With no process group the step is the one-card step, and a
one-process group computes the same bits.

Under `sharding="fsdp"|"fsdp_tp"` (a state placed by
`parallel/fsdp.py::place_state`) the step runs the JAX package's FSDP
branch: the EMA on this process's shards, the full parameters gathered
before the forwards, the gradient sync of the whole group on the full
gradients (the two-hop reduce for quantized fsdp_tp), the health drift
read, the optimizer on the shards with this process's slice of each synced
gradient, and the full parameters released. The dp step is unchanged.
"""

from __future__ import annotations

import torch
from torch import nn

from moco_tpu_torch.models.heads import V3Predictor, V3Projector
from moco_tpu_torch.ops.ema import ema_update, momentum_schedule
from moco_tpu_torch.ops.losses import l2_normalize, neg_sim_mean, v3_contrastive_loss
from moco_tpu_torch.parallel.collectives import all_gather_batch
from moco_tpu_torch.parallel.gradsync import GradSync, mean_tensors_
from moco_tpu_torch.parallel.mesh import rank
from moco_tpu_torch.telemetry import health
from moco_tpu_torch.train_state import TrainState


class V3Model(nn.Module):
    """backbone -> projector (-> predictor with `predict=True`). The key
    model is a copy with `predictor = None`."""

    def __init__(self, backbone: nn.Module, embed_dim: int = 256, hidden_dim: int = 4096,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.backbone = backbone
        self.projector = V3Projector(backbone.feature_dim, hidden_dim, embed_dim, generator)
        self.predictor = V3Predictor(embed_dim, hidden_dim, embed_dim, generator)

    def forward(self, x: torch.Tensor, predict: bool = False) -> torch.Tensor:
        z = self.projector(self.backbone(x))
        if predict:
            z = self.predictor(z)
        return z


def bn_buffers(model: nn.Module) -> list[torch.Tensor]:
    """The BatchNorm running statistics of `model` (not a ViT's position
    embedding, which is a constant)."""
    return [b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))]


def build_v3_train_step(config, steps_per_epoch: int, group=None):
    """Return `step(state, x1, x2) -> metrics`, updating `state` in place.
    `x1`/`x2` are this process's NHWC `[b, H, W, 3]` views on the state's
    device; `group` is the data-parallel process group (None: one
    process). Metric values stay on the device except `lr` and `momentum`,
    which are host numbers."""
    from moco_tpu_torch.train_step import comm_stamp, lr_schedule

    sched = lr_schedule(config, steps_per_epoch)
    total_steps = config.epochs * steps_per_epoch
    temperature = config.temperature
    chunks = config.collective_chunks
    stride = config.health_stride
    time_comm = group is not None and bool(config.telemetry_dir)
    gradsync = None  # made at the first step, for the layout of its state

    def step(state: TrainState, x1: torch.Tensor, x2: torch.Tensor) -> dict:
        nonlocal gradsync
        plan = state.fsdp
        if group is not None and gradsync is None:
            gradsync = GradSync(config, group, None if plan is None else plan.layout)
        lr = sched(state.step)
        on_stride = stride > 0 and state.step % stride == 0
        m = (momentum_schedule(config.momentum_ema, state.step, total_steps)
             if config.momentum_ramp else config.momentum_ema)
        ema_update(state.model_k, state.model_q, m, None if plan is None else plan.local)
        if plan is not None:
            plan.gather()  # on use: the full weights live until the release below
        with torch.no_grad():
            k1 = l2_normalize(state.model_k(x1))
            k2 = l2_normalize(state.model_k(x2))
            k1_all = all_gather_batch(k1, group, chunks)
            k2_all = all_gather_batch(k2, group, chunks)
        q1 = l2_normalize(state.model_q(x1, predict=True))
        q2 = l2_normalize(state.model_q(x2, predict=True))
        offset = rank(group) * q1.shape[0]
        loss = (v3_contrastive_loss(q1, k2_all, temperature, offset)
                + v3_contrastive_loss(q2, k1_all, temperature, offset))
        state.optimizer.zero_grad(set_to_none=True)
        if group is not None:
            gradsync.start(state)
        loss.backward()
        with torch.no_grad():
            # monitoring: in-batch top-1 of the q1 . k2 direction on raw cosines
            logits = q1.detach().float() @ k2_all.float().t()
            labels = torch.arange(q1.shape[0], device=q1.device) + offset
            acc1 = 100.0 * (logits.argmax(dim=-1) == labels).float().mean()
            pos_sim = (q1.detach() * k2).sum(dim=-1).mean()
            neg_sim = neg_sim_mean(logits, labels, 1.0)
            metrics = {"loss": loss.detach(), "acc1": acc1, "pos_sim": pos_sim,
                       "neg_sim": neg_sim, "logit_margin": pos_sim - neg_sim}
            if on_stride:  # the local gradients, before the sync replaces them
                metrics.update(health.region_health(
                    q1.detach(), k2, health.param_grads(state.model_q), state.step, stride))
            if group is not None:
                comm_pre = comm_stamp(loss.device) if time_comm else None
                gradsync.finish(state)
                comm_post = comm_stamp(loss.device) if time_comm else None
                mean_tensors_(bn_buffers(state.model_q) + bn_buffers(state.model_k), group)
                values = torch.stack([v.float() for v in metrics.values()])
                mean_tensors_([values], group)
                metrics = dict(zip(metrics, values.unbind()))
        if on_stride:
            # the key model's parameters and the query's of the same names
            # (no predictor), the query's before the update
            q_params = dict(state.model_q.named_parameters())
            k_named = list(state.model_k.named_parameters())
            metrics.update(health.param_drift([q_params[n] for n, _ in k_named],
                                              [p for _, p in k_named], state.step, stride))
        for g in state.optimizer.param_groups:
            g["lr"] = lr
        state.optimizer.step()
        if plan is not None:
            plan.release()
        state.step += 1
        out = {**metrics, "lr": lr, "momentum": m}
        if time_comm:
            out.update(gs_comm_pre=comm_pre, gs_comm_post=comm_post)
        return out

    return step
