"""Train-mode BatchNorm on the port's reduction kernels (port of
`moco_tpu/models/fast_bn.py`).

`FastBatchNorm` keeps flax's conventions, not `torch.nn.BatchNorm2d`'s:
running statistics follow `ra = 0.9 * ra + 0.1 * batch` with the BIASED
batch variance, and the variance is the mean-of-squares form
`E[x^2] - E[x]^2` in f32. Its train-mode forward and backward are one
`torch.autograd.Function`:

    forward:  (sum x, sum x^2) by `ops.stats.channel_sums` (one read of x),
              then y = (x - mean) * (rsqrt(var + eps) * scale) + bias in f32,
              cast to x's dtype.
    backward: (sum dy, sum dy*xhat) by `ops.stats.channel_grad_sums` (one
              read of dy and x, xhat recomputed), then the closed form
              dx = scale * rstd * (dy - (xhat * sum(dy*xhat) + sum dy) / N).

Activations are channels_last NCHW tensors, so `[N*H*W, C]` is a view with
no copy (`rows_view`). Elementwise passes run in place on the one f32 copy
they start from, which halves their peak memory.

Cross-process BN (`PretrainConfig.sync_bn`, the JAX package's
`axis_name=DATA_AXIS`): given a process `group`, the forward all-reduces
(SUM) the kernel's `(sum x, sum x^2)` as one `[2, C]` f32 buffer and divides
by the global row count, and the backward all-reduces `(sum dy, sum
dy*xhat)` the same way before the closed form, so mean, variance and `dx`
are those of the whole global batch. The reductions stay the kernels; only
a collective sits between each kernel and its elementwise pass, a
blocking call (`async_op=False`: the compute stream waits on it), in the
autograd order every rank shares. The JAX package takes `pmean` of each device's mean and mean of
squares; with the equal shards `local_batch_size` enforces that is the same
value up to rounding. A group of one process sums over itself, which is
exact, so its bits are those of no group.

The backward's gradient. In the JAX step (jax 0.9 `shard_map`, gradients
taken inside the region of each device's local loss `L_d`), `pmean` is
`psum(m_d) / n` of a device-varying `m_d`: its transpose hands the
replicated cotangent back to every device divided by `n`, and that
replicated cotangent is itself the `psum` over devices of each device's
local cotangent (the transpose of the implicit broadcast of the invariant
mean into varying code). So each device's `dx` is the gradient of the SUM
of all devices' losses, `d(sum_d L_d)/dx` -- torch `SyncBatchNorm`'s result,
and what the all-reduced closed form above computes. `dscale`/`dbias`
stay each process's local sums: the gradient sync averages them as it
averages every other parameter, so the port's n-process update is the mean
loss's, the JAX step's (which sums its devices' gradients) divided by n.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from moco_tpu_torch.ops.stats import channel_grad_sums, channel_sums


def rows_view(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] channels_last -> its [N*H*W, C] rows, as a view."""
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(
            f"expected a channels_last [N, C, H, W] tensor, got shape "
            f"{tuple(x.shape)} strides {x.stride()}"
        )
    return x.permute(0, 2, 3, 1).view(-1, x.shape[1])


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _normalize(x, mean, var, scale, bias, eps) -> torch.Tensor:
    """`(x - mean) * (rsqrt(var + eps) * scale) + bias` in f32, cast to x's
    dtype (flax's op order, so CPU results follow the JAX package)."""
    a = torch.rsqrt(var + eps) * scale
    y = x.to(torch.float32, copy=True)
    y.sub_(_per_channel(mean)).mul_(_per_channel(a)).add_(_per_channel(bias))
    return y.to(x.dtype)


def _sum_over(group, a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`(a, b)` summed over `group`'s processes, as one `[2, C]` all-reduce."""
    buf = torch.stack([a, b])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf[0], buf[1]


class _BNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, group):
        rows = rows_view(x)
        n = rows.shape[0]
        s, sq = channel_sums(rows)
        if group is not None:
            s, sq = _sum_over(group, s, sq)
            n *= dist.get_world_size(group)  # equal shards: the global row count
        mean = s / n
        var = sq / n - mean * mean
        y = _normalize(x, mean, var, scale, bias, eps)
        ctx.save_for_backward(x, mean, var, scale)
        ctx.eps = eps
        ctx.group = group
        ctx.n = n
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, var, scale = ctx.saved_tensors
        # autograd hands over whatever layout the next op produced
        dy = dy.contiguous(memory_format=torch.channels_last)
        n = ctx.n
        rstd = torch.rsqrt(var + ctx.eps)
        dsum, dxh = channel_grad_sums(rows_view(dy), rows_view(x), mean, rstd)
        # the parameters' gradients stay local; dx takes the global sums
        gsum, gxh = (dsum, dxh) if ctx.group is None else _sum_over(ctx.group, dsum, dxh)
        # t = xhat * (sum(dy*xhat) / N) + sum(dy) / N, built on xhat's buffer
        t = x.to(torch.float32, copy=True)
        t.sub_(_per_channel(mean)).mul_(_per_channel(rstd))
        t.mul_(_per_channel(gxh / n)).add_(_per_channel(gsum / n))
        dx = dy.to(torch.float32, copy=True)
        dx.sub_(t).mul_(_per_channel(scale * rstd))
        return dx.to(x.dtype), dxh.to(scale.dtype), dsum.to(scale.dtype), None, None


class _SharedGroup:
    """A process group held by reference: the deep copy that makes the key
    encoder keeps the same communicator (which cannot be copied)."""

    __slots__ = ("group",)

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self


class FastBatchNorm(nn.Module):
    """BatchNorm2d over a channels_last activation with flax semantics:
    `weight`/`bias` (flax `scale`/`bias`), `running_mean`/`running_var`
    buffers (flax `batch_stats` `mean`/`var`), `momentum` is the weight of
    the OLD running value. `group`: the process group whose global batch the
    train-mode statistics span (None: this process's batch)."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5,
                 group=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self._group = _SharedGroup(group)
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    @property
    def group(self):
        return self._group.group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return _normalize(x, self.running_mean, self.running_var,
                              self.weight, self.bias, self.eps)
        y, mean, var = _BNTrain.apply(x, self.weight, self.bias, self.eps, self.group)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean * (1 - m))
            self.running_var.mul_(m).add_(var * (1 - m))
        return y
