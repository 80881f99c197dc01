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
"""

from __future__ import annotations

import torch
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


class _BNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        rows = rows_view(x)
        n = rows.shape[0]
        s, sq = channel_sums(rows)
        mean = s / n
        var = sq / n - mean * mean
        y = _normalize(x, mean, var, scale, bias, eps)
        ctx.save_for_backward(x, mean, var, scale)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, var, scale = ctx.saved_tensors
        # autograd hands over whatever layout the next op produced
        dy = dy.contiguous(memory_format=torch.channels_last)
        n = x.numel() // x.shape[1]
        rstd = torch.rsqrt(var + ctx.eps)
        dsum, dxh = channel_grad_sums(rows_view(dy), rows_view(x), mean, rstd)
        # t = xhat * (sum(dy*xhat) / N) + sum(dy) / N, built on xhat's buffer
        t = x.to(torch.float32, copy=True)
        t.sub_(_per_channel(mean)).mul_(_per_channel(rstd))
        t.mul_(_per_channel(dxh / n)).add_(_per_channel(dsum / n))
        dx = dy.to(torch.float32, copy=True)
        dx.sub_(t).mul_(_per_channel(scale * rstd))
        return dx.to(x.dtype), dxh.to(scale.dtype), dsum.to(scale.dtype), None


class FastBatchNorm(nn.Module):
    """BatchNorm2d over a channels_last activation with flax semantics:
    `weight`/`bias` (flax `scale`/`bias`), `running_mean`/`running_var`
    buffers (flax `batch_stats` `mean`/`var`), `momentum` is the weight of
    the OLD running value."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return _normalize(x, self.running_mean, self.running_var,
                              self.weight, self.bias, self.eps)
        y, mean, var = _BNTrain.apply(x, self.weight, self.bias, self.eps)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean * (1 - m))
            self.running_var.mul_(m).add_(var * (1 - m))
        return y
