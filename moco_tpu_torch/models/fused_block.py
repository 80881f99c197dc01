"""Fused bn->relu->conv passes of the ResNet blocks (port of
`moco_tpu/models/fused_block.py`).

A Bottleneck's interior normalize passes (bn1->relu->conv2, bn2->relu->conv3)
and a BasicBlock's bn1->relu->conv2 run as one `torch.autograd.Function`
each, so the normalized activation z = relu(x*a + b) is never written to
device memory by the forward:

    forward:  batch statistics by `ops.stats.channel_sums` (mean-of-squares
              form, as `FastBatchNorm`), a = gamma*rstd, b = beta - mean*a,
              then the fused kernel: `bn_relu_matmul` (1x1), `bn_relu_conv3x3`
              (3x3, stride 1) or `bn_relu_conv3x3_s2` (3x3, stride 2).
    backward: the filter gradient by the fused dW kernel with z recomputed
              (`bn_relu_matmul_dw`, `conv3x3_dw`), the input gradient of the
              conv as a plain product (dy @ W^T; cuDNN's data gradient for
              the 3x3), masked by the ReLU, then BatchNorm's closed form
              (`_bn_chain`) on `ops.stats.channel_grad_sums`. The stride-2
              backward recomputes z once and takes both conv gradients from
              cuDNN, as the JAX package leaves them to XLA.

The functions take the block's own `bn*` / `conv*` submodules, so parameter
names, `state_dict` keys and `weights.params_from_jax` are those of the
unfused block. Running statistics update as `FastBatchNorm`'s do; in eval
mode the block runs the unfused modules on the running statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from moco_tpu_torch.models.fast_bn import rows_view
from moco_tpu_torch.ops.fused_conv import bn_relu_matmul, bn_relu_matmul_dw
from moco_tpu_torch.ops.fused_conv3x3 import bn_relu_conv3x3, bn_relu_conv3x3_s2, conv3x3_dw
from moco_tpu_torch.ops.stats import channel_grad_sums, channel_sums


def _pc(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _batch_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 (mean, biased var) of a channels_last activation per channel."""
    rows = rows_view(x)
    n = rows.shape[0]
    s, sq = channel_sums(rows)
    mean = s / n
    return mean, sq / n - mean * mean


def _affine(mean, var, scale, bias, eps):
    """(rstd, a, b) with relu(x*a + b) the normalize + ReLU."""
    rstd = torch.rsqrt(var + eps)
    a = scale * rstd
    return rstd, a, bias - mean * a


def _zpre(x, a, b) -> torch.Tensor:
    return x.float() * _pc(a) + _pc(b)


def _bn_chain(g, x, mean, rstd, scale):
    """BatchNorm's closed-form backward shared by the fused convs: from the
    ReLU-masked f32 gradient `g` at the normalize output (channels_last,
    overwritten), return (dx, dgamma, dbeta) with
    dx = gamma*rstd*(g - (xhat*sum(g*xhat) + sum(g)) / N)."""
    n = x.numel() // x.shape[1]
    t = x.to(torch.float32, copy=True)  # f32 rows for the reduction, then xhat's buffer
    dsum, dxh = channel_grad_sums(rows_view(g), rows_view(t), mean, rstd)
    t.sub_(_pc(mean)).mul_(_pc(rstd)).mul_(_pc(dxh / n)).add_(_pc(dsum / n))
    g.sub_(t).mul_(_pc(scale * rstd))
    return g.to(x.dtype), dxh, dsum


def _f32_channels_last(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32, memory_format=torch.channels_last)


def _forward(ctx, conv, x, scale, bias, weight, eps, dtype):
    """The shared forward: batch statistics, the affine, then
    `conv(x, a, b, weight, dtype)`; (y, mean, var) with mean and var
    non-differentiable."""
    x = x.contiguous(memory_format=torch.channels_last)
    mean, var = _batch_stats(x)
    _rstd, a, b = _affine(mean, var, scale, bias, eps)
    y = conv(x, a, b, weight, dtype)
    ctx.save_for_backward(x, mean, var, scale, bias, weight)
    ctx.eps, ctx.compute_dtype = eps, dtype
    ctx.mark_non_differentiable(mean, var)
    return y, mean, var


def _conv1x1(x, a, b, weight, dtype):
    bsz, k, h, wd = x.shape
    w = weight.to(dtype).view(-1, k).t().contiguous()              # [K, N]
    y = bn_relu_matmul(rows_view(x), a, b, w, out_dtype=dtype)
    return _nchw(y.view(bsz, h, wd, -1))


def _conv3x3(x, a, b, weight, dtype):
    w = weight.to(dtype).permute(2, 3, 1, 0).contiguous()          # [3, 3, K, N]
    return _nchw(bn_relu_conv3x3(_nhwc(x), a, b, w, out_dtype=dtype))


def _conv3x3_s2(x, a, b, weight, dtype):
    w = weight.to(dtype).permute(2, 3, 1, 0).contiguous()
    return _nchw(bn_relu_conv3x3_s2(_nhwc(x), a, b, w, out_dtype=dtype))


class _BnReluConvTrain(torch.autograd.Function):
    """bn -> relu -> 1x1 conv (`_bn_relu_conv_train`)."""

    @staticmethod
    def forward(ctx, x, scale, bias, weight, eps, dtype):
        return _forward(ctx, _conv1x1, x, scale, bias, weight, eps, dtype)

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, var, scale, bias, weight = ctx.saved_tensors
        dy = dy.contiguous(memory_format=torch.channels_last)
        rstd, a, b = _affine(mean, var, scale, bias, ctx.eps)
        xr, dyr = rows_view(x), rows_view(dy)
        dw = bn_relu_matmul_dw(xr, a, b, dyr)                       # [K, N] f32
        w = weight.to(ctx.compute_dtype).view(weight.shape[0], -1)  # [N, K]
        g = torch.matmul(dyr.float(), w.float())                    # dy @ W^T, f32
        g.mul_(xr.float() * a + b > 0)
        g = _nchw(g.view(*_nhwc(x).shape))
        dx, dscale, dbias = _bn_chain(g, x, mean, rstd, scale)
        return dx, dscale, dbias, dw.t().reshape(weight.shape), None, None


class _BnReluConv3x3Train(torch.autograd.Function):
    """bn -> relu -> 3x3 conv, stride 1 (`_bn_relu_conv3x3_train`)."""

    @staticmethod
    def forward(ctx, x, scale, bias, weight, eps, dtype):
        return _forward(ctx, _conv3x3, x, scale, bias, weight, eps, dtype)

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, var, scale, bias, weight = ctx.saved_tensors
        dy = dy.contiguous(memory_format=torch.channels_last)
        rstd, a, b = _affine(mean, var, scale, bias, ctx.eps)
        # the data gradient never reads z: a transposed conv of dy
        w = weight.to(ctx.compute_dtype)
        dz = torch.nn.grad.conv2d_input(x.shape, w, dy, padding=1)
        dw = conv3x3_dw(_nhwc(x), a, b, _nhwc(dy))                  # [3, 3, K, N] f32
        g = _f32_channels_last(dz)
        g.mul_(_zpre(x, a, b) > 0)
        dx, dscale, dbias = _bn_chain(g, x, mean, rstd, scale)
        return dx, dscale, dbias, dw.permute(3, 2, 0, 1).contiguous(), None, None


class _BnReluConv3x3S2Train(torch.autograd.Function):
    """bn -> relu -> 3x3 conv, stride 2 (`_bn_relu_conv3x3s2_train`)."""

    @staticmethod
    def forward(ctx, x, scale, bias, weight, eps, dtype):
        return _forward(ctx, _conv3x3_s2, x, scale, bias, weight, eps, dtype)

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, var, scale, bias, weight = ctx.saved_tensors
        dy = dy.contiguous(memory_format=torch.channels_last)
        rstd, a, b = _affine(mean, var, scale, bias, ctx.eps)
        # z recomputed once for both conv gradients (the forward never wrote it)
        zpre = _zpre(x, a, b)
        z = torch.relu(zpre).to(ctx.compute_dtype)
        w = weight.to(ctx.compute_dtype)
        dz, dw, _ = torch.ops.aten.convolution_backward(
            dy, z, w, None, [2, 2], [1, 1], [1, 1], False, [0, 0], 1, [True, True, False])
        g = _f32_channels_last(dz)
        g.mul_(zpre > 0)
        dx, dscale, dbias = _bn_chain(g, x, mean, rstd, scale)
        return dx, dscale, dbias, dw.float(), None, None


def _fused(fn, bn, conv, x):
    """Train mode: `fn` with the running-statistics update; eval mode: the
    unfused modules on the running statistics."""
    if not bn.training:
        return conv(F.relu(bn(x)))
    y, mean, var = fn.apply(x.to(conv.dtype), bn.weight, bn.bias, conv.weight, bn.eps,
                            conv.dtype)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(m).add_(mean * (1 - m))
        bn.running_var.mul_(m).add_(var * (1 - m))
    return y


def fused_bn_relu_conv2(block, x):
    """bn1 -> relu -> conv2 (3x3, stride 1): Bottleneck mids and BasicBlock
    tails."""
    return _fused(_BnReluConv3x3Train, block.bn1, block.conv2, x)


def fused_bn_relu_conv2_s2(block, x):
    """bn1 -> relu -> conv2 (3x3, stride 2): the stage-first Bottlenecks."""
    return _fused(_BnReluConv3x3S2Train, block.bn1, block.conv2, x)


def fused_bn_relu_conv3(block, x):
    """bn2 -> relu -> conv3 (1x1): every Bottleneck's tail."""
    return _fused(_BnReluConvTrain, block.bn2, block.conv3, x)
