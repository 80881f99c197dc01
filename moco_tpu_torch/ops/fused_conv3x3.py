"""BatchNorm-normalize -> ReLU fused into a 3x3 conv: the CUDA kernels of
`csrc/fused_conv.cu` / `csrc/fused_conv_dw.cu` and their plain PyTorch
versions.

Port of `moco_tpu/ops/pallas_fused_conv3x3.py`, in its layout: x
`[B, H, W, K]` NHWC, w `[3, 3, K, N]`, a = gamma*rstd and b = beta - mean*a
f32 `[K]`. A channels_last NCHW activation `t` is the NHWC tensor
`t.permute(0, 2, 3, 1)` with no copy; the outputs are NHWC, whose
`permute(0, 3, 1, 2)` is channels_last NCHW.

- `bn_relu_conv3x3(x, a, b, w, out_dtype)`    relu(x*a + b) conv w, stride 1, zero pad 1
- `bn_relu_conv3x3_s2(x, a, b, w, out_dtype)` the same at stride 2, symmetric pad 1
                                              (H and W even) -> [B, H/2, W/2, N]
- `conv3x3_dw(x, a, b, dy)`                   dW [3, 3, K, N] f32 of the stride-1 conv

The zero padding applies to z = relu(x*a + b), not to x: a tap outside the
image contributes 0. A CPU tensor takes the plain version (`F.conv2d` on
the materialized z); a CUDA tensor launches the kernel or raises. Each
wrapper counts its kernel launches in `.launches`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from moco_tpu_torch.ops import _build
from moco_tpu_torch.ops.fused_conv import (
    check_affine,
    check_out_dtype,
    check_pair,
    dw_partials,
    dw_slabs,
    normalize_relu,
)
from moco_tpu_torch.ops.stats import DTYPE_CODES, device_kind


def _conv_plain(x, a, b, w, stride: int, out_dtype) -> torch.Tensor:
    z = normalize_relu(x, a, b, w.dtype).float().permute(0, 3, 1, 2)
    y = F.conv2d(z, w.float().permute(3, 2, 0, 1), stride=stride, padding=1)
    return y.permute(0, 2, 3, 1).to(out_dtype)


def bn_relu_conv3x3_plain(x, a, b, w, out_dtype=torch.bfloat16) -> torch.Tensor:
    return _conv_plain(x, a, b, w, 1, out_dtype)


def bn_relu_conv3x3_s2_plain(x, a, b, w, out_dtype=torch.bfloat16) -> torch.Tensor:
    return _conv_plain(x, a, b, w, 2, out_dtype)


def conv3x3_dw_plain(x, a, b, dy) -> torch.Tensor:
    z = normalize_relu(x, a, b, dy.dtype).float().permute(0, 3, 1, 2)
    k, n = x.shape[-1], dy.shape[-1]
    dw = torch.nn.grad.conv2d_weight(z, (n, k, 3, 3), dy.float().permute(0, 3, 1, 2),
                                     padding=1)
    return dw.permute(2, 3, 1, 0).contiguous()


def _check_nhwc(t: torch.Tensor, name: str) -> None:
    if t.dim() != 4 or t.numel() == 0:
        raise ValueError(f"{name} must be a non-empty [B, H, W, C] tensor, got "
                         f"{tuple(t.shape)}")
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous NHWC (a channels_last activation "
                         f"seen through permute(0, 2, 3, 1)), got strides {t.stride()}")


def _check_conv(x, a, b, w, out_dtype) -> None:
    _check_nhwc(x, "x")
    check_pair(x, w, "w")
    k = x.shape[-1]
    if w.dim() != 4 or w.shape[:3] != (3, 3, k) or w.shape[3] == 0 or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous [3, 3, {k}, N] tensor, got "
                         f"{tuple(w.shape)}")
    check_affine(a, b, k, x.device)
    check_out_dtype(out_dtype)


def _launch_conv(fn, name: str, x, a, b, w, out_dtype, stride: int) -> torch.Tensor:
    bsz, h, wd, k = x.shape
    n = w.shape[3]
    y = torch.empty((bsz, h // stride, wd // stride, n), dtype=out_dtype, device=x.device)
    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(), y.data_ptr(),
             DTYPE_CODES[x.dtype], DTYPE_CODES[out_dtype], bsz, h, wd, k, n,
             _build.stream_handle(x.device))
    _build.check(err, name)
    return y


def bn_relu_conv3x3(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """relu(x*a + b) conv w (stride 1, zero pad 1): [B, H, W, N] NHWC."""
    _check_conv(x, a, b, w, out_dtype)
    if device_kind(x) == "cpu":
        return bn_relu_conv3x3_plain(x, a, b, w, out_dtype)
    y = _launch_conv(_build.load_library().moco_bn_relu_conv3x3, "bn_relu_conv3x3",
                     x, a, b, w, out_dtype, 1)
    bn_relu_conv3x3.launches += 1
    return y


bn_relu_conv3x3.launches = 0


def bn_relu_conv3x3_s2(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """relu(x*a + b) conv w at stride 2, symmetric pad 1 (output row r reads
    input rows 2r-1, 2r, 2r+1): [B, H/2, W/2, N] NHWC; H and W even."""
    _check_conv(x, a, b, w, out_dtype)
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"bn_relu_conv3x3_s2 needs even H and W, got {tuple(x.shape)}")
    if device_kind(x) == "cpu":
        return bn_relu_conv3x3_s2_plain(x, a, b, w, out_dtype)
    y = _launch_conv(_build.load_library().moco_bn_relu_conv3x3_s2, "bn_relu_conv3x3_s2",
                     x, a, b, w, out_dtype, 2)
    bn_relu_conv3x3_s2.launches += 1
    return y


bn_relu_conv3x3_s2.launches = 0


def conv3x3_dw(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               dy: torch.Tensor) -> torch.Tensor:
    """dW [3, 3, K, N] f32 of relu(x*a + b) conv W (stride 1, zero pad 1)
    against the output gradient dy [B, H, W, N], z recomputed from x."""
    _check_nhwc(x, "x")
    _check_nhwc(dy, "dy")
    check_pair(x, dy, "dy")
    if dy.shape[:3] != x.shape[:3]:
        raise ValueError(f"dy must be [{', '.join(map(str, x.shape[:3]))}, N], got "
                         f"{tuple(dy.shape)}")
    bsz, h, wd, k = x.shape
    check_affine(a, b, k, x.device)
    if device_kind(x) == "cpu":
        return conv3x3_dw_plain(x, a, b, dy)
    n = dy.shape[3]
    slabs = dw_slabs(bsz * h * wd, k, n, 9, x.dtype)
    part = dw_partials(slabs, 9, k, n, x.device)
    out = torch.empty((3, 3, k, n), dtype=torch.float32, device=x.device)
    err = _build.load_library().moco_conv3x3_dw(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), dy.data_ptr(), part.data_ptr(),
        out.data_ptr(), DTYPE_CODES[x.dtype], bsz, h, wd, k, n, slabs,
        _build.stream_handle(x.device),
    )
    _build.check(err, "conv3x3_dw")
    conv3x3_dw.launches += 1
    return out


conv3x3_dw.launches = 0
