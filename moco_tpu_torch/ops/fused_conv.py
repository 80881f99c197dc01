"""BatchNorm-normalize -> ReLU fused into a 1x1 conv (a matmul over rows):
the CUDA kernels of `csrc/fused_conv.cu` / `csrc/fused_conv_dw.cu` and their
plain PyTorch versions.

Port of `moco_tpu/ops/pallas_fused_conv.py`, in its layout: row-major
`[M, K]` / `[M, N]` matrices (a channels_last activation viewed as
`[N*H*W, C]`, see `models/fast_bn.rows_view`), with a = gamma*rstd and
b = beta - mean*a as f32 `[K]` vectors:

- `bn_relu_matmul(x, a, b, w, out_dtype)` -> relu(x*a + b) @ w    [M, N]
- `bn_relu_matmul_dw(x, a, b, dy)`        -> relu(x*a + b)^T @ dy [K, N] f32

z = relu(x*a + b) is computed in f32 and cast to the operand dtype before
the f32-accumulated product, as the Pallas bodies do; it never reaches
device memory in the kernels. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises. Each wrapper counts its kernel
launches in `.launches`.
"""

from __future__ import annotations

import torch

from moco_tpu_torch.ops import _build
from moco_tpu_torch.ops.stats import DTYPE_CODES, check_rows, check_vec, device_kind

# csrc/fused_conv_dw.cu's one-tap-per-block dW kernel, which serves
# bn_relu_matmul_dw (both dtypes) and the f32 route of conv3x3_dw
_TARGET_BLOCKS = 1024  # its pass-1 blocks to aim for: ~8 per SM of an H100
_DW_TILE = {torch.bfloat16: 128, torch.float32: 64}  # its dW tile side


def normalize_relu(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """z = relu(x*a + b) in f32 (a, b broadcast over the last axis), cast
    to `dtype`: the operand every fused kernel builds in registers."""
    return torch.relu(x.float() * a + b).to(dtype)


def bn_relu_matmul_plain(x, a, b, w, out_dtype=torch.bfloat16) -> torch.Tensor:
    z = normalize_relu(x, a, b, w.dtype)
    return torch.matmul(z.float(), w.float()).to(out_dtype)


def bn_relu_matmul_dw_plain(x, a, b, dy) -> torch.Tensor:
    z = normalize_relu(x, a, b, dy.dtype)
    return torch.matmul(z.float().t(), dy.float())


def check_affine(a: torch.Tensor, b: torch.Tensor, k: int, device) -> None:
    check_vec(a, k, device, "a")
    check_vec(b, k, device, "b")


def check_pair(x: torch.Tensor, other: torch.Tensor, name: str) -> None:
    """`other` (w or dy) shares x's dtype and device."""
    if other.dtype != x.dtype or other.device != x.device:
        raise ValueError(f"{name} must match x: {other.dtype} on {other.device} vs "
                         f"{x.dtype} on {x.device}")


def check_out_dtype(out_dtype) -> None:
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


def dw_slabs(m: int, k: int, n: int, taps: int, dtype) -> int:
    """Row slabs of the first pass of `csrc/fused_conv_dw.cu` (the 1x1 dW,
    and the f32 3x3 dW): enough blocks to fill the card, at least 256 rows a
    slab."""
    tile = _DW_TILE[dtype]
    blocks = taps * -(-k // tile) * -(-n // tile)
    return max(1, min(-(-m // 256), _TARGET_BLOCKS // blocks))


def dw_partials(slabs: int, taps: int, k: int, n: int, device) -> torch.Tensor:
    """Scratch for the slab partials (one slab writes the output directly)."""
    shape = (slabs, taps, k, n) if slabs > 1 else (0,)
    return torch.empty(shape, dtype=torch.float32, device=device)


def bn_relu_matmul(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """relu(x*a + b) @ w for x [M, K], w [K, N] of one dtype; [M, N] in
    `out_dtype`."""
    check_rows(x, "x")
    check_rows(w, "w")
    check_pair(x, w, "w")
    m, k = x.shape
    if w.shape[0] != k:
        raise ValueError(f"w must be [{k}, N], got {tuple(w.shape)}")
    check_affine(a, b, k, x.device)
    check_out_dtype(out_dtype)
    if device_kind(x) == "cpu":
        return bn_relu_matmul_plain(x, a, b, w, out_dtype)
    n = w.shape[1]
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    err = _build.load_library().moco_bn_relu_matmul(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(), y.data_ptr(),
        DTYPE_CODES[x.dtype], DTYPE_CODES[out_dtype], m, k, n,
        _build.stream_handle(x.device),
    )
    _build.check(err, "bn_relu_matmul")
    bn_relu_matmul.launches += 1
    return y


bn_relu_matmul.launches = 0


def bn_relu_matmul_dw(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      dy: torch.Tensor) -> torch.Tensor:
    """relu(x*a + b)^T @ dy for x [M, K], dy [M, N] of one dtype; f32
    [K, N]."""
    check_rows(x, "x")
    check_rows(dy, "dy")
    check_pair(x, dy, "dy")
    m, k = x.shape
    if dy.shape[0] != m:
        raise ValueError(f"dy must be [{m}, N], got {tuple(dy.shape)}")
    check_affine(a, b, k, x.device)
    if device_kind(x) == "cpu":
        return bn_relu_matmul_dw_plain(x, a, b, dy)
    n = dy.shape[1]
    slabs = dw_slabs(m, k, n, 1, x.dtype)
    part = dw_partials(slabs, 1, k, n, x.device)
    out = torch.empty((k, n), dtype=torch.float32, device=x.device)
    err = _build.load_library().moco_bn_relu_matmul_dw(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), dy.data_ptr(), part.data_ptr(),
        out.data_ptr(), DTYPE_CODES[x.dtype], m, k, n, slabs,
        _build.stream_handle(x.device),
    )
    _build.check(err, "bn_relu_matmul_dw")
    bn_relu_matmul_dw.launches += 1
    return out


bn_relu_matmul_dw.launches = 0
