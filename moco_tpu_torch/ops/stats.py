"""Per-channel BatchNorm reductions: the CUDA kernels of
`csrc/channel_stats.cu` and their plain PyTorch versions.

Port of `moco_tpu/ops/pallas_stats.py`. Both functions take a `[M, C]`
row-major matrix (a channels_last activation viewed as `[N*H*W, C]`, see
`models/fast_bn.rows_view`) and return f32 `[C]` vectors:

- `channel_sums(x)`                        -> (sum x, sum x^2)    (BN forward)
- `channel_grad_sums(dy, x, mean, rstd)`   -> (sum dy, sum dy*xhat) (BN backward)

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Each wrapper counts its kernel launches in `.launches`.
"""

from __future__ import annotations

import torch

from moco_tpu_torch.ops import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TARGET_BLOCKS = 1024  # pass-1 blocks to aim for: ~8 per SM of an H100


def channel_sums_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    return xf.sum(0), (xf * xf).sum(0)


def channel_grad_sums_plain(dy, x, mean, rstd) -> tuple[torch.Tensor, torch.Tensor]:
    dyf = dy.float()
    xh = (x.float() - mean) * rstd
    return dyf.sum(0), (dyf * xh).sum(0)


def check_rows(t: torch.Tensor, name: str) -> None:
    if t.dim() != 2 or t.shape[0] == 0 or t.shape[1] == 0:
        raise ValueError(f"{name} must be a non-empty [M, C] matrix, got {tuple(t.shape)}")
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major [M, C])")


def check_vec(t: torch.Tensor, c: int, device, name: str) -> None:
    if t.shape != (c,) or t.dtype != torch.float32 or t.device != device:
        raise ValueError(f"{name} must be float32 [{c}] on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def num_slabs(m: int, c: int) -> int:
    """Row slabs of the first pass: enough blocks to fill the card (a block
    covers up to 256 bf16 channels), at least 256 rows a slab."""
    channel_tiles = -(-c // 256)
    return max(1, min(-(-m // 256), _TARGET_BLOCKS // channel_tiles))


def channel_sums(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum x, sum x^2) over the rows of `x` [M, C]; f32 [C] each."""
    check_rows(x, "x")
    if device_kind(x) == "cpu":
        return channel_sums_plain(x)
    m, c = x.shape
    slabs = num_slabs(m, c)
    part = torch.empty((2, slabs, c), dtype=torch.float32, device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    err = lib.moco_channel_sums(
        x.data_ptr(), DTYPE_CODES[x.dtype], m, c, slabs,
        part[0].data_ptr(), part[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        _build.stream_handle(x.device),
    )
    _build.check(err, "channel_sums")
    channel_sums.launches += 1
    return out[0], out[1]


channel_sums.launches = 0


def channel_grad_sums(
    dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum dy, sum dy*xhat) over the rows, xhat = (x - mean) * rstd
    recomputed in registers (never stored); f32 [C] each."""
    check_rows(dy, "dy")
    check_rows(x, "x")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy and x must match: {dy.dtype} {tuple(dy.shape)} on "
                         f"{dy.device} vs {x.dtype} {tuple(x.shape)} on {x.device}")
    c = x.shape[1]
    check_vec(mean, c, x.device, "mean")
    check_vec(rstd, c, x.device, "rstd")
    if device_kind(x) == "cpu":
        return channel_grad_sums_plain(dy, x, mean, rstd)
    m = x.shape[0]
    slabs = num_slabs(m, c)
    part = torch.empty((2, slabs, c), dtype=torch.float32, device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    err = lib.moco_channel_grad_sums(
        dy.data_ptr(), x.data_ptr(), DTYPE_CODES[x.dtype], mean.data_ptr(),
        rstd.data_ptr(), m, c, slabs, part[0].data_ptr(), part[1].data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), _build.stream_handle(x.device),
    )
    _build.check(err, "channel_grad_sums")
    channel_grad_sums.launches += 1
    return out[0], out[1]


channel_grad_sums.launches = 0
