"""BatchNorm-normalize -> ReLU fused into a 3x3 conv: the CUDA kernels of
`csrc/fused_conv.cu` (forwards), `csrc/conv3x3_dw.cu` (bf16 weight gradient)
and `csrc/fused_conv_dw.cu` (f32 weight gradient), and their plain PyTorch
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

`conv3x3_dw` dispatches by dtype, and both routes count in its `.launches`:
bf16 (the training path) launches the band kernel of `csrc/conv3x3_dw.cu`
on the launch plan of `conv3x3_dw_plan`; f32 (reached only by f32 checks)
launches the one-tap-per-block kernel of `csrc/fused_conv_dw.cu` at nine
taps. A failed launch on either route raises.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

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
    lib = _build.load_library()
    out = torch.empty((3, 3, k, n), dtype=torch.float32, device=x.device)
    stream = _build.stream_handle(x.device)
    if x.dtype == torch.bfloat16:
        plan = conv3x3_dw_plan(bsz, h, wd, k, n)
        part = dw_partials(plan.slabs, 9, k, n, x.device)
        err = lib.moco_conv3x3_dw_bf16(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), dy.data_ptr(), part.data_ptr(),
            out.data_ptr(), bsz, h, wd, k, n, plan.rows, plan.slabs, plan.smem_bytes, stream)
    else:
        slabs = dw_slabs(bsz * h * wd, k, n, 9, x.dtype)
        part = dw_partials(slabs, 9, k, n, x.device)
        err = lib.moco_conv3x3_dw_f32(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), dy.data_ptr(), part.data_ptr(),
            out.data_ptr(), bsz, h, wd, k, n, slabs, stream)
    _build.check(err, "conv3x3_dw")
    conv3x3_dw.launches += 1
    return out


conv3x3_dw.launches = 0


# The bf16 band kernel's geometry (csrc/conv3x3_dw.cu): dW tiles of 64 input
# x 64 output channels, shared-memory pixel rows of 72 bf16 (64 + 8, so
# that ldmatrix rows fall in distinct banks), one block per SM of an H100.
DW_BAND_TILE = 64
DW_BAND_PITCH = 72
DW_BAND_STAGES = 3            # bands in shared memory at once
DW_BAND_SMEM_LIMIT = 232448   # bytes of shared memory one block may use (227 KB)
DW_BAND_SMS = 132             # SMs of an H100 SXM: the blocks of one full wave
DW_BAND_SCRATCH_LIMIT = 64 << 20  # bytes of f32 slab partials at most


@dataclass(frozen=True)
class Dw3x3Plan:
    """Launch plan of the bf16 `conv3x3_dw` band kernel.

    A band is `rows` output rows of one image. Its z lives in shared memory
    as (rows + 2) x (w + 2) padded pixels of 64 channels (the row above and
    below and one column either side, zero outside the image), followed by
    zero pixels up to `z_pix`. Its dy lives beside it at the padded pixels
    q = r*(w + 2) + c of the output rows, zero for c >= w, up to `q_pad` (a
    multiple of 16, the depth of one tensor-core product). Tap (di, dj) of
    pixel q reads z pixel q + `tap_offset(di, dj)`. A block owns one
    64 x 64 tile of dW for all nine taps and walks the bands of one slab;
    slab s writes partial s, and a second pass sums them in slab order."""

    bsz: int
    h: int
    w: int
    k: int
    n: int
    rows: int
    slabs: int

    @property
    def bands_per_image(self) -> int:
        return -(-self.h // self.rows)

    @property
    def bands(self) -> int:
        return self.bsz * self.bands_per_image

    @property
    def q_pad(self) -> int:
        return -(-self.rows * (self.w + 2) // 16) * 16

    @property
    def z_pix(self) -> int:
        # pixel q_pad - 1 at the largest tap offset is the last one read
        return self.q_pad + self.tap_offset(1, 1)

    @property
    def smem_bytes(self) -> int:
        """a and b (f32), then the stages of z and dy (bf16)."""
        return 2 * DW_BAND_TILE * 4 + \
            DW_BAND_STAGES * (self.z_pix + self.q_pad) * DW_BAND_PITCH * 2

    @property
    def tiles(self) -> int:
        return -(-self.k // DW_BAND_TILE) * -(-self.n // DW_BAND_TILE)

    @property
    def blocks(self) -> int:
        return self.tiles * self.slabs

    def tap_offset(self, di: int, dj: int) -> int:
        return (1 + di) * (self.w + 2) + (1 + dj)

    def band_origin(self, band: int) -> tuple[int, int]:
        """(image, first output row) of a band."""
        return band // self.bands_per_image, band % self.bands_per_image * self.rows

    def slab_bands(self, slab: int) -> range:
        return range(slab * self.bands // self.slabs, (slab + 1) * self.bands // self.slabs)


@functools.lru_cache(maxsize=256)
def conv3x3_dw_plan(bsz: int, h: int, w: int, k: int, n: int) -> Dw3x3Plan:
    """Band rows and slabs for x [bsz, h, w, k] and dy [bsz, h, w, n].

    Rows: the count whose z and dy stages fit in a block's shared memory and
    that gives the least work per image, counted as contracted pixels
    (q_pad) plus normalized halo pixels, per band; ties go to the taller
    band. Slabs: the fewest that give at least one full wave of blocks
    (where there are bands enough) and the least estimated time, waves x
    bands per slab, with the partials under DW_BAND_SCRATCH_LIMIT."""
    best = None
    for r in range(1, h + 1):
        cand = Dw3x3Plan(bsz, h, w, k, n, r, 1)
        if cand.smem_bytes > DW_BAND_SMEM_LIMIT:
            break
        cost = cand.bands_per_image * (cand.q_pad + (r + 2) * (w + 2))
        if best is None or cost <= best[0]:
            best = (cost, cand)
    if best is None:
        raise ValueError(f"conv3x3_dw: an image row of width {w} does not fit in shared memory")
    plan = best[1]
    best = (None, 1)
    for s in range(1, plan.bands + 1):
        if s > 1 and s * 9 * k * n * 4 > DW_BAND_SCRATCH_LIMIT:
            break
        blocks = plan.tiles * s
        if blocks < DW_BAND_SMS and s < plan.bands:
            continue
        cost = -(-blocks // DW_BAND_SMS) * -(-plan.bands // s)
        if best[0] is None or cost < best[0]:
            best = (cost, s)
    return Dw3x3Plan(bsz, h, w, k, n, plan.rows, best[1])
