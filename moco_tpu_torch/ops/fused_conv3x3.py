"""BatchNorm-normalize -> ReLU fused into a 3x3 conv: the CUDA kernels of
`csrc/conv3x3_fwd.cu` (bf16 forwards), `csrc/fused_conv.cu` (f32 forwards),
`csrc/conv3x3_dw.cu` (bf16 weight gradient) and `csrc/fused_conv_dw.cu`
(f32 weight gradient), and their plain PyTorch versions.

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

Each wrapper dispatches by dtype, and both routes count in its `.launches`:
bf16 (the training path) launches a band kernel on a launch plan, the
forwards' of `csrc/conv3x3_fwd.cu` (`conv3x3_fwd_plan`) and the weight
gradient's of `csrc/conv3x3_dw.cu` (`conv3x3_dw_plan`); f32 (reached only
by f32 checks) launches the implicit GEMM of `csrc/fused_conv.cu` or the
one-tap-per-block kernel of `csrc/fused_conv_dw.cu` at nine taps. A failed
launch on either route raises.
"""

from __future__ import annotations

import functools
import math
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


def _launch_conv(name: str, x, a, b, w, out_dtype, stride: int,
                 plan: "Fwd3x3Plan | None" = None) -> torch.Tensor:
    """bf16: the band kernel on `plan` (by default `conv3x3_fwd_plan`'s);
    f32: the implicit GEMM of `csrc/fused_conv.cu`."""
    bsz, h, wd, k = x.shape
    n = w.shape[3]
    lib = _build.load_library()
    y = torch.empty((bsz, h // stride, wd // stride, n), dtype=out_dtype, device=x.device)
    args = (x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(), y.data_ptr(),
            DTYPE_CODES[out_dtype], bsz, h, wd, k, n)
    stream = _build.stream_handle(x.device)
    if x.dtype == torch.bfloat16:
        plan = plan or conv3x3_fwd_plan(bsz, h, wd, k, n, stride)
        err = lib.moco_conv3x3_fwd_bf16(*args, stride, plan.bn, plan.bk, plan.band_rows,
                                        plan.smem_bytes, stream)
    elif stride == 1:
        err = lib.moco_bn_relu_conv3x3_f32(*args, stream)
    else:
        err = lib.moco_bn_relu_conv3x3_s2_f32(*args, stream)
    _build.check(err, name)
    return y


def bn_relu_conv3x3(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """relu(x*a + b) conv w (stride 1, zero pad 1): [B, H, W, N] NHWC."""
    _check_conv(x, a, b, w, out_dtype)
    if device_kind(x) == "cpu":
        return bn_relu_conv3x3_plain(x, a, b, w, out_dtype)
    y = _launch_conv("bn_relu_conv3x3", x, a, b, w, out_dtype, 1)
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
    y = _launch_conv("bn_relu_conv3x3_s2", x, a, b, w, out_dtype, 2)
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
        slabs = dw_slabs(bsz * h * wd, k, n, 9)
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


# The bf16 forward band kernel's geometry (csrc/conv3x3_fwd.cu): 8 warps of
# 64 x 32 outputs, K-chunks of 64 or 32 channels, shared-memory band pixels
# of bk + 8 bf16 (so that ldmatrix rows fall in distinct banks), two W
# stages, and a 16 x 36 f32 epilogue staging per warp that overlays them.
FWD_WARPS = 8
FWD_W_STAGES = 2
FWD_STAGING_BYTES = FWD_WARPS * 16 * 36 * 4
FWD_SM_SMEM = 233472          # bytes of shared memory per SM of an H100


@dataclass(frozen=True)
class Fwd3x3Plan:
    """Launch plan of the bf16 forward band kernel (`bn_relu_conv3x3` at
    stride 1, `bn_relu_conv3x3_s2` at stride 2).

    A block owns `bm` consecutive output pixels (image-major: an M tile,
    which may span several images) and `bn` output channels, and walks the
    K-chunks of `bk` channels. The band of an M tile holds, per image it
    touches, the padded input rows its output rows read (image rows
    S*r_lo - 1 .. S*r_hi + 1; row -1 and row H are zero), each `wp` = W + 2
    pixels of one K-chunk. At stride 1 slot s of a band row is padded column
    s; at stride 2 the even padded columns come first (slots 0 .. half - 1),
    then the odd ones. Output pixel m reads band pixel
    `bases(tile)[m] + tap_offset(di, dj)` at tap (di, dj). `band_rows` is
    what the largest M tile needs."""

    bsz: int
    h: int
    w: int
    k: int
    n: int
    stride: int
    bn: int
    bk: int
    band_rows: int

    @property
    def bm(self) -> int:
        return 64 * (FWD_WARPS // (self.bn // 32))

    @property
    def ho(self) -> int:
        return self.h // self.stride

    @property
    def wo(self) -> int:
        return self.w // self.stride

    @property
    def m(self) -> int:
        return self.bsz * self.ho * self.wo

    @property
    def tiles_m(self) -> int:
        return -(-self.m // self.bm)

    @property
    def tiles_n(self) -> int:
        return -(-self.n // self.bn)

    @property
    def blocks(self) -> int:
        return self.tiles_m * self.tiles_n

    @property
    def k_chunks(self) -> int:
        return -(-self.k // self.bk)

    @property
    def pitch(self) -> int:
        """bf16 per band pixel."""
        return self.bk + 8

    @property
    def wp(self) -> int:
        return self.w + 2

    @property
    def half(self) -> int:
        return self.wp // 2

    @property
    def smem_bytes(self) -> int:
        """The band and the W stages (or the epilogue staging, which
        overlays them, if larger), then the row and base tables (int32)."""
        stages = self.band_rows * self.wp * self.pitch * 2 + \
            FWD_W_STAGES * self.bk * (self.bn + 8) * 2
        return max(stages, FWD_STAGING_BYTES) + 4 * (self.band_rows + self.bm)

    @property
    def blocks_per_sm(self) -> int:
        """Blocks one SM holds by shared memory (1 KB reserved per block);
        the registers allow two."""
        return min(2, FWD_SM_SMEM // (self.smem_bytes + 1024))

    def slot(self, col: int) -> int:
        """Band slot of padded column `col` (0 .. W + 1)."""
        if self.stride == 1:
            return col
        return col // 2 if col % 2 == 0 else self.half + col // 2

    def tap_offset(self, di: int, dj: int) -> int:
        """Band pixels from an output pixel's base (tap (0, 0)) to tap (di, dj)."""
        return di * self.wp + self.slot(1 + dj) - self.slot(1)

    def tile_span(self, tile: int) -> tuple[int, int, int, int, int]:
        """(first pixel, last pixel, first image, its first output row, band
        rows of its segment) of an M tile."""
        hw = self.ho * self.wo
        p0 = tile * self.bm
        p1 = min(p0 + self.bm, self.m) - 1
        img0, img1 = p0 // hw, p1 // hw
        rlo0 = p0 % hw // self.wo
        rhi0 = p1 % hw // self.wo if img1 == img0 else self.ho - 1
        return p0, p1, img0, rlo0, self.stride * (rhi0 - rlo0) + 3

    def row_sources(self, tile: int) -> list[tuple[int, int]]:
        """(image, image row) of every band row an M tile uses, in band
        order; a row outside the image (-1 or H) is zero in the band."""
        p0, p1, img0, rlo0, rows0 = self.tile_span(tile)
        hw = self.ho * self.wo
        out = [(img0, self.stride * rlo0 - 1 + j) for j in range(rows0)]
        for img in range(img0 + 1, p1 // hw + 1):
            rhi = p1 % hw // self.wo if img == p1 // hw else self.ho - 1
            out += [(img, ir) for ir in range(-1, self.stride * rhi + 2)]
        return out

    def bases(self, tile: int) -> list[int]:
        """Band pixel of each M row's tap (0, 0); rows past the last output
        pixel repeat it."""
        p0, p1, img0, rlo0, rows0 = self.tile_span(tile)
        hw = self.ho * self.wo
        full = self.stride * (self.ho - 1) + 3
        out = []
        for m in range(self.bm):
            p = min(p0 + m, p1)
            img, r, c = p // hw, p % hw // self.wo, p % self.wo
            seg = 0 if img == img0 else rows0 + (img - img0 - 1) * full
            rlo = rlo0 if img == img0 else 0
            out.append((seg + self.stride * (r - rlo) + 1) * self.wp +
                       self.slot(self.stride * c + 1))
        return out


def _fwd_band_rows(bsz: int, h: int, w: int, k: int, n: int, stride: int, bn: int) -> int:
    """Band rows of the largest M tile. A tile's span depends only on its
    first pixel's place in its image, so the first hw / gcd(bm, hw) tiles
    cover every span (the last tile included where there are fewer)."""
    plan = Fwd3x3Plan(bsz, h, w, k, n, stride, bn, 64, 0)
    hw = plan.ho * plan.wo
    period = hw // math.gcd(plan.bm, hw)
    return max(len(plan.row_sources(t)) for t in range(min(plan.tiles_m, period)))


@functools.lru_cache(maxsize=256)
def conv3x3_fwd_plan(bsz: int, h: int, w: int, k: int, n: int, stride: int) -> Fwd3x3Plan:
    """Tile, K-chunk depth and band rows for x [bsz, h, w, k] and
    w [3, 3, k, n].

    The tile follows N: 256 x 64 where N <= 64 (no half-empty N tiles), else
    128 x 128. K-chunks of 64 channels, or of 32 where only those let two
    blocks share an SM (the stride-2 bands, which read about four input
    pixels per output pixel)."""
    if stride not in (1, 2) or (stride == 2 and (h % 2 or w % 2)):
        raise ValueError(f"conv3x3_fwd: stride {stride} on a {h} x {w} image")
    bn = 64 if n <= 64 else 128
    rows = _fwd_band_rows(bsz, h, w, k, n, stride, bn)
    deep, shallow = (Fwd3x3Plan(bsz, h, w, k, n, stride, bn, bk, rows) for bk in (64, 32))
    if deep.blocks_per_sm < 2 and shallow.blocks_per_sm == 2:
        return shallow
    for plan in (deep, shallow):
        if plan.smem_bytes <= DW_BAND_SMEM_LIMIT:
            return plan
    raise ValueError(f"conv3x3_fwd: the band of a {deep.bm}-pixel tile of {h} x {w} images "
                     f"({rows} rows) does not fit in shared memory")
