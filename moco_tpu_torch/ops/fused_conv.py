"""BatchNorm-normalize -> ReLU fused into a 1x1 conv (a matmul over rows):
the CUDA kernels of `csrc/matmul_fwd.cu` / `csrc/matmul_dw.cu` (bf16) and
`csrc/fused_conv.cu` / `csrc/fused_conv_dw.cu` (f32), and their plain
PyTorch versions.

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

Each wrapper dispatches by dtype, and both routes count in its `.launches`:
bf16 (the training path) launches a tensor-core kernel on a launch plan,
the forward's panel kernel (`matmul_fwd_plan`) or the weight gradient's
row-walk kernel with its cluster sum (`matmul_dw_plan`); f32 (reached only
by f32 checks) launches the implicit GEMM templates of `csrc/fused_conv.cu`
and `csrc/fused_conv_dw.cu`. A failed launch on either route raises.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from moco_tpu_torch.ops import _build
from moco_tpu_torch.ops.stats import DTYPE_CODES, check_rows, check_vec, device_kind

# csrc/fused_conv_dw.cu's one-tap-per-block dW kernel, which serves the f32
# routes of bn_relu_matmul_dw and conv3x3_dw
_TARGET_BLOCKS = 1024  # its pass-1 blocks to aim for: ~8 per SM of an H100
_DW_TILE = 64  # its dW tile side


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


def dw_slabs(m: int, k: int, n: int, taps: int) -> int:
    """Row slabs of the first pass of `csrc/fused_conv_dw.cu` (the f32 1x1
    and 3x3 dW): enough blocks to fill the card, at least 256 rows a slab."""
    blocks = taps * -(-k // _DW_TILE) * -(-n // _DW_TILE)
    return max(1, min(-(-m // 256), _TARGET_BLOCKS // blocks))


def dw_partials(slabs: int, taps: int, k: int, n: int, device) -> torch.Tensor:
    """Scratch for the slab partials (one slab writes the output directly)."""
    shape = (slabs, taps, k, n) if slabs > 1 else (0,)
    return torch.empty(shape, dtype=torch.float32, device=device)


# The bf16 kernels' geometry (csrc/matmul_fwd.cu, csrc/matmul_dw.cu): 8 warps
# of 64 x 32 outputs each (64 f32 accumulators a thread), on an H100 SXM.
MM_WARPS = 8
MM_CHUNK = 64                 # channels per forward panel chunk; rows per dW chunk
MM_W_STAGES = 3               # forward W tiles in shared memory at once
MM_STAGING_BYTES = MM_WARPS * 16 * 36 * 4  # the forward's per-warp epilogue staging
MM_STREAM_SLOTS = 3           # forward panel slots when x streams
MM_DW_STAGES = 3              # dW row chunks in shared memory at once (four: slower on an H100)
MM_SMEM_LIMIT = 232448        # bytes of shared memory one block may use (227 KB)
MM_SM_SMEM = 233472           # bytes of shared memory per SM
MM_SMS = 132                  # SMs of an H100 SXM
MM_MAX_CLUSTER = 8            # the portable thread-block cluster size the kernel takes
MM_PLAN_CLUSTER = 2           # the largest the plan gives: 4 and 8 ran slower on an H100
MM_PARTIAL_SHARE = 8          # dW partials through HBM: at most 1/8 of x + dy bytes


def _blocks_per_sm(smem_bytes: int) -> int:
    """Blocks one SM holds by shared memory (1 KB reserved per block); the
    registers (at most 128 a thread) allow two."""
    return max(1, min(2, MM_SM_SMEM // (smem_bytes + 1024)))


@dataclass(frozen=True)
class MatmulFwdPlan:
    """Launch plan of the bf16 `bn_relu_matmul` panel kernel.

    A block owns `bm` rows (an M tile) and a span of `span` columns, swept
    as N tiles of `bn`; it walks steps (N tile, K-chunk of 64). Its x rows
    live in `slots` shared-memory chunks of `bm` x 64 channels at a pitch of
    72 bf16. When the slots hold every chunk (`resident`) chunk c is copied
    and normalized once, at step c, and every N tile of the span reads it;
    otherwise (at least MM_STREAM_SLOTS slots) step s copies its chunk into
    slot s % slots again."""

    m: int
    k: int
    n: int
    bn: int
    span: int
    slots: int

    @property
    def bm(self) -> int:
        return 64 * (MM_WARPS // (self.bn // 32))

    @property
    def k_chunks(self) -> int:
        return -(-self.k // MM_CHUNK)

    @property
    def tiles_m(self) -> int:
        return -(-self.m // self.bm)

    @property
    def tiles_n(self) -> int:
        return -(-self.n // self.bn)

    @property
    def span_tiles(self) -> int:
        return self.span // self.bn

    @property
    def spans(self) -> int:
        return -(-self.tiles_n // self.span_tiles)

    @property
    def blocks(self) -> int:
        return self.tiles_m * self.spans

    @property
    def resident(self) -> bool:
        return self.slots >= self.k_chunks

    @property
    def normalizations(self) -> int:
        """Times each x element is read from device memory and normalized."""
        return self.spans if self.resident else self.tiles_n

    @property
    def smem_bytes(self) -> int:
        """The panel slots, the W ring and the epilogue staging."""
        return self.slots * self.bm * (MM_CHUNK + 8) * 2 + \
            MM_W_STAGES * MM_CHUNK * (self.bn + 8) * 2 + MM_STAGING_BYTES

    @property
    def blocks_per_sm(self) -> int:
        return _blocks_per_sm(self.smem_bytes)

    def block_tiles(self, block: int) -> tuple[int, range]:
        """(M tile, N tiles) of a block."""
        t0 = block % self.spans * self.span_tiles
        return block // self.spans, range(t0, min(t0 + self.span_tiles, self.tiles_n))

    def steps(self, block: int) -> list[tuple[int, int, int, bool]]:
        """(N tile, K-chunk, panel slot, copied and normalized here) of each
        step of a block, in order."""
        _, tiles = self.block_tiles(block)
        out = []
        for s in range(len(tiles) * self.k_chunks):
            t, c = divmod(s, self.k_chunks)
            slot = (c if self.resident else s) % self.slots
            out.append((tiles[t], c, slot, not self.resident or s < self.k_chunks))
        return out


@functools.lru_cache(maxsize=256)
def matmul_fwd_plan(m: int, k: int, n: int) -> MatmulFwdPlan:
    """Tile, span and panel slots for x [m, k] and w [k, n].

    The tile follows N: 256 x 64 where N <= 64 (no half-empty N tiles), else
    128 x 128. The panel holds all of x's K-chunks where they fit beside
    the W ring (K <= 512 at 128 rows), else MM_STREAM_SLOTS streaming slots
    and a span of one N tile. A resident span takes the least estimated
    time, waves of blocks x steps per block, and of equal times the widest
    (x read and normalized the fewest times)."""
    if m <= 0 or k <= 0 or n <= 0:
        raise ValueError(f"matmul_fwd: empty [{m}, {k}] @ [{k}, {n}]")
    bn = 64 if n <= 64 else 128
    plan = MatmulFwdPlan(m, k, n, bn, bn, -(-k // MM_CHUNK))
    if plan.smem_bytes > MM_SMEM_LIMIT:
        return MatmulFwdPlan(m, k, n, bn, bn, MM_STREAM_SLOTS)
    capacity = MM_SMS * plan.blocks_per_sm
    best = None
    for span_tiles in range(1, plan.tiles_n + 1):
        cand = MatmulFwdPlan(m, k, n, bn, span_tiles * bn, plan.slots)
        cost = (-(-cand.blocks // capacity) * span_tiles * cand.k_chunks, -span_tiles)
        if best is None or cost < best[0]:
            best = (cost, cand)
    return best[1]


@dataclass(frozen=True)
class MatmulDwPlan:
    """Launch plan of the bf16 `bn_relu_matmul_dw` row-walk kernel.

    A block owns a `bko` x `bn` tile of dW and one slab of `rows_per_slab`
    consecutive rows (the last slab fewer), walked in chunks of 64 through
    MM_DW_STAGES shared-memory stages. The `cluster` consecutive slabs of a tile
    form a thread-block cluster whose blocks sum their f32 tiles in rank
    order on chip. The first cluster of a tile writes dW; with more
    (`groups` > 1) each later one writes a partial, and a second pass adds
    them to dW in group order."""

    m: int
    k: int
    n: int
    bko: int
    slabs: int
    cluster: int

    @property
    def bn(self) -> int:
        return 32 * (MM_WARPS // (self.bko // 64))

    @property
    def tiles_k(self) -> int:
        return -(-self.k // self.bko)

    @property
    def tiles_n(self) -> int:
        return -(-self.n // self.bn)

    @property
    def tiles(self) -> int:
        return self.tiles_k * self.tiles_n

    @property
    def blocks(self) -> int:
        return self.tiles * self.slabs

    @property
    def groups(self) -> int:
        return self.slabs // self.cluster

    @property
    def rows_per_slab(self) -> int:
        return -(-self.m // self.slabs)

    @property
    def chunks_per_slab(self) -> int:
        return -(-self.rows_per_slab // MM_CHUNK)

    @property
    def smem_bytes(self) -> int:
        """The ring of x and dy stages, or the f32 tile that overlays it."""
        ring = MM_DW_STAGES * MM_CHUNK * ((self.bko + 8) + (self.bn + 8)) * 2
        return max(ring, self.bko * (self.bn + 8) * 4)

    @property
    def blocks_per_sm(self) -> int:
        return _blocks_per_sm(self.smem_bytes)

    @property
    def partial_bytes(self) -> int:
        """f32 partials written to device memory (each read back once)."""
        return (self.groups - 1) * self.k * self.n * 4

    def slab_rows(self, slab: int) -> range:
        r0 = min(slab * self.rows_per_slab, self.m)
        return range(r0, min(r0 + self.rows_per_slab, self.m))


@functools.lru_cache(maxsize=256)
def matmul_dw_plan(m: int, k: int, n: int) -> MatmulDwPlan:
    """Tile, slabs and cluster size for x [m, k] and dy [m, n].

    The tile follows K: 64 x 256 where K <= 64 (no half-empty products; one
    block per SM), else 128 x 128 (two blocks per SM). Slabs and cluster: the least estimated time, waves of
    blocks x chunks per slab, then the fewest partials; no slab empty, the
    partials under 1/MM_PARTIAL_SHARE of the bytes of x and dy, and
    clusters of at most MM_PLAN_CLUSTER blocks."""
    if m <= 0 or k <= 0 or n <= 0:
        raise ValueError(f"matmul_dw: empty [{m}, {k}]^T @ [{m}, {n}]")
    bko = 64 if k <= 64 else 128
    base = MatmulDwPlan(m, k, n, bko, 1, 1)
    capacity = MM_SMS * base.blocks_per_sm
    budget = (m * k + m * n) * 2 // MM_PARTIAL_SHARE
    max_slabs = max(1, min(-(-m // MM_CHUNK), 4 * capacity // base.tiles + MM_PLAN_CLUSTER))
    best = None
    for cluster in range(1, MM_PLAN_CLUSTER + 1):
        for slabs in range(cluster, max_slabs + 1, cluster):
            plan = MatmulDwPlan(m, k, n, bko, slabs, cluster)
            if (slabs - 1) * plan.rows_per_slab >= m or plan.partial_bytes > budget:
                continue
            cost = (-(-plan.blocks // capacity) * plan.chunks_per_slab, plan.groups, cluster)
            if best is None or cost < best[0]:
                best = (cost, plan)
    return best[1] if best else base


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
    y = _launch_matmul(x, a, b, w, out_dtype)
    bn_relu_matmul.launches += 1
    return y


bn_relu_matmul.launches = 0


def _launch_matmul(x, a, b, w, out_dtype, plan: MatmulFwdPlan | None = None) -> torch.Tensor:
    """bf16: the panel kernel on `plan` (by default `matmul_fwd_plan`'s);
    f32: the implicit GEMM of `csrc/fused_conv.cu`."""
    (m, k), n = x.shape, w.shape[1]
    lib = _build.load_library()
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    args = (x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(), y.data_ptr())
    stream = _build.stream_handle(x.device)
    if x.dtype == torch.bfloat16:
        plan = plan or matmul_fwd_plan(m, k, n)
        err = lib.moco_matmul_fwd_bf16(*args, DTYPE_CODES[out_dtype], m, k, n, plan.bn,
                                       plan.span, plan.slots, plan.smem_bytes, stream)
    else:
        err = lib.moco_bn_relu_matmul(*args, DTYPE_CODES[x.dtype], DTYPE_CODES[out_dtype], m, k,
                                      n, stream)
    _build.check(err, "bn_relu_matmul")
    return y


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
    out = _launch_matmul_dw(x, a, b, dy)
    bn_relu_matmul_dw.launches += 1
    return out


bn_relu_matmul_dw.launches = 0


def _launch_matmul_dw(x, a, b, dy, plan: MatmulDwPlan | None = None) -> torch.Tensor:
    """bf16: the row-walk kernel on `plan` (by default `matmul_dw_plan`'s),
    with its cluster partials; f32: the slab kernel of
    `csrc/fused_conv_dw.cu`."""
    (m, k), n = x.shape, dy.shape[1]
    lib = _build.load_library()
    out = torch.empty((k, n), dtype=torch.float32, device=x.device)
    stream = _build.stream_handle(x.device)
    if x.dtype == torch.bfloat16:
        plan = plan or matmul_dw_plan(m, k, n)
        part = torch.empty((plan.groups - 1, k, n), dtype=torch.float32, device=x.device)
        err = lib.moco_matmul_dw_bf16(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), dy.data_ptr(), part.data_ptr(),
            out.data_ptr(), m, k, n, plan.bko, plan.slabs, plan.cluster, plan.smem_bytes,
            stream)
    else:
        slabs = dw_slabs(m, k, n, 1)
        part = dw_partials(slabs, 1, k, n, x.device)
        err = lib.moco_bn_relu_matmul_dw(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), dy.data_ptr(), part.data_ptr(),
            out.data_ptr(), DTYPE_CODES[x.dtype], m, k, n, slabs, stream)
    _build.check(err, "bn_relu_matmul_dw")
    return out
