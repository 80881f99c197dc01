"""Per-channel BatchNorm reductions: the CUDA kernels of
`csrc/channel_stats.cu` and their plain PyTorch versions.

Port of `moco_tpu/ops/pallas_stats.py`. Both functions take a `[M, C]`
row-major matrix (a channels_last activation viewed as `[N*H*W, C]`, see
`models/fast_bn.rows_view`) and return f32 `[C]` vectors:

- `channel_sums(x)`                        -> (sum x, sum x^2)    (BN forward)
- `channel_grad_sums(dy, x, mean, rstd)`   -> (sum dy, sum dy*xhat) (BN backward)

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Each call on the card is one kernel launch on a `StatsPlan`
(`stats_plan`): blocks of channel tile x row slab, the slab partials folded
by the last block of each tile, which it finds by an integer ticket. Each
wrapper counts its kernel launches in `.launches`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from moco_tpu_torch.ops import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# csrc/channel_stats.cu's geometry, on an H100 SXM
STATS_THREADS = 256         # threads per block
STATS_BLOCKS_PER_SM = 2     # __launch_bounds__(256, 2): up to 128 registers a thread
STATS_SMS = 132             # SMs of an H100 SXM; the wrappers pass the card's own count
STATS_MAX_LANES = 32        # threads across a tile's channels: one warp
STATS_LOADS = 8             # 16-byte loads a thread has in flight: the batch is 8 rows of
                            # one operand or 4 of two (8 of two spill past 128 registers)
STATS_SEGMENT = 128         # bytes of each row one tile covers: a whole line


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


@dataclass(frozen=True)
class StatsPlan:
    """Launch plan of `channel_sums_rows` / `channel_grad_sums_rows`.

    A block of STATS_THREADS threads owns a tile of `lanes * vec` channels
    (`lanes` threads of `vec` channels, one load each) and a slab of
    `rows_per_slab` consecutive rows (the last slab fewer), which its
    `row_lanes` row lanes walk, `batch` rows a lane per batch of loads
    (STATS_LOADS / the number of operands). The
    grid is tiles x slabs; each block writes one f32 partial per channel of
    its tile at row `slab` of the workspace, and the last block of a tile
    folds the tile's partials in slab order."""

    m: int
    c: int
    vec: int
    lanes: int
    batch: int
    slabs: int
    sms: int = STATS_SMS

    @property
    def row_lanes(self) -> int:
        return STATS_THREADS // self.lanes

    @property
    def tile(self) -> int:
        """Channels of one tile."""
        return self.lanes * self.vec

    @property
    def tiles(self) -> int:
        return -(-self.c // self.tile)

    @property
    def rows_per_slab(self) -> int:
        return -(-self.m // self.slabs)

    @property
    def blocks(self) -> int:
        return self.tiles * self.slabs

    @property
    def capacity(self) -> int:
        """Blocks one wave of the card holds."""
        return self.sms * STATS_BLOCKS_PER_SM

    @property
    def waves(self) -> float:
        return self.blocks / self.capacity

    @property
    def fold_width(self) -> int:
        """Channels a thread of the last block loads at once (one float4
        where the tile and the partial rows allow)."""
        return 4 if self.tile % 4 == 0 and self.c % 4 == 0 else 1

    @property
    def slab_lanes(self) -> int:
        """Lanes over the slabs in the last block's fold."""
        return STATS_THREADS * self.fold_width // self.tile

    @property
    def workspace_floats(self) -> int:
        """The [2, slabs, C] partials, then the two [C] outputs."""
        return 2 * (self.slabs + 1) * self.c

    @property
    def workspace_bytes(self) -> int:
        return 4 * self.workspace_floats

    def slab_rows(self, slab: int) -> range:
        r0 = min(slab * self.rows_per_slab, self.m)
        return range(r0, min(r0 + self.rows_per_slab, self.m))

    def tile_channels(self, tile: int) -> range:
        return range(tile * self.tile, min((tile + 1) * self.tile, self.c))


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=1024)
def stats_plan(m: int, c: int, elem_bytes: int, operands: int = 1, align: int = 16,
               sms: int = STATS_SMS) -> StatsPlan:
    """Pack, tile, batch and slabs for `operands` [m, c] inputs of
    `elem_bytes` whose pointers are `align`-byte aligned.

    The pack is the widest load (up to 16 bytes) that divides C and the
    alignment. The tile covers STATS_SEGMENT bytes of a row (up to a warp
    of lanes, no wider than C needs): one whole line per row, and no more
    channels than that, since a wider tile needs more slabs to fill the
    card and so more partials to fold. The slabs fill one wave
    (`capacity // tiles`; fewer where M has too few rows for one batch of
    every row lane), with no slab empty."""
    if m <= 0 or c <= 0:
        raise ValueError(f"channel stats: empty [{m}, {c}]")
    if elem_bytes not in (2, 4):
        raise ValueError(f"channel stats: elements of 2 or 4 bytes, got {elem_bytes}")
    vec = 16 // elem_bytes
    while vec > 1 and (c % vec or align % (vec * elem_bytes)):
        vec //= 2
    lanes = min(STATS_MAX_LANES, STATS_SEGMENT // (vec * elem_bytes), _pow2_at_least(c // vec))
    tiles = -(-c // (lanes * vec))
    batch = STATS_LOADS // operands
    most = -(-m // ((STATS_THREADS // lanes) * batch))  # one batch per row lane
    slabs = min(max(1, sms * STATS_BLOCKS_PER_SM // tiles), most)
    slabs = -(-m // -(-m // slabs))  # no empty slab
    return StatsPlan(m, c, vec, lanes, batch, slabs, sms)


def check_plan(plan: StatsPlan, m: int, c: int, *tensors: torch.Tensor) -> None:
    """Raise unless `plan` covers [m, c] in packs the tensors can load."""
    elem = tensors[0].element_size()
    problems = []
    if (plan.m, plan.c) != (m, c):
        problems.append(f"it is for [{plan.m}, {plan.c}]")
    if plan.vec not in (1, 2, 4, 8) or plan.vec * elem > 16 or c % plan.vec:
        problems.append(f"a pack of {plan.vec} does not divide C = {c}")
    elif any(t.data_ptr() % (plan.vec * elem) for t in tensors):
        problems.append(f"a pointer is not aligned to {plan.vec * elem} bytes")
    if plan.lanes not in (1, 2, 4, 8, 16, 32):
        problems.append(f"{plan.lanes} lanes")
    if plan.batch * len(tensors) != STATS_LOADS:
        problems.append(f"a batch of {plan.batch} rows of {len(tensors)} operands")
    if not 1 <= plan.slabs <= 65535 or (plan.slabs - 1) * plan.rows_per_slab >= m:
        problems.append(f"{plan.slabs} slabs of {plan.rows_per_slab} rows")
    if problems:
        raise ValueError(f"channel stats plan refused for [{m}, {c}]: " + "; ".join(problems))


@functools.cache
def sm_count(index: int) -> int:
    """SMs of the card at CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


_TICKETS: dict[tuple[int, int], list[torch.Tensor]] = {}


def tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Zeroed int32 counters, at least `n`, of one (device, stream): each
    launch takes one per channel tile and leaves it at 0 again. Made once
    per stream; a larger set replaces a smaller one, which stays held (a
    captured graph may still use it)."""
    held = _TICKETS.setdefault((device.index, stream), [])
    if not held or held[-1].numel() < n:
        held.append(torch.zeros(max(n, 1024), dtype=torch.int32, device=device))
    return held[-1]


def _align(*tensors: torch.Tensor) -> int:
    ptr = 16
    for t in tensors:
        ptr |= t.data_ptr()
    return ptr & -ptr


def _launch(name: str, inputs: tuple[torch.Tensor, ...], plan: StatsPlan | None, call):
    """Plan (or check the given one), allocate the workspace and outputs in
    one tensor, launch through `call(lib, plan, ws, tickets, stream)` and
    return the two [C] outputs."""
    x = inputs[-1]
    m, c = x.shape
    if plan is None:
        plan = stats_plan(m, c, x.element_size(), len(inputs), _align(*inputs),
                          sm_count(x.device.index))
    else:
        check_plan(plan, m, c, *inputs)
    ws = torch.empty(plan.workspace_floats, dtype=torch.float32, device=x.device)
    stream = _build.stream_handle(x.device)
    err = call(_build.load_library(), plan, ws.data_ptr(),
               tickets(x.device, stream, plan.tiles).data_ptr(), stream)
    _build.check(err, name)
    return ws[2 * plan.slabs * c:].view(2, c).unbind(0)


def channel_sums(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum x, sum x^2) over the rows of `x` [M, C]; f32 [C] each."""
    check_rows(x, "x")
    if device_kind(x) == "cpu":
        return channel_sums_plain(x)
    out = _launch_sums(x)
    channel_sums.launches += 1
    return out


channel_sums.launches = 0


def _launch_sums(x: torch.Tensor, plan: StatsPlan | None = None):
    m, c = x.shape

    def call(lib, p, ws, tk, stream):
        return lib.moco_channel_sums(x.data_ptr(), DTYPE_CODES[x.dtype], m, c, p.vec, p.lanes,
                                     p.batch, p.slabs, p.rows_per_slab, ws, tk, stream)

    return _launch("channel_sums", (x,), plan, call)


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
    out = _launch_grad_sums(dy, x, mean, rstd)
    channel_grad_sums.launches += 1
    return out


channel_grad_sums.launches = 0


def _launch_grad_sums(dy, x, mean, rstd, plan: StatsPlan | None = None):
    m, c = x.shape

    def call(lib, p, ws, tk, stream):
        return lib.moco_channel_grad_sums(
            dy.data_ptr(), x.data_ptr(), DTYPE_CODES[x.dtype], mean.data_ptr(), rstd.data_ptr(),
            m, c, p.vec, p.lanes, p.batch, p.slabs, p.rows_per_slab, ws, tk, stream)

    return _launch("channel_grad_sums", (dy, x), plan, call)
