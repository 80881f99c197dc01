"""Per-sample separable Gaussian blur: the CUDA kernel of `csrc/blur.cu`,
its plain PyTorch version, and the tap-weight sampler.

Port of `moco_tpu/ops/pallas_blur.py`. Each sample's taps carry both its
sigma and its apply/skip draw (a skipped sample gets one-hot identity
taps), so every sample goes through the same code. A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.

On the card each call is one launch of `blur_rows` on a `BlurPlan`
(`blur_plan`): a block per sample, or per band of a sample's rows where
the batch alone would not fill a wave, walking its rows in chunks of
BLUR_RUN through a ring of row slots in shared memory.
`gaussian_blur_batch.launches` counts kernel launches and
`gaussian_blur_batch.routes` which instantiation ran: "fixed" (R = 11,
taps in registers) or "generic" (R given at run time).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from moco_tpu_torch.ops import _build
from moco_tpu_torch.ops.stats import DTYPE_CODES, sm_count

# csrc/blur.cu's geometry, on an H100 SXM
BLUR_RUN = 8                # rows of a chunk and of an H-pass thread; pixels of a W-pass thread
BLUR_BLOCKS_PER_SM = 2      # __launch_bounds__(256, 2): up to 128 registers a thread
BLUR_SMS = 132              # SMs of an H100 SXM; the wrapper passes the card's own count
BLUR_FIXED_RADIUS = 11      # blur_radius(224): the instantiation with taps in registers
BLUR_MAX_SMEM = 232448      # bytes of shared memory a block may use
BLUR_SM_SMEM = 233472       # shared memory of an SM; each resident block also reserves 1 KB


def blur_radius(out_size: int) -> int:
    """Fixed tap radius for a crop size (the JAX package's rule)."""
    return max(1, int(0.05 * out_size))


def blur_weights(
    batch: int, radius: int, sigma_range, prob: float,
    generator: torch.Generator, device=None,
) -> torch.Tensor:
    """[batch, 2R+1] f32 taps: a normalized Gaussian of sigma ~ U(sigma_range)
    with probability `prob`, else the one-hot identity."""
    sigma = torch.empty(batch, device=device).uniform_(
        sigma_range[0], sigma_range[1], generator=generator)
    apply = torch.rand(batch, device=device, generator=generator) < prob
    return blur_taps(sigma, apply, radius)


def blur_taps(sigma: torch.Tensor, apply: torch.Tensor, radius: int) -> torch.Tensor:
    """The taps for given per-sample sigmas and apply flags."""
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=sigma.device)
    kernel = torch.exp(-0.5 * (offs / sigma[:, None]) ** 2)
    kernel = kernel / kernel.sum(dim=1, keepdim=True)
    identity = torch.zeros_like(kernel)
    identity[:, radius] = 1.0
    return torch.where(apply[:, None], kernel, identity)


def gaussian_blur_batch_plain(images: torch.Tensor, weights: torch.Tensor,
                              radius: int) -> torch.Tensor:
    """Edge-padded separable blur as shifted adds in f32: the H pass over
    the padded width, then the W pass (the TPU kernel's order)."""
    b, h, w, _ = images.shape
    x = images.float().permute(0, 3, 1, 2)                      # [B, 3, H, W]
    x = F.pad(x, (radius, radius, radius, radius), mode="replicate")
    taps = weights.float()[:, None, None, None, :]              # [B, 1, 1, 1, T]
    acc = torch.zeros((b, 3, h, w + 2 * radius), dtype=torch.float32, device=x.device)
    for j in range(2 * radius + 1):
        acc = acc + taps[..., j] * x[:, :, j:j + h, :]
    out = torch.zeros((b, 3, h, w), dtype=torch.float32, device=x.device)
    for j in range(2 * radius + 1):
        out = out + taps[..., j] * acc[:, :, :, j:j + w]
    return out.permute(0, 2, 3, 1).to(images.dtype).contiguous()


def _check(images: torch.Tensor, weights: torch.Tensor, radius: int) -> None:
    if images.dim() != 4 or images.shape[-1] != 3 or images.numel() == 0:
        raise ValueError(f"images must be non-empty NHWC [B, H, W, 3], got {tuple(images.shape)}")
    if images.dtype not in DTYPE_CODES:
        raise TypeError(f"images must be float32 or bfloat16, got {images.dtype}")
    if not images.is_contiguous():
        raise ValueError("images must be contiguous NHWC")
    taps = 2 * radius + 1
    if radius < 0 or weights.shape != (images.shape[0], taps):
        raise ValueError(f"weights must be [B, 2R+1] = {(images.shape[0], taps)}, "
                         f"got {tuple(weights.shape)}")
    if weights.dtype != torch.float32 or weights.device != images.device:
        raise ValueError(f"weights must be float32 on {images.device}")
    if not weights.is_contiguous():
        raise ValueError("weights must be contiguous")
    if images.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {images.device}")


def skew(p: int) -> int:
    """Index of padded column p in a mid plane: a pad float after every 8."""
    return p + (p >> 3)


@dataclass(frozen=True)
class BlurPlan:
    """Launch plan of `blur_rows`.

    The grid is `b * bands` blocks of 256 threads; block `i` owns rows
    `band_rows(i % bands)` of sample `i // bands` and walks them in chunks
    of BLUR_RUN output rows. Its ring holds `slots` input rows of
    `slot_pitch` bytes (a row's 16-byte granules, whatever its offset), its
    mid buffer BLUR_RUN rows of 3 channel planes of `mid_pitch` floats (the
    padded row, skewed), twice: the H pass of one chunk fills one while
    the W pass of the chunk before reads the other. `packed` makes the W
    pass write 16-byte stores; `fixed` takes the R = 11 instantiation."""

    b: int
    h: int
    w: int
    radius: int
    elem: int
    bands: int
    rows_per_band: int
    packed: bool
    fixed: bool
    sms: int = BLUR_SMS

    @property
    def row_bytes(self) -> int:
        return self.w * 3 * self.elem

    @property
    def slots(self) -> int:
        """A chunk's window (BLUR_RUN + 2R rows) and the next chunk's new rows."""
        return 2 * BLUR_RUN + 2 * self.radius

    @property
    def slot_pitch(self) -> int:
        return -(-self.row_bytes // 16) * 16 + 16

    @property
    def mid_pitch(self) -> int:
        """Floats of a channel plane: the padded row and the overrun of the
        last W-pass run, skewed, rounded up to 3 * runs mod 32. A W-pass
        warp reads item L = t * runs + i at 3 * t * mid_pitch + 9 * i, which
        is then 9 * L mod 32: 32 items on 32 banks."""
        need = skew(self.w + 2 * self.radius + BLUR_RUN - 1) + 1
        return need + (3 * self.runs - need) % 32

    @property
    def smem_bytes(self) -> int:
        """The ring, two mid buffers, two row tables and the taps."""
        return self.slots * self.slot_pitch + 4 * (
            2 * BLUR_RUN * 3 * self.mid_pitch + 2 * (BLUR_RUN + 2 * self.radius)
            + (2 * self.radius + 1))

    @property
    def blocks_per_sm(self) -> int:
        return min(BLUR_BLOCKS_PER_SM, BLUR_SM_SMEM // (self.smem_bytes + 1024))

    @property
    def blocks(self) -> int:
        return self.b * self.bands

    @property
    def capacity(self) -> int:
        """Blocks one wave of the card holds."""
        return self.sms * self.blocks_per_sm

    @property
    def runs(self) -> int:
        """W-pass runs of a row."""
        return -(-self.w // BLUR_RUN)

    def band_rows(self, band: int) -> range:
        y0 = min(band * self.rows_per_band, self.h)
        return range(y0, min(y0 + self.rows_per_band, self.h))

    def chunks(self, band: int) -> list[int]:
        """First output row of each chunk of a band."""
        rows = self.band_rows(band)
        return list(range(rows.start, rows.stop, BLUR_RUN))


@functools.lru_cache(maxsize=1024)
def blur_plan(b: int, h: int, w: int, radius: int, elem_bytes: int, out_align: int = 16,
              sms: int = BLUR_SMS) -> BlurPlan:
    """Bands and stores for a [b, h, w, 3] batch of `elem_bytes` elements
    at `radius`, the output `out_align`-byte aligned.

    A sample is one block where the batch fills a wave (`capacity`); else
    each sample splits into as many bands of whole chunks as the wave has
    room for, each band reading its 2R halo rows again from L2. Raises
    ValueError where a row is too wide for the ring and the mid buffers at
    this radius."""
    if b <= 0 or h <= 0 or w <= 0 or radius < 0:
        raise ValueError(f"blur: empty batch or negative radius ({b}, {h}, {w}, R={radius})")
    if elem_bytes not in (2, 4):
        raise ValueError(f"blur: elements of 2 or 4 bytes, got {elem_bytes}")
    packed = out_align % 16 == 0 and w * 3 * elem_bytes % 16 == 0
    plan = BlurPlan(b, h, w, radius, elem_bytes, 1, h, packed, radius == BLUR_FIXED_RADIUS, sms)
    if plan.smem_bytes > BLUR_MAX_SMEM:
        raise ValueError(
            f"blur: a {w}-pixel row at radius {radius} needs {plan.smem_bytes} bytes of "
            f"shared memory (a ring of {plan.slots} rows and two mid buffers), over the "
            f"{BLUR_MAX_SMEM} a block may use")
    chunks = -(-h // BLUR_RUN)
    bands = min(max(1, plan.capacity // b), chunks)
    rows = -(-chunks // bands) * BLUR_RUN
    bands = -(-h // rows)
    if b * bands > 2**31 - 1:
        raise ValueError(f"blur: {b * bands} blocks, over the grid's 2^31 - 1")
    return BlurPlan(b, h, w, radius, elem_bytes, bands, rows, packed, plan.fixed, sms)


def check_plan(plan: BlurPlan, images: torch.Tensor, out: torch.Tensor, radius: int) -> None:
    """Raise unless `plan` covers this batch with what the kernel takes."""
    b, h, w, _ = images.shape
    problems = []
    if (plan.b, plan.h, plan.w, plan.radius, plan.elem) != (b, h, w, radius,
                                                            images.element_size()):
        problems.append(f"it is for [{plan.b}, {plan.h}, {plan.w}] R={plan.radius} "
                        f"elem {plan.elem}")
    if plan.bands < 1 or plan.rows_per_band < 1 or plan.bands * plan.rows_per_band < h \
            or (plan.bands - 1) * plan.rows_per_band >= h:
        problems.append(f"{plan.bands} bands of {plan.rows_per_band} rows")
    if plan.fixed and radius != BLUR_FIXED_RADIUS:
        problems.append(f"the R = {BLUR_FIXED_RADIUS} instantiation at R = {radius}")
    if plan.packed and (out.data_ptr() % 16 or plan.row_bytes % 16):
        problems.append("16-byte stores into rows that are not 16-byte aligned")
    if plan.smem_bytes > BLUR_MAX_SMEM:
        problems.append(f"{plan.smem_bytes} bytes of shared memory")
    if problems:
        raise ValueError(f"blur plan refused for {tuple(images.shape)}: " + "; ".join(problems))


def gaussian_blur_batch(images: torch.Tensor, weights: torch.Tensor,
                        radius: int) -> torch.Tensor:
    """Blur each NHWC sample with its own separable taps; f32 accumulation,
    output in the input dtype."""
    _check(images, weights, radius)
    if images.device.type == "cpu":
        return gaussian_blur_batch_plain(images, weights, radius)
    out = _launch_blur(images, weights, radius)
    gaussian_blur_batch.launches += 1
    return out


gaussian_blur_batch.launches = 0
gaussian_blur_batch.routes = {"fixed": 0, "generic": 0}


def _launch_blur(images: torch.Tensor, weights: torch.Tensor, radius: int,
                 plan: BlurPlan | None = None) -> torch.Tensor:
    """One launch of `blur_rows` on `plan` (the batch's own plan unless
    given, then checked); counts the instantiation in `.routes`."""
    b, h, w, _ = images.shape
    out = torch.empty_like(images)
    if plan is None:
        align = (out.data_ptr() | 16) & -(out.data_ptr() | 16)
        plan = blur_plan(b, h, w, radius, images.element_size(), align,
                         sm_count(images.device.index))
    else:
        check_plan(plan, images, out, radius)
    err = _build.load_library().moco_gaussian_blur(
        images.data_ptr(), DTYPE_CODES[images.dtype], weights.data_ptr(), out.data_ptr(),
        b, h, w, radius, int(plan.fixed), plan.bands, plan.rows_per_band,
        plan.slots, plan.slot_pitch, plan.mid_pitch, int(plan.packed),
        _build.stream_handle(images.device),
    )
    _build.check(err, "gaussian_blur_batch")
    gaussian_blur_batch.routes["fixed" if plan.fixed else "generic"] += 1
    return out
