"""Per-sample separable Gaussian blur: the CUDA kernel of `csrc/blur.cu`,
its plain PyTorch version, and the tap-weight sampler.

Port of `moco_tpu/ops/pallas_blur.py`. Each sample's taps carry both its
sigma and its apply/skip draw (a skipped sample gets one-hot identity
taps), so every sample goes through the same code. A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.
`gaussian_blur_batch.launches` counts kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from moco_tpu_torch.ops import _build
from moco_tpu_torch.ops.stats import DTYPE_CODES


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


def gaussian_blur_batch(images: torch.Tensor, weights: torch.Tensor,
                        radius: int) -> torch.Tensor:
    """Blur each NHWC sample with its own separable taps; f32 accumulation,
    output in the input dtype."""
    _check(images, weights, radius)
    if images.device.type == "cpu":
        return gaussian_blur_batch_plain(images, weights, radius)
    b, h, w, _ = images.shape
    lib = _build.load_library()
    if radius > lib.moco_blur_max_radius():
        raise ValueError(f"radius {radius} exceeds the kernel's shared-memory "
                         f"tile (max {lib.moco_blur_max_radius()})")
    out = torch.empty_like(images)
    err = lib.moco_gaussian_blur(
        images.data_ptr(), DTYPE_CODES[images.dtype], weights.data_ptr(),
        out.data_ptr(), b, h, w, radius, _build.stream_handle(images.device),
    )
    _build.check(err, "gaussian_blur_batch")
    gaussian_blur_batch.launches += 1
    return out


gaussian_blur_batch.launches = 0
