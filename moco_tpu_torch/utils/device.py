"""The device an entry point runs on, and the package's f32 precision policy."""

from __future__ import annotations

import torch


def set_precision_policy() -> None:
    """The port's f32 precision, set by every entry point before it builds
    anything: TF32 off for cuDNN's convolutions and for matmuls.

    Why off, when torch leaves `cudnn.allow_tf32` on by default:
    - the port is gated against the reference's exact f32 on the CPU, so an
      f32 preset (`cifar10-moco-v1`), the eval forward of the kNN monitor,
      kNN eval and the linear probe compute what the gate checked;
    - every number measured on the card so far was taken with TF32 off, so
      they describe what the entry points run;
    - the bf16 presets already run their convs and matmuls on the tensor
      cores, so this costs them nothing.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device: str | torch.device) -> torch.device:
    """The requested device; CUDA that is absent is an error, never a quiet
    fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass --device cpu to run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
