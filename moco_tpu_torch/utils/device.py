"""The device an entry point runs on."""

from __future__ import annotations

import torch


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
