"""Device-memory and host-memory sampling (port of
`moco_tpu/telemetry/device.py`).

On a CUDA device `DeviceMonitor.sample()` reads the caching allocator's
statistics (`torch.cuda.memory_stats`) under the JAX package's schema names:

    hbm_bytes_in_use  <- allocated_bytes.all.current
    hbm_peak_bytes    <- allocated_bytes.all.peak  (= max_memory_allocated)
    hbm_bytes_limit   <- the device's total memory

These are the bytes live tensors hold, not the allocator's reserved cache
(`reserved_bytes.*`, which `nvidia-smi` sees): the same quantity as
PJRT's `bytes_in_use`. An error from the CUDA runtime is raised, never
swallowed. On the CPU the `hbm_*` keys are absent, as on the JAX package's
CPU backend: the absence means "cannot report", not zero.

Host RSS comes from /proc/self/statm (Linux; the current resident set),
with `resource.getrusage`'s ru_maxrss (the peak) as the fallback.
"""

from __future__ import annotations

import os
import resource
import sys

import torch

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096

# torch.cuda.memory_stats keys -> the schema's names
_HBM_KEYS = (
    ("allocated_bytes.all.current", "hbm_bytes_in_use"),
    ("allocated_bytes.all.peak", "hbm_peak_bytes"),
)


def host_rss_bytes() -> int:
    """Current resident set size (Linux /proc); elsewhere ru_maxrss, the
    PEAK, in the platform's unit (bytes on macOS, kilobytes elsewhere)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(rss if sys.platform == "darwin" else rss * 1024)


class DeviceMonitor:
    """Samples one device's allocator statistics and this host's RSS."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._limit = (torch.cuda.get_device_properties(self.device).total_memory
                       if self.device.type == "cuda" else None)

    def sample(self) -> dict:
        out = {"host_rss_bytes": host_rss_bytes()}
        if self.device.type == "cuda":
            # empty before the allocator's first allocation on the device
            stats = torch.cuda.memory_stats(self.device)
            for src, dst in _HBM_KEYS:
                out[dst] = int(stats[src]) if stats else 0
            out["hbm_bytes_limit"] = int(self._limit)
        return out
