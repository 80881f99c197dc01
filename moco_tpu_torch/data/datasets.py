"""Synthetic in-memory data, the epoch shuffle, and host-to-device staging
(port of `SyntheticDataset` in `moco_tpu/data/datasets.py` and
`epoch_permutation` in `moco_tpu/data/loader.py`).

The host only holds uint8 images; all augmentation runs on the device.
"""

from __future__ import annotations

import numpy as np
import torch


class SyntheticDataset:
    """Deterministic clusterable fake images: each class is a fixed
    low-frequency pattern (a random 4x4 grid upsampled), each sample adds
    pixel noise. The same numpy draws as the JAX package's class, so both
    produce the same uint8 images for the same arguments."""

    def __init__(self, num_samples: int = 2048, image_size: int = 32,
                 num_classes: int = 10, seed: int = 0, noise: float = 0.15):
        rng = np.random.RandomState(seed)
        self.num_classes = num_classes
        self.image_size = image_size
        # prototypes from a FIXED seed: train/val instances share classes
        protos = np.random.RandomState(12345).rand(num_classes, 4, 4, 3)
        reps = image_size // 4
        protos = protos.repeat(reps, axis=1).repeat(reps, axis=2)
        labels = rng.randint(0, num_classes, size=num_samples)
        imgs = protos[labels] + noise * rng.randn(num_samples, image_size, image_size, 3)
        self.images = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
        self.labels = labels.astype(np.int32)

    def __len__(self) -> int:
        return len(self.images)

    def get_batch(self, indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(images [B, H, W, 3] uint8, labels [B] int32)."""
        return self.images[indices], self.labels[indices]


def epoch_permutation(n: int, epoch: int, seed: int, global_batch: int) -> np.ndarray:
    """Deterministic epoch shuffle, truncated to whole batches (drop_last)."""
    rng = np.random.RandomState((seed * 100003 + epoch) % (2**31))
    perm = rng.permutation(n)
    usable = (n // global_batch) * global_batch
    return perm[:usable]


def stage(images: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint8 host batch -> device tensor through pinned memory. The copy is
    asynchronous on a CUDA device; the caching host allocator keeps the
    pinned buffer alive until it completes."""
    host = torch.from_numpy(np.ascontiguousarray(images))
    if device.type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)
